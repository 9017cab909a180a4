"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell's
step on a fake process group, with fake tensors, and price it.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
with XLA on 512 host devices.  The port has no compiler to ask, so for each
cell this script:

  1. starts a ``"fake"`` process group (``FakeStore``) of world 256 or 512
     and builds the production mesh ((16, 16) single-pod or (2, 16, 16)
     multi-pod) over it; the group is destroyed when the cell ends,
  2. builds the model under ``FakeTensorMode`` (no parameter is drawn: a
     fake tensor holds a shape, a dtype and a device, no storage) with the
     step bundle of its shape (``make_train_step`` for train shapes,
     ``make_prefill_step`` for prefill, ``make_decode_step`` with a cache of
     length S for decode), which lays the parameters out on the mesh by the
     port's specs (``place_model``, ``to_placements``); the optimizer state
     (AdamW, Adafactor for MoE), the batch and the cache are placed by the
     bundle's spec trees before the trace,
  3. calls the bundle once under a dispatch mode that sees each device's
     local shards: per-device FLOPs (``torch.utils.flop_counter``'s
     formulas, which include the flash and WKV kernels' own:
     ``kernels/attention/kernel.py``, ``kernels/wkv/kernel.py``), bytes
     accessed (every op's operand and result bytes, XLA's definition; views
     and allocations move none), and every functional collective with its
     result bytes and group size, priced by the ring model of
     ``core.hlo_analysis``,
  4. records the reference's schema into
     ``<out>/<mesh>/<arch>__<shape>__<variant>.json``, with the roofline of
     ``core.roofline.build_report`` on ``TPU_V5E`` (as the JAX package
     prices its cells) and, as ``roofline_h100``, on the port-side H100
     machine (``core.gpu_roofline``).

The fake tensors live on the CPU device whatever the host: the trace
counts from shapes alone, and a CPU-only build of PyTorch aborts in
autograd on a fake CUDA tensor.  The kernels' wrappers send any fake tensor
to the kernel's path, so a trace never runs their plain versions and never
builds or launches a kernel.

What an eager trace cannot fill is stated in each cell's ``notes``: no
compile (``seconds_compile`` null), no loops to multiply (``n_while`` 0),
no buffer assignment (``temp_size_in_bytes`` null), and no schedule of the
collectives (each is priced alone, by its group size).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--variant baseline]
(--all spawns one subprocess per cell, each with its own process group.)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import inspect
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor, placement_types
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import input_specs
from ..core.hlo_analysis import CollectiveOp, CollectiveStats, _wire_bytes
from ..models.registry import build_model
from ..optim.optimizers import make_optimizer
from ..train.sharding import place_tree
from ..train.step import make_decode_step, make_prefill_step, make_train_step

CELL_TIMEOUT_S = 2400
DEFAULT_OUT = "results/dryrun_torch"

NOTES = (
    "torch port: eager trace on a fake process group under FakeTensorMode, counts on each "
    "device's local shards; seconds_lower is the trace's seconds, seconds_compile null (no "
    "compiler); n_while 0 and loop_multipliers {} (an eager trace has no loops); "
    "temp_size_in_bytes null (no buffer assignment); collectives from the functional "
    "collectives the trace issued, wire bytes by the ring model, no schedule or overlap; "
    "arguments and outputs: the local shards of the step's inputs and of what it returns "
    "or updates in place"
)

# functional collectives (torch.ops._c10d_functional) -> the HLO kind whose
# ring factor prices them (core.hlo_analysis._wire_bytes)
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}
# ops that move no bytes: allocations, aliases, metadata, the wait on a collective
NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach", "alias",
              "lift_fresh", "wait_tensor", "device"}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local_bytes(*trees) -> int:
    """Bytes of the distinct tensors in ``trees`` (dicts, lists, tuples and
    the caches' dataclasses), each DTensor by its local shard: one device's
    share."""
    seen: dict[int, int] = {}

    def walk(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            seen[id(x)] = _nbytes(x.to_local() if isinstance(x, DTensor) else x)

    for tree in trees:
        walk(tree)
    return sum(seen.values())


class TraceCounter(TorchDispatchMode):
    """Counts, on each device's local tensors, the FLOPs, the bytes
    accessed and the collectives of what runs under it: a DTensor op goes
    on to DTensor, whose local ops and collectives then come back through
    this mode on one device's shards."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = CollectiveStats()
        self.paused = 0  # > 0 inside DTensor's own bookkeeping (see _outside_shape_inference)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional") and name != "wait_tensor":
            group = [a for a in list(args) + list(kwargs.values()) if isinstance(a, str)]
            n = _resolve_process_group(group[-1]).size() if group else 1
            kind = COLLECTIVE_KINDS.get(name, name)
            rb = float(sum(_nbytes(t) for t in _tensors(out)))
            self.collectives.ops.append(CollectiveOp(kind=kind, result_bytes=rb, group_size=n,
                                                     wire_bytes=_wire_bytes(kind, rb, n)))
        if not (func.is_view or name in NO_TRAFFIC):
            seen = {id(t): _nbytes(t) for t in _tensors((args, kwargs))}
            seen.update({id(t): _nbytes(t) for t in _tensors(out) if id(t) not in seen})
            self.bytes += sum(seen.values())
            if func._schema.is_mutable:  # an in-place op writes the operand it read
                self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


@contextlib.contextmanager
def _outside_shape_inference(counter: TraceCounter):
    """Pauses ``counter`` where DTensor works on no device's tensors: while
    it infers an op's output shape (it runs the op once on fake tensors of
    the global shapes) and while it computes the indices of a strided
    shard.  It does the latter with real ``arange`` tensors of a dim's whole
    length, whose ``tolist`` would be data-dependent under the trace's fake
    mode; the result depends on its arguments alone, so it is computed once
    a trace for each."""
    hooks = [(ShardingPropagator, "_propagate_tensor_meta_non_cached", False)]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and hasattr(strided, "local_shard_size_and_offset"):
        hooks.append((strided, "local_shard_size_and_offset", True))
    saved = []
    for owner, name, real in hooks:
        raw = inspect.getattr_static(owner, name)
        inner = raw.__func__ if isinstance(raw, staticmethod) else raw
        memo: dict = {}

        def paused(*args, _inner=inner, _real=real, _memo=memo, **kwargs):
            counter.paused += 1
            try:
                if not _real:
                    return _inner(*args, **kwargs)
                key = (args, tuple(sorted(kwargs.items())))
                if key not in _memo:
                    with unset_fake_temporarily():
                        _memo[key] = _inner(*args, **kwargs)
                size, offsets = _memo[key]
                return size, list(offsets) if isinstance(offsets, list) else offsets
            finally:
                counter.paused -= 1

        functools.update_wrapper(paused, inner)
        setattr(owner, name, staticmethod(paused) if isinstance(raw, staticmethod) else paused)
        saved.append((owner, name, raw))
    try:
        yield
    finally:
        for owner, name, raw in saved:
            setattr(owner, name, raw)


def trace_cell(arch, shape, mesh) -> dict:
    """Builds ``arch``'s model on ``mesh`` under ``FakeTensorMode`` and runs
    its step bundle for ``shape`` once under a :class:`TraceCounter`.  The optimizer state, the batch and the cache are placed by the
    bundle's spec trees first, so that the trace holds none of the
    placement.  Returns the counter, the trace's seconds, the local bytes of
    the step's arguments and outputs, and the placed parameters and
    arguments."""
    counter = TraceCounter()
    device = mesh.device_type
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = build_model(arch, device=device)
        specs = {k: torch.empty(t.shape, dtype=t.dtype, device=device) for k, t in input_specs(arch, shape).items()}
        if shape.is_train:
            optimizer = make_optimizer("adafactor" if arch.moe is not None else "adamw")
            bundle = make_train_step(model, optimizer, mesh, shape)
            params = dict(model.named_parameters())
            args = (place_tree(optimizer.init(params), bundle.in_pspecs[0], mesh),
                    place_tree(specs, bundle.in_pspecs[1], mesh))
        elif shape.kind == "prefill":
            bundle = make_prefill_step(model, mesh, shape)
            params = dict(model.named_parameters())
            args = (place_tree({k: v for k, v in specs.items() if k != "labels"}, bundle.in_pspecs[0], mesh),)
        else:  # decode: one new token against a cache of length S
            bundle = make_decode_step(model, mesh, shape)
            params = dict(model.named_parameters())
            cache = model.init_cache(shape.global_batch, shape.seq_len)
            args = (place_tree(cache, bundle.in_pspecs[0], mesh), place_tree(specs["tokens"], bundle.in_pspecs[1], mesh))
        arg_bytes = _local_bytes(params, args)
        t0 = time.perf_counter()
        with _outside_shape_inference(counter), counter:
            out = bundle(*args)
        seconds = time.perf_counter() - t0
        # the train step updates the parameters and the optimizer state in
        # place, where the JAX step returns them (donated)
        out_bytes = _local_bytes(out, params, args[0]) if shape.is_train else _local_bytes(out)
    return {"counter": counter, "seconds": seconds, "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "params": params, "args": args, "out": out}


def _trace_on_fake_group(arch, shape, world: int, make_mesh) -> dict:
    """:func:`trace_cell` on a fake process group of ``world`` ranks that
    is opened here and destroyed after, whatever happens: no fake group is
    left behind for a real one to meet."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already open: the dry run starts a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        return trace_cell(arch, shape, make_mesh())
    finally:
        dist.destroy_process_group()


def _priced(arch, shape, traced: dict, cell: str, mesh_spec, notes: str, machines: dict) -> dict:
    """The cost, the collectives and a roofline report on each of
    ``machines`` (key -> machine) of a traced step."""
    from ..core.roofline import build_report, model_flops_lm

    counter = traced["counter"]
    coll = counter.collectives
    cost = {"flops": float(counter.flops), "bytes accessed": float(counter.bytes), "transcendentals": 0.0}
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = model_flops_lm(
        arch.n_params(),
        tokens,
        training=shape.is_train,
        n_active_params=arch.n_active_params(),
    )
    out = {
        "seconds_lower": round(traced["seconds"], 2),
        "seconds_compile": None,
        "memory_analysis": {
            "argument_size_in_bytes": traced["argument_bytes"],
            "output_size_in_bytes": traced["output_bytes"],
            "temp_size_in_bytes": None,
        },
        "cost_analysis_raw": {k: cost[k] for k in sorted(cost)},
        "cost_analysis_corrected": dict(cost, n_while=0, loop_multipliers={}),
        "collectives": {
            "counts": coll.counts(),
            "wire_bytes_by_kind": coll.by_kind(),
            "wire_bytes_by_group_size": {
                str(k): v for k, v in coll.wire_bytes_by_group_size().items()
            },
            "total_wire_bytes_per_device": coll.total_wire_bytes,
        },
    }
    for key, machine in machines.items():
        out[key] = build_report(cell=cell, mesh=mesh_spec, cost=cost, collectives=coll, model_flops=mf,
                                dtype_bits=16, machine=machine, notes=notes).to_dict()
    return out


def run_cell(arch_id: str, shape_id: str, mesh_kind: str, variant: str, out_dir: str = DEFAULT_OUT,
             smoke: bool = False) -> dict:
    """One cell in this process, on a fake process group of its own: the
    reference's JSON as a dict.  ``smoke`` traces the arch's smoke config
    (two layers, narrow widths) at the cell's shape."""
    from ..configs import get_arch
    from ..configs.base import SHAPES, shape_applicable
    from ..core.gpu_roofline import H100_ROOFLINE
    from ..core.machine import MULTI_POD_MESH, SINGLE_POD_MESH, TPU_V5E
    from .mesh import make_production_mesh
    from .variants import apply_variant

    arch = get_arch(arch_id)
    shape = SHAPES[shape_id]
    ok, why = shape_applicable(arch, shape)
    result = {
        "arch": arch_id,
        "shape": shape_id,
        "mesh": mesh_kind,
        "variant": variant,
        "status": "skipped" if not ok else "pending",
        "skip_reason": why,
    }
    if not ok:
        return result

    multi = mesh_kind == "multi"
    mesh_spec = MULTI_POD_MESH if multi else SINGLE_POD_MESH
    arch, variant_notes = apply_variant(arch.smoke() if smoke else arch, variant)
    traced = _trace_on_fake_group(arch, shape, mesh_spec.n_devices,
                                  lambda: make_production_mesh(multi_pod=multi, device="cpu"))
    result.update(status="ok")
    result.update(_priced(arch, shape, traced, f"{arch_id}/{shape_id}/{mesh_kind}", mesh_spec, variant_notes,
                          {"roofline": TPU_V5E, "roofline_h100": H100_ROOFLINE}))
    result.update(smoke=smoke, traced_ops=traced["counter"].ops, notes=NOTES)
    return result


def price_one_card(arch, shape) -> dict:
    """``arch``'s step for ``shape`` traced on a world-1 fake group through
    a (1, 1) mesh, every parameter and input whole on the one device, and
    priced on the port-side H100 machine: the fields of a cell with its
    ``roofline``."""
    from ..core.gpu_roofline import H100_ROOFLINE
    from ..core.machine import SINGLE_DEVICE_MESH
    from .mesh import make_test_mesh

    traced = _trace_on_fake_group(arch, shape, 1, lambda: make_test_mesh(1, 1, device="cpu"))
    return {"arch": arch.name, "shape": shape.name, "mesh": "one_card", "status": "ok",
            **_priced(arch, shape, traced, f"{arch.name}/{shape.name}/one_card", SINGLE_DEVICE_MESH, "",
                      {"roofline": H100_ROOFLINE}),
            "traced_ops": traced["counter"].ops, "notes": NOTES}


def cell_path(out_dir: str, mesh_kind: str, arch_id: str, shape_id: str, variant: str) -> str:
    return os.path.join(out_dir, mesh_kind, f"{arch_id}__{shape_id}__{variant}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="trace each arch's smoke config (two layers, narrow widths) at the cell's shape")
    args = ap.parse_args(argv)

    if args.all:
        from ..configs import ARCH_IDS
        from ..configs.base import SHAPES

        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        for mesh_kind in meshes:
            for arch_id in ARCH_IDS:
                for shape_id in SHAPES:
                    out_path = cell_path(args.out, mesh_kind, arch_id, shape_id, args.variant)
                    if os.path.exists(out_path) and not args.force:
                        print(f"skip (exists) {out_path}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch_id,
                           "--shape", shape_id, "--mesh", mesh_kind, "--variant", args.variant,
                           "--out", args.out] + (["--smoke"] if args.smoke else [])
                    print(f"=== {mesh_kind}/{arch_id}/{shape_id} ===", flush=True)
                    try:
                        subprocess.run(cmd, check=False, timeout=CELL_TIMEOUT_S)
                    except subprocess.TimeoutExpired:
                        os.makedirs(os.path.dirname(out_path), exist_ok=True)
                        with open(out_path, "w") as f:
                            json.dump({"arch": arch_id, "shape": shape_id, "mesh": mesh_kind,
                                       "variant": args.variant, "status": "timeout"}, f, indent=2)
        return

    if not (args.arch and args.shape and args.mesh in ("single", "multi")):
        ap.error("give --arch, --shape and --mesh single|multi, or --all")
    out_path = cell_path(args.out, args.mesh, args.arch, args.shape, args.variant)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    try:
        result = run_cell(args.arch, args.shape, args.mesh, args.variant, args.out, smoke=args.smoke)
    except Exception as e:  # record the failure: it is a bug to fix
        result = {
            "arch": args.arch,
            "shape": args.shape,
            "mesh": args.mesh,
            "variant": args.variant,
            "status": "error",
            "error": repr(e),
            "traceback": traceback.format_exc(),
        }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    status = result["status"]
    print(f"[{status}] {args.arch}/{args.shape}/{args.mesh} -> {out_path}")
    if status == "ok":
        for key in ("roofline", "roofline_h100"):
            r = result[key]
            print(
                f"  {key}: compute={r['t_compute_s']:.4e}s memory={r['t_memory_s']:.4e}s "
                f"collective={r['t_collective_s']:.4e}s dominant={r['dominant']} "
                f"roofline_frac={r['roofline_fraction']:.3f}"
            )
    elif status == "error":
        print(result["traceback"][-2000:])
    return result


if __name__ == "__main__":
    main()
