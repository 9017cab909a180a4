"""The port's dry run (``repro_torch.launch.dryrun``) and what it stands on,
held to the JAX package on the CPU.

* ``launch.variants.apply_variant`` ``==`` the reference for every variant
  on the ten configs (the configs, the notes, the refusals);
* ``configs.input_specs``: the reference's keys, shapes and dtypes for every
  (arch, shape);
* the kernels under fake tensors: the flash forward and backward and the
  WKV forward (with and without the chunk-start states) and backward give
  the kernel's shapes and dtypes, count the kernel's own flops, and build,
  launch and run the plain version never;
* a product sharded 16 x 16 counts the global flops over 256 on a device;
* smoke cells (each config's smoke widths at the cell's real shape) on a
  fake (16, 16) group, a train and two decode cells (one MoE), and a
  prefill with frontend embeddings on (2, 16, 16):
  status ``ok``, each parameter's and input's local shape what JAX's
  ``NamedSharding`` gives for the same spec, ``model_flops`` ``==`` the
  reference's arithmetic, and ``benchmarks/roofline_report.py`` reads the
  JSONs.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as jax_get_arch
from repro.configs import input_specs as jax_input_specs
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.core.roofline import model_flops_lm as jax_model_flops_lm
from repro.launch import variants as jvariants
from repro_torch import _build
from repro_torch.configs import ARCH_IDS, get_arch, input_specs
from repro_torch.configs.base import SHAPES
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.wkv import kernel as wkv_kernel
from repro_torch.launch import dryrun
from repro_torch.launch import variants as tvariants
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.params import param_pspecs
from repro_torch.models.registry import blueprint
from repro_torch.train import sharding

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = sorted(jvariants.VARIANTS) + ["microbatch4", "microbatchx", "no_such_variant"]


def _apply(mod, arch, variant):
    try:
        cfg, note = mod.apply_variant(arch, variant)
    except ValueError as e:
        return ("ValueError", str(e))
    return (dataclasses.asdict(cfg), note)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_apply_variant_equals_the_reference(arch):
    for variant in VARIANTS:
        assert _apply(tvariants, get_arch(arch), variant) == _apply(jvariants, jax_get_arch(arch), variant), variant
    assert sorted(tvariants.VARIANTS) == sorted(jvariants.VARIANTS)


_DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    for name in SHAPES:
        got = input_specs(get_arch(arch), SHAPES[name])
        ref = jax_input_specs(jax_get_arch(arch), JAX_SHAPES[name])
        assert list(got) == list(ref)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), t.dtype) == (tuple(ref[k].shape), _DTYPES[jnp.dtype(ref[k].dtype)]), (name, k)


# --------------------------------------------------------------------------- #
# the kernels under fake tensors


@pytest.fixture
def no_kernel_and_no_plain(monkeypatch):
    """Building a kernel or running a plain version fails the test; returns
    the launch counters' reading."""

    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached a build or a plain version")

    monkeypatch.setattr(_build, "load", refuse)
    for mod, names in ((attn_kernel, ("mha_plain",)), (wkv_kernel, ("wkv_plain", "wkv_bwd_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    return lambda: (attn_kernel.flash_attention_cuda.launches, attn_kernel.flash_attention_bwd_cuda.launches,
                    wkv_kernel.wkv_cuda.launches, wkv_kernel.wkv_bwd_cuda.launches)


@pytest.mark.parametrize("dtype,bwd_per_pair", [(torch.bfloat16, 20), (torch.float32, 10)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_under_fake_tensors(no_kernel_and_no_plain, dtype, bwd_per_pair, causal):
    before = no_kernel_and_no_plain()
    b, hq, hkv, s, d = 2, 8, 2, 256, 128
    pairs = s * (s + 1) // 2 if causal else s * s
    with FakeTensorMode():
        q = torch.empty(b, hq, s, d, dtype=dtype)
        k = torch.empty(b, hkv, s, d, dtype=dtype)
        with FlopCounterMode(display=False) as fc:
            out = attn_kernel.flash_attention_cuda(q, k, k, causal=causal)
        assert (out.shape, out.dtype) == (q.shape, dtype)
        assert fc.get_total_flops() == 4 * d * pairs * b * hq
        q.requires_grad_(True)
        with FlopCounterMode(display=False) as fc:
            out = attn_kernel.flash_attention_cuda(q, k, k, causal=causal)
            (dq,) = torch.autograd.grad(out.float().sum(), [q])
        assert (dq.shape, dq.dtype) == (q.shape, dtype)
        counts = fc.get_flop_counts()["Global"]
        assert counts[torch.ops.repro_torch.flash_attention_fwd] == 4 * d * pairs * b * hq
        assert counts[torch.ops.repro_torch.flash_attention_bwd] == bwd_per_pair * d * pairs * b * hq
    assert no_kernel_and_no_plain() == before


@pytest.mark.parametrize("per_head", [False, True])
def test_wkv_kernels_under_fake_tensors(no_kernel_and_no_plain, per_head):
    before = no_kernel_and_no_plain()
    bh, s, kd, heads = 8, 64, 64, 4
    with FakeTensorMode():
        r = torch.empty(bh, s, kd)
        u = torch.empty(heads, kd) if per_head else torch.empty(kd)
        s0 = torch.empty(bh, kd, kd)
        with FlopCounterMode(display=False) as fc:
            out, state = wkv_kernel.wkv_cuda(r, r, r, r, u, chunk=16, s0=s0)
        assert (out.shape, state.shape) == ((bh, s, kd), (bh, kd, kd))
        assert fc.get_total_flops() == 6 * kd * kd * bh * s
        r = r.clone().requires_grad_(True)  # WKVFn: the forward writes the chunk-start states
        with FlopCounterMode(display=False) as fc:
            out, state = wkv_kernel.wkv_cuda(r, r, r, r, u, chunk=16)
            (dr,) = torch.autograd.grad(out.sum() + state.sum(), [r])
        assert dr.shape == r.shape and dr.dtype == torch.float32
        counts = fc.get_flop_counts()["Global"]
        assert counts[torch.ops.repro_torch.wkv_fwd] == 6 * kd * kd * bh * s
        assert counts[torch.ops.repro_torch.wkv_bwd] == 12 * kd * kd * bh * s
    assert no_kernel_and_no_plain() == before


def test_real_cpu_tensors_still_run_the_plain_versions():
    q = torch.randn(1, 2, 32, 16)
    before = attn_kernel.flash_attention_cuda.launches
    torch.testing.assert_close(attn_kernel.flash_attention_cuda(q, q, q, block_q=32, block_kv=32),
                               attn_kernel.mha_plain(q, q, q, True), rtol=0, atol=0)
    assert attn_kernel.flash_attention_cuda.launches == before


# --------------------------------------------------------------------------- #
# the fake process group


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def test_a_sharded_product_counts_its_devices_share(fake_group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    fake_group(256)
    mesh = make_production_mesh(device="cpu")
    counter = dryrun.TraceCounter()
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(256, 2048, dtype=torch.bfloat16), mesh, [Shard(0), Replicate()])
        b = distribute_tensor(torch.empty(2048, 8192, dtype=torch.bfloat16), mesh, [Replicate(), Shard(1)])
        with FlopCounterMode(display=False) as fc:
            a @ b
        with dryrun._outside_shape_inference(counter), counter:
            c = a @ b
            c.redistribute(mesh, [Replicate(), Replicate()])
    assert fc.get_total_flops() == 2 * 256 * 2048 * 8192  # the global op
    assert counter.flops == 2 * 256 * 2048 * 8192 // 256
    # each op's operands and result, 2 B an element: the local product, then
    # the gather over 'model' of its (16, 512) shards, the concatenation of
    # the 16 pieces into (16, 8192), the gather over 'data'
    assert counter.bytes == 2 * ((16 * 2048 + 2048 * 512 + 16 * 512) + (16 * 512 + 256 * 512)
                                 + 2 * 256 * 512 + (16 * 8192 + 256 * 8192))
    kinds = [(o.kind, o.group_size, o.result_bytes) for o in counter.collectives.ops]
    assert kinds == [("all-gather", 16, 256 * 512 * 2), ("all-gather", 16, 256 * 8192 * 2)]


# --------------------------------------------------------------------------- #
# smoke cells


def _shard_shape(shape, spec, sizes):
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    return tuple(NamedSharding(amesh, JP(*spec)).shard_shape(tuple(shape)))


CELLS = [("olmo-1b", "train_4k", "single"), ("qwen2.5-14b", "decode_32k", "single"),
         ("musicgen-large", "prefill_32k", "multi")]


@pytest.mark.parametrize("arch_id,shape_id,mesh_kind", CELLS)
def test_smoke_cell_local_shapes_are_jax_shard_shapes(fake_group, arch_id, shape_id, mesh_kind):
    multi = mesh_kind == "multi"
    sizes = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
    fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    cfg, shape = get_arch(arch_id).smoke(), SHAPES[shape_id]
    traced = dryrun.trace_cell(cfg, shape, mesh)
    rules = sharding.rules_for_mesh(sizes)
    specs = sharding.layer_specs(cfg, param_pspecs(blueprint(cfg), rules))
    for name, p in traced["params"].items():
        whole = tuple(p.shape)
        if name.startswith("blocks."):  # the stacked leaf's spec and shape, the layer axis first
            want = _shard_shape((cfg.n_layers,) + whole, (None,) + tuple(specs[name]), sizes)[1:]
        else:
            want = _shard_shape(whole, specs[name], sizes)
        assert tuple(p.to_local().shape) == want, name
    inputs = traced["args"][-1]  # the batch, or the decode's tokens
    bspecs = sharding.batch_pspecs(cfg, shape, sizes, rules)
    for k, t in (inputs.items() if isinstance(inputs, dict) else [("tokens", inputs)]):
        assert tuple(t.to_local().shape) == _shard_shape(tuple(t.shape), bspecs[k], sizes), k
    counter = traced["counter"]
    assert counter.flops > 0 and counter.bytes > 0 and counter.ops > 0
    assert counter.collectives.ops  # the fsdp gathers at least


def test_cells_write_the_reference_schema_and_the_report_reads_them(tmp_path, capsys):
    extra = [("dbrx-132b", "decode_32k", "single"), ("musicgen-large", "long_500k", "single")]
    for arch_id, shape_id, mesh_kind in CELLS + extra:
        res = dryrun.main(["--arch", arch_id, "--shape", shape_id, "--mesh", mesh_kind, "--smoke",
                           "--out", str(tmp_path)])
        assert not dist.is_initialized()  # the cell's fake group is gone
        path = tmp_path / mesh_kind / f"{arch_id}__{shape_id}__baseline.json"
        cell = json.loads(path.read_text())
        assert cell == json.loads(json.dumps(res))
        if shape_id == "long_500k":
            assert cell["status"] == "skipped" and "sub-quadratic" in cell["skip_reason"]
            continue
        assert cell["status"] == "ok", cell.get("traceback")
        cfg, jcfg, shape = get_arch(arch_id).smoke(), jax_get_arch(arch_id).smoke(), SHAPES[shape_id]
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        want = jax_model_flops_lm(jcfg.n_params(), tokens, training=shape.is_train,
                                  n_active_params=jcfg.n_active_params())
        assert cell["roofline"]["model_flops"] == want == cell["roofline_h100"]["model_flops"]
        assert cell["roofline"]["chips"] == (512 if mesh_kind == "multi" else 256)
        assert cell["seconds_compile"] is None and cell["memory_analysis"]["temp_size_in_bytes"] is None
        assert cell["cost_analysis_corrected"]["n_while"] == 0
        assert cell["roofline"]["hlo_flops_per_device"] == cell["cost_analysis_raw"]["flops"] > 0
        assert cell["collectives"]["total_wire_bytes_per_device"] == cell["roofline"]["collective_bytes_per_device"]
        assert cell["memory_analysis"]["argument_size_in_bytes"] > 0
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import roofline_report
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    cells = roofline_report.load_cells(str(tmp_path))
    assert sorted((c["arch"], c["shape"], c["status"]) for c in cells) == sorted(
        [(a, s, "ok") for a, s, _ in CELLS + extra[:1]] + [("musicgen-large", "long_500k", "skipped")])
    capsys.readouterr()
    sys.argv, argv = ["roofline_report.py", "--dir", str(tmp_path)], sys.argv
    try:
        roofline_report.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "| olmo-1b | train_4k |" in out and "| musicgen-large | prefill_32k |" in out


def test_a_cell_refuses_an_open_process_group(fake_group):
    fake_group(4)
    with pytest.raises(RuntimeError, match="already open"):
        dryrun.run_cell("olmo-1b", "train_4k", "single", "baseline", smoke=True)


def test_a_cell_leaves_no_fake_tensor_in_the_models_caches():
    """The RoPE frequencies are cached per (half, theta, device) for the
    process; a cell asks for them under its fake mode, and the real model
    after it must get real ones."""
    from torch._subclasses.fake_tensor import is_fake

    from repro_torch.models import build_model
    from repro_torch.models.layers import rope_freqs

    cfg = get_arch("olmo-1b").smoke()
    assert dryrun.run_cell("olmo-1b", "prefill_32k", "single", "baseline", smoke=True)["status"] == "ok"
    assert not is_fake(rope_freqs(cfg.hd // 2, cfg.rope_theta, torch.device("cpu")))
    logits, _ = build_model(cfg, device="cpu")(torch.zeros((1, 32), dtype=torch.int64))
    assert not is_fake(logits) and torch.isfinite(logits).all()
