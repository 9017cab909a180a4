"""Trace one model step into a :class:`~repro_torch.graph.dag.KernelDAG`:
a copy of ``repro.graph.frontend``.

The tracer walks a model's config shapes — never its model code — and emits
the SPMD kernel stream of one step: per-layer matmuls, elementwise streams and
the family mixer as compute nodes, plus the collectives the sharding implies
(fsdp weight all-gathers, tp output all-reduces, fsdp gradient
reduce-scatters).  Sharding follows the JAX package's `train/sharding.py`:
logical axes translate through
:class:`~repro_torch.models.params.ShardingRules` (pod-aware, the same rule
table as its ``rules_for_mesh``) and a dim shards only when the mapped axis
product divides it (the ``shardctx.axes_size`` contract).

Stream model:

* compute nodes chain serially in program order (one compute lane per device);
* fsdp weight all-gathers chain on the *comm* lane and each layer's first
  kernel depends on its gather — so layer ``l+1``'s gather overlaps layer
  ``l``'s compute exactly like FSDP prefetch, and the replayer's overlap
  fraction measures how much of it hides;
* ``kind="train"`` replays the recorded forward ops backward (dgrad + wgrad
  per matmul, doubled mixers, widened elementwise streams), emits one
  gradient reduce-scatter per layer as its backward completes, and closes
  with the optimizer update stream.
"""
from __future__ import annotations

from typing import Any

from ..configs import get_arch
from ..configs.base import ArchConfig
from ..core.hlo_analysis import collective_wire_bytes
from ..core.machine import MeshSpec
from ..launch.mesh import mesh_spec
from ..models.params import ShardingRules
from ..models.shardctx import axes_size
from .dag import KernelDAG
from .kernels import (
    DTYPE_BITS,
    attention_mixer_ir,
    elementwise_ir,
    matmul_ir,
    scan_mixer_ir,
    wkv_mixer_ir,
)

BYTES = DTYPE_BITS // 8
STEP_KINDS = ("forward", "train")


def rules_for_spec(mesh: MeshSpec) -> ShardingRules:
    """Same rule table as the JAX package's ``train.sharding.rules_for_mesh``."""
    names = tuple(a for a, _ in mesh.axes)
    if "pod" in names:
        return ShardingRules(fsdp=("pod", "data"), tp="model", dp=("pod", "data"))
    return ShardingRules(fsdp=("data",), tp="model", dp=("data",))


def _resolve_cfg(model) -> ArchConfig:
    if isinstance(model, str):
        return get_arch(model)
    if isinstance(model, ArchConfig):
        return model
    cfg = getattr(model, "cfg", None)
    if isinstance(cfg, ArchConfig):
        return cfg
    raise TypeError(f"cannot resolve an ArchConfig from {model!r}")


class _Tracer:
    """Accumulates one step's kernel stream into a KernelDAG."""

    def __init__(
        self, cfg: ArchConfig, mesh: MeshSpec, *, batch: int, seq: int,
        backend: str, kind: str,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.backend = backend
        self.kind = kind
        self.sizes = dict(mesh.axes)
        self.rules = rules_for_spec(mesh)
        self.dag = KernelDAG(
            mesh=mesh,
            meta={
                "arch": cfg.name, "family": cfg.family, "backend": backend,
                "kind": kind, "batch": batch, "seq": seq,
            },
        )
        self.seq = seq
        dp = self.shard(batch, self.rules.dp)
        self.b_loc = batch // dp
        self.m = self.b_loc * seq  # local tokens per device
        self._n = 0  # id sequence
        self._last: str | None = None  # tail of the compute stream
        self._last_comm: str | None = None  # tail of the comm (gather) stream
        self._pending: list[str] = []  # extra deps for the next compute node
        self._ops: list[tuple] = []  # forward record for the backward replay
        self._layer_w = 0  # local param count of the layer being traced

    # ---- sharding ---------------------------------------------------------- #

    def shard(self, dim: int, axes) -> int:
        """Shard factor for ``dim`` over logical ``axes`` (1 unless divisible)."""
        n = axes_size(axes, self.sizes)
        return n if (n > 1 and dim % n == 0) else 1

    @property
    def tp(self):
        return self.rules.tp

    # ---- node emission ----------------------------------------------------- #

    def _id(self, name: str) -> str:
        self._n += 1
        return f"{self._n:04d}.{name}"

    def _emit(self, name: str, ir, repeat: int, **meta) -> str:
        deps = ([self._last] if self._last else []) + self._pending
        self._pending = []
        nid = self._id(name)
        self.dag.compute(nid, ir, deps=deps, repeat=repeat, **meta)
        self._last = nid
        return nid

    def mm(self, name: str, m: int, n: int, k: int, *, w_count: int | None = None):
        """Matmul node; its weight (k x n, tp-local) joins the layer gather."""
        ir, rep = matmul_ir(m, n, k, backend=self.backend)
        self._emit(name, ir, rep, op="matmul", dims=(m, n, k))
        self._layer_w += k * n if w_count is None else w_count
        self._ops.append(("mm", name, m, n, k))

    def ew(self, name: str, nelem: int, *, reads=1, writes=1, flops=4.0):
        ir, rep = elementwise_ir(
            nelem, backend=self.backend, reads=reads, writes=writes,
            flops_per_elem=flops,
        )
        self._emit(name, ir, rep, op="elementwise")
        self._ops.append(("ew", name, nelem, reads, writes, flops))

    def mixer(self, name: str, ir, repeat: int):
        self._emit(name, ir, repeat, op="mixer")
        self._ops.append(("mixer", name, ir, repeat))

    def coll(self, name: str, kind: str, count: float, axes, *, stream: str) -> None:
        """Emit one collective per participating mesh axis (hierarchical ring).

        ``count`` is the fp32 element count of the result buffer (all-reduce /
        all-gather) or of the local shard (reduce-scatter).  Streams:
        ``"comm"`` chains on the gather lane and gates the next compute node
        (FSDP weight prefetch); ``"inline"`` chains on the compute stream (tp
        all-reduces block their consumer anyway); ``"rs"`` depends on the
        compute tail and chains on the comm lane WITHOUT gating compute —
        gradient reduce-scatters drain behind the backward, and only the
        optimizer joins on them.
        """
        if axes is None:
            return
        if isinstance(axes, str):
            axes = (axes,)
        for ax in axes:
            n = self.sizes.get(ax, 1)
            if n <= 1:
                continue
            nid = self._id(name if len(axes) == 1 else f"{name}.{ax}")
            if stream == "comm":
                deps = [self._last_comm] if self._last_comm else []
                self.dag.collective(nid, kind, count * BYTES, ax, deps=deps)
                self._last_comm = nid
                self._pending.append(nid)
            elif stream == "rs":
                deps = [d for d in (self._last_comm, self._last) if d]
                self.dag.collective(nid, kind, count * BYTES, ax, deps=deps)
                self._last_comm = nid
            else:
                deps = [self._last] if self._last else []
                self.dag.collective(nid, kind, count * BYTES, ax, deps=deps)
                self._last = nid
                self._ops.append(("coll", name, kind, count, ax))

    def gather_layer(self, name: str) -> None:
        """fsdp all-gather of the layer's tp-local params, FSDP-prefetch style."""
        w = self._layer_w
        self._ops.append(("layer_params", w))  # backward replay reads this
        if w and self.shard(w, self.rules.fsdp) > 1:
            self.coll(name, "all-gather", w, self.rules.fsdp, stream="comm")
        self._layer_w = 0

    def layer_start(self) -> None:
        self._ops.append(("layer_start",))
        self._layer_w = 0

    # ---- per-family forward layers ----------------------------------------- #

    def emit_embed(self):
        cfg, m = self.cfg, self.m
        self.ew("embed", m * cfg.d_model, reads=1, writes=1, flops=1.0)

    def emit_ssm_layer(self, li: int):
        cfg, m, d = self.cfg, self.m, self.cfg.d_model
        tpn = self.shard(d, self.tp)
        H = d // cfg.rwkv_head_dim
        h_loc = H // self.shard(H, self.tp)
        self.layer_start()
        self.ew(f"L{li}.norm1", m * d)
        self.ew(f"L{li}.shift", m * d, reads=2, writes=1, flops=6.0)
        for w in ("wr", "wk", "wv", "wg"):
            self.mm(f"L{li}.{w}", m, d // tpn, d)
        self.mm(f"L{li}.lora_a", m, 64, d)
        self.mm(f"L{li}.lora_b", m, d // tpn, 64)
        ir, rep = wkv_mixer_ir(
            BH=self.b_loc * h_loc, S=self.seq, K=cfg.rwkv_head_dim,
            backend=self.backend,
        )
        self.mixer(f"L{li}.wkv", ir, rep)
        self.mm(f"L{li}.wo", m, d, d // tpn)
        self.coll(f"L{li}.ar_tm", "all-reduce", m * d, self.tp, stream="inline")
        self.ew(f"L{li}.resid1", m * d, reads=2, writes=1, flops=1.0)
        self.ew(f"L{li}.norm2", m * d)
        ff_loc = cfg.d_ff // self.shard(cfg.d_ff, self.tp)
        self.mm(f"L{li}.w_in", m, ff_loc, d)
        self.ew(f"L{li}.act", m * ff_loc, reads=2, writes=1, flops=6.0)
        self.mm(f"L{li}.w_out", m, d, ff_loc)
        self.coll(f"L{li}.ar_cm", "all-reduce", m * d, self.tp, stream="inline")
        self.ew(f"L{li}.resid2", m * d, reads=2, writes=1, flops=1.0)
        self.gather_layer(f"L{li + 1}.ag_w")

    def _emit_attn(self, tag: str):
        cfg, m, d = self.cfg, self.m, self.cfg.d_model
        hd = cfg.head_dim or d // cfg.n_heads
        h_loc = cfg.n_heads // self.shard(cfg.n_heads, self.tp)
        kv_loc = cfg.n_kv_heads // self.shard(cfg.n_kv_heads, self.tp)
        self.ew(f"{tag}.norm1", m * d)
        self.mm(f"{tag}.wq", m, h_loc * hd, d)
        self.mm(f"{tag}.wk", m, kv_loc * hd, d)
        self.mm(f"{tag}.wv", m, kv_loc * hd, d)
        ir, rep = attention_mixer_ir(
            batch=self.b_loc, heads=h_loc, S=self.seq, hd=hd,
            backend=self.backend,
        )
        self.mixer(f"{tag}.attn", ir, rep)
        self.mm(f"{tag}.wo", m, d, h_loc * hd)
        self.coll(f"{tag}.ar_attn", "all-reduce", m * d, self.tp, stream="inline")
        self.ew(f"{tag}.resid1", m * d, reads=2, writes=1, flops=1.0)

    def _emit_mlp(self, tag: str):
        cfg, m, d = self.cfg, self.m, self.cfg.d_model
        ff_loc = cfg.d_ff // self.shard(cfg.d_ff, self.tp)
        self.ew(f"{tag}.norm2", m * d)
        if cfg.mlp == "swiglu":
            self.mm(f"{tag}.w_gate", m, ff_loc, d)
            self.mm(f"{tag}.w_up", m, ff_loc, d)
            self.ew(f"{tag}.glu", m * ff_loc, reads=2, writes=1, flops=8.0)
        else:
            self.mm(f"{tag}.w_up", m, ff_loc, d)
            self.ew(f"{tag}.gelu", m * ff_loc, reads=1, writes=1, flops=10.0)
        self.mm(f"{tag}.w_down", m, d, ff_loc)
        self.coll(f"{tag}.ar_mlp", "all-reduce", m * d, self.tp, stream="inline")
        self.ew(f"{tag}.resid2", m * d, reads=2, writes=1, flops=1.0)

    def emit_dense_layer(self, li: int):
        self.layer_start()
        tag = f"L{li}"
        self._emit_attn(tag)
        cfg, m, d = self.cfg, self.m, self.cfg.d_model
        if cfg.moe is not None:
            E, k = cfg.moe.n_experts, cfg.moe.top_k
            ff_loc = cfg.d_ff // self.shard(cfg.d_ff, self.tp)
            self.ew(f"{tag}.norm2", m * d)
            self.mm(f"{tag}.router", m, E, d)
            self.ew(f"{tag}.dispatch", m * E, reads=1, writes=1, flops=8.0)
            # grouped expert matmuls: top_k expert passes per token, E resident
            # expert weight sets (w_count scales the fsdp gather volume)
            n_mm = 3 if cfg.mlp == "swiglu" else 2
            self.mm(f"{tag}.e_gate", m * k, ff_loc, d, w_count=E * d * ff_loc)
            if n_mm == 3:
                self.mm(f"{tag}.e_up", m * k, ff_loc, d, w_count=E * d * ff_loc)
                self.ew(f"{tag}.e_glu", m * k * ff_loc, reads=2, writes=1, flops=8.0)
            else:
                self.ew(f"{tag}.e_act", m * k * ff_loc, reads=1, writes=1, flops=10.0)
            self.mm(f"{tag}.e_down", m * k, d, ff_loc, w_count=E * ff_loc * d)
            self.coll(f"{tag}.ar_moe", "all-reduce", m * d, self.tp, stream="inline")
            self.ew(f"{tag}.resid2", m * d, reads=2, writes=1, flops=1.0)
        else:
            self._emit_mlp(tag)
        self.gather_layer(f"L{li + 1}.ag_w")

    def emit_hybrid_layer(self, li: int):
        cfg, m, d = self.cfg, self.m, self.cfg.d_model
        self.layer_start()
        tag = f"L{li}"
        d_in = 2 * d
        N, P = cfg.ssm_state, cfg.ssm_head_dim
        H = d_in // P
        zdim = 2 * d_in + 2 * N + H
        conv_ch = d_in + 2 * N
        tpz = self.shard(zdim, self.tp)
        d_in_loc = d_in // self.shard(d_in, self.tp)
        self.ew(f"{tag}.norm", m * d)
        self.mm(f"{tag}.in_proj", m, zdim // tpz, d)
        self.ew(f"{tag}.conv", m * conv_ch, reads=2, writes=1, flops=8.0)
        ir, rep = scan_mixer_ir(nelem=m * d_in_loc, state=N, backend=self.backend)
        self.mixer(f"{tag}.scan", ir, rep)
        self.ew(f"{tag}.gate", m * d_in_loc, reads=2, writes=1, flops=4.0)
        self.mm(f"{tag}.out_proj", m, d, d_in_loc)
        self.coll(f"{tag}.ar_ssm", "all-reduce", m * d, self.tp, stream="inline")
        self.ew(f"{tag}.resid", m * d, reads=2, writes=1, flops=1.0)
        self.gather_layer(f"L{li + 1}.ag_w")
        if cfg.shared_attn_period and (li + 1) % cfg.shared_attn_period == 0:
            stag = f"L{li}.shared"
            self._emit_attn(stag)
            self._emit_mlp(stag)
            self.gather_layer(f"{stag}.ag_w")  # shared params re-gather

    def emit_head(self):
        cfg, m, d = self.cfg, self.m, self.cfg.d_model
        v_loc = cfg.vocab // self.shard(cfg.vocab, self.tp)
        self.ew("final_norm", m * d)
        self.mm("head", m, v_loc, d)
        if self.kind == "train":
            self.ew("loss", m * v_loc, reads=2, writes=1, flops=8.0)

    # ---- backward + optimizer replay ---------------------------------------- #

    def emit_backward(self):
        """Replay the recorded forward in reverse: dgrad + wgrad per matmul,
        doubled mixers, widened elementwise streams; a gradient reduce-scatter
        fires on the comm lane as each layer's backward completes."""
        fsdp_n = axes_size(self.rules.fsdp, self.sizes)
        w_pending = 0
        for op in reversed(list(self._ops)):
            if op[0] == "mm":
                _, name, m, n, k = op
                self.mm(f"{name}.dx", m, k, n, w_count=0)
                self.mm(f"{name}.dw", k, n, m, w_count=0)
            elif op[0] == "ew":
                _, name, nelem, reads, writes, flops = op
                self.ew(f"{name}.bwd", nelem, reads=reads + writes, writes=reads,
                        flops=flops)
            elif op[0] == "mixer":
                _, name, ir, repeat = op
                self._emit(f"{name}.bwd", ir, 2 * repeat, op="mixer")
            elif op[0] == "coll":
                _, name, kind, count, ax = op  # tp all-reduce of dgrads
                self.coll(f"{name}.bwd", kind, count, (ax,), stream="inline")
            elif op[0] == "layer_params":
                w_pending += op[1]
            elif op[0] == "layer_start":
                self._grad_rs(w_pending, fsdp_n)
                w_pending = 0
        self._ops = []

    def _grad_rs(self, w: int, fsdp_n: int) -> None:
        if w and fsdp_n > 1 and w % fsdp_n == 0:
            self.coll("grad_rs", "reduce-scatter", w // fsdp_n,
                      self.rules.fsdp, stream="rs")

    def emit_optimizer(self):
        cfg = self.cfg
        shards = axes_size(self.rules.fsdp, self.sizes) * axes_size(
            self.tp, self.sizes
        )
        n = max(1, cfg.n_params() // shards)
        if self._last_comm:  # the update joins on the last gradient shard
            self._pending.append(self._last_comm)
        # fused adamw: read p/m/v/g, write p/m/v
        self.ew("optimizer", n, reads=4, writes=3, flops=12.0)

    # ---- driver -------------------------------------------------------------- #

    def run(self) -> KernelDAG:
        cfg = self.cfg
        emit = {
            "ssm": self.emit_ssm_layer,
            "hybrid": self.emit_hybrid_layer,
        }.get(cfg.family, self.emit_dense_layer)
        self.emit_embed()
        # each layer's trailing gather_layer() prefetches the next layer's
        # params on the comm lane; layer 0's gather is folded into the first
        # one (same total volume, and an up-front gather can't overlap anyway)
        self.layer_start()
        for li in range(cfg.n_layers):
            emit(li)
        self.emit_head()
        if self.kind == "train":
            self.layer_start()
            self.emit_backward()
            self.emit_optimizer()
        self.dag.validate()
        return self.dag


def trace_step(
    model,
    *,
    batch: int = 8,
    seq: int = 512,
    mesh=None,
    backend: str = "gpu",
    kind: str = "forward",
) -> KernelDAG:
    """Trace one model step (``forward`` or full ``train``) into a KernelDAG.

    ``model`` is an :class:`ArchConfig`, an arch id string, or anything with a
    ``.cfg`` (the port's ``LM``).  ``mesh`` takes every spelling
    :func:`~repro_torch.launch.mesh.mesh_spec` accepts.
    """
    cfg = _resolve_cfg(model)
    if kind not in STEP_KINDS:
        raise ValueError(f"kind {kind!r} not in {STEP_KINDS}")
    if backend not in ("gpu", "tpu"):
        raise ValueError(f"backend {backend!r} not in ('gpu', 'tpu')")
    spec = mesh_spec(mesh)
    return _Tracer(cfg, spec, batch=batch, seq=seq, backend=backend, kind=kind).run()


def collective_seconds(node, mesh: MeshSpec, machine) -> float:
    """Ring-model seconds for one collective node on one machine."""
    from .replay import COLLECTIVE_LATENCY_S

    n = dict(mesh.axes).get(node.axis, 1)
    if n <= 1:
        return 0.0
    wire = collective_wire_bytes(node.comm_kind, node.comm_bytes, n)
    return wire / mesh.bandwidth(node.axis, machine) + COLLECTIVE_LATENCY_S
