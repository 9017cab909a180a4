"""HLO analysis: extract collective-communication volumes from lowered/compiled HLO.

Copy of ``repro.core.hlo_analysis``, every float operation in the same order
(held ``==`` to it by ``tests/test_torch_hlo_roofline.py``).  The port has
no XLA: its dry run (``repro_torch.launch.dryrun``) fills a
:class:`CollectiveStats` from the collectives a fake-tensor trace issues and
prices each with the same ring model (:func:`collective_wire_bytes`), which
the whole-model replay (``repro_torch.graph``) uses for its communication
edges too.  The text parsers read HLO that the JAX package writes.

``compiled.cost_analysis()`` reports FLOPs and HBM bytes but *not* collective bytes,
so we parse the HLO text and sum operand sizes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute op (assignment §ROOFLINE).  Wire
bytes per device follow the standard ring-algorithm factors.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

DTYPE_BYTES = {
    "pred": 1,
    "s4": 0.5,
    "u4": 0.5,
    "s8": 1,
    "u8": 1,
    "s16": 2,
    "u16": 2,
    "s32": 4,
    "u32": 4,
    "s64": 8,
    "u64": 8,
    "f8e4m3fn": 1,
    "f8e5m2": 1,
    "f8e4m3": 1,
    "bf16": 2,
    "f16": 2,
    "f32": 4,
    "f64": 8,
    "c64": 8,
    "c128": 16,
    "u1": 0.125,
}

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "ragged-all-to-all",
)

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def shape_bytes(text: str) -> float:
    """Sum of element bytes over every shape literal in ``text``."""
    total = 0.0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dtype]
    return total


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: float
    group_size: int
    wire_bytes: float  # per participating device


@dataclass
class CollectiveStats:
    ops: list[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    def wire_bytes_by_group_size(self) -> dict[int, float]:
        out: dict[int, float] = {}
        for o in self.ops:
            out[o.group_size] = out.get(o.group_size, 0.0) + o.wire_bytes
        return out

    def by_kind(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for o in self.ops:
            out[o.kind] = out.get(o.kind, 0.0) + o.wire_bytes
        return out

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for o in self.ops:
            out[o.kind] = out.get(o.kind, 0) + 1
        return out


def _group_size(line: str, default: int) -> int:
    m = _IOTA_GROUPS_RE.search(line)
    if m:
        return int(m.group(2))  # [num_groups, group_size]<=[devices]
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


def collective_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Ring-algorithm bytes moved per device for one collective.

    Public: the whole-model replay (`repro_torch.graph`) prices its communication
    edges with the same ring model this module applies to dry-run HLO, so an
    analytically traced step and a compiled one agree on wire volumes.
    ``result_bytes`` is the op's *result* buffer per device (gathered buffer
    for all-gather, scattered shard for reduce-scatter)."""
    return _wire_bytes(kind, result_bytes, n)


def _wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Ring-algorithm bytes moved per device."""
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * result_bytes * f
    if kind == "all-gather":
        return result_bytes * f  # result is the gathered (large) buffer
    if kind == "reduce-scatter":
        return result_bytes * n * f  # result is the scattered (small) shard
    if kind in ("all-to-all", "ragged-all-to-all"):
        return result_bytes * f
    if kind == "collective-permute":
        return result_bytes
    return result_bytes


def analyze_collectives(hlo_text: str, default_group: int = 1) -> CollectiveStats:
    """Scan HLO text for collective ops; '-start' variants counted, '-done' skipped."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        s = line.strip()
        if "=" not in s:
            continue
        lhs, _, rhs = s.partition("=")
        rhs = rhs.strip()
        kind = None
        for op in COLLECTIVE_OPS:
            if rhs.startswith(f"{op}(") or rhs.split(" ", 1)[-1].startswith(
                (f"{op}(", f"{op}-start(")
            ):
                kind = op
                break
            # typical form: "%x = f32[..] all-gather(...)" -> op name after shape
            m = re.search(rf"\s({op})(-start)?\(", rhs)
            if m:
                kind = op
                break
        if kind is None:
            continue
        if re.search(r"-done\(", rhs):
            continue
        # result shape(s) are between '=' and the op name
        head = rhs[: rhs.index(kind)]
        rb = shape_bytes(head)
        if kind == "all-gather" and "-start(" in rhs:
            # all-gather-start result tuple contains (operand, result); halve
            rb = rb / 2 if rb else rb
        if kind == "all-reduce" and "-start(" in rhs:
            rb = rb  # tuple is (operand) only in older HLO; keep as-is
        n = _group_size(s, default_group)
        stats.ops.append(
            CollectiveOp(kind=kind, result_bytes=rb, group_size=n, wire_bytes=_wire_bytes(kind, rb, n))
        )
    return stats


def cost_analysis_scalars(cost: dict | list | None) -> dict[str, float]:
    """Normalize compiled.cost_analysis() output across jax versions."""
    if cost is None:
        return {}
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return {k: float(v) for k, v in cost.items() if isinstance(v, (int, float))}


# --------------------------------------------------------------------------- #
# Trip-count-aware HLO walk
#
# XLA's HloCostAnalysis (and therefore compiled.cost_analysis()) visits every
# instruction ONCE — a scan-over-layers while loop contributes a single layer's
# FLOPs.  The optimized HLO annotates loops with known_trip_count, so we walk the
# text, build the computation call graph (while bodies, fusion calls), propagate
# execution multipliers, and produce corrected FLOPs / HBM-bytes / collective
# volumes.  Bytes model: every non-fused op's operands + results cross HBM once
# (fusion internals stay in registers/VMEM) — the standard fusion-boundary
# traffic model.
# --------------------------------------------------------------------------- #

_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->.*\{")
_WHILE_RE = re.compile(r"\bwhile\(")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_TRIP_RE = re.compile(r"known_trip_count\\?\":\{\\?\"n\\?\":\\?\"(\d+)")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_DOT_RE = re.compile(r"=\s*\(?[a-z0-9]+\[[0-9,]*\][^ ]*\s+dot\(")
_DOT_ARGS_RE = re.compile(r"dot\(\s*%?([\w.\-]+)")
_LHS_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_DEF_RE = re.compile(r"^%?([\w.\-]+)\s*=\s*\(?([a-z0-9]+)\[([0-9,]*)\]")


@dataclass
class HLOReport:
    flops: float = 0.0  # trip-count-weighted matmul flops (per device)
    bytes: float = 0.0  # trip-count-weighted fusion-boundary bytes (per device)
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    n_while: int = 0
    multipliers: dict = field(default_factory=dict)


def _first_shape_dims(text: str):
    m = _SHAPE_RE.search(text)
    if not m:
        return None
    dims = m.group(2)
    return [int(d) for d in dims.split(",")] if dims else []


def analyze_hlo(hlo_text: str, default_group: int = 1) -> HLOReport:
    lines = hlo_text.splitlines()
    comp_of_line: list[str] = []
    current = "<top>"
    fused_comps: set[str] = set()
    shapes: dict[str, list[int]] = {}
    for ln in lines:
        s = ln.strip()
        m = _COMP_RE.match(s)
        if m and s.endswith("{"):
            current = m.group(1)
        comp_of_line.append(current)
        md = _DEF_RE.match(s)
        if md:
            dims = md.group(3)
            shapes[md.group(1)] = [int(d) for d in dims.split(",")] if dims else []

    # call edges: (parent, child, factor); fused computations = called by fusion ops
    edges: list[tuple[str, str, int]] = []
    for i, ln in enumerate(lines):
        s = ln.strip()
        parent = comp_of_line[i]
        if _WHILE_RE.search(s) and "body=" in s:
            trip = 1
            mt = _TRIP_RE.search(s)
            if mt:
                trip = int(mt.group(1))
            mb = _BODY_RE.search(s)
            mc = _COND_RE.search(s)
            if mb:
                edges.append((parent, mb.group(1), trip))
            if mc:
                edges.append((parent, mc.group(1), trip))
        else:
            mcall = _CALLS_RE.search(s)
            if mcall:
                edges.append((parent, mcall.group(1), 1))
                if " fusion(" in s:
                    fused_comps.add(mcall.group(1))

    mult: dict[str, float] = {}

    def entry_like(name: str) -> bool:
        return name == "<top>" or name.startswith(("main", "entry")) or ".entry" in name

    for name in set(comp_of_line):
        mult[name] = 1.0 if entry_like(name) else 0.0
    for _ in range(12):  # propagate through nesting (few levels suffice)
        changed = False
        for parent, child, factor in edges:
            target = mult.get(parent, 0.0) * factor
            if target > mult.get(child, 0.0):
                mult[child] = target
                changed = True
        if not changed:
            break
    # computations never reached keep multiplier 1 (defensive)
    for k, v in list(mult.items()):
        if v == 0.0:
            mult[k] = 1.0

    rep = HLOReport(multipliers={})
    for i, ln in enumerate(lines):
        s = ln.strip()
        if "=" not in s:
            continue
        comp = comp_of_line[i]
        m = mult.get(comp, 1.0)
        in_fused = comp in fused_comps
        # ---- flops: dot ops (inside or outside fusions) -------------------
        if _DOT_RE.search(s):
            result_dims = _first_shape_dims(s.split("=", 1)[1]) or []
            contract = _LHS_CONTRACT_RE.search(s)
            marg = _DOT_ARGS_RE.search(s)
            k_elems = 1
            if marg and contract and contract.group(1):
                lhs_dims = shapes.get(marg.group(1), [])
                # lhs operand may carry an inline shape instead of a name
                if not lhs_dims:
                    inline = _SHAPE_RE.search(s[s.index("dot(") :])
                    if inline and inline.group(2):
                        lhs_dims = [int(d) for d in inline.group(2).split(",")]
                for ci in contract.group(1).split(","):
                    ci = int(ci)
                    if ci < len(lhs_dims):
                        k_elems *= lhs_dims[ci]
            n_out = 1
            for d in result_dims:
                n_out *= d
            rep.flops += 2.0 * n_out * k_elems * m
        if s.startswith("while") or " while(" in s:
            rep.n_while += 1
        # ---- bytes: fusion-boundary traffic (skip ops inside fused comps) --
        if not in_fused:
            op_is_meta = any(
                f" {op}(" in s or s.split("=", 1)[1].strip().startswith(f"{op}(")
                for op in ("parameter", "constant", "tuple", "get-tuple-element", "bitcast")
            )
            if not op_is_meta:
                if "dynamic-update-slice(" in s:
                    # in-place on TPU (buffers donated/aliased): traffic is the
                    # updated slice, not the whole target buffer
                    args = s[s.index("dynamic-update-slice(") :]
                    names = re.findall(r"%([\w.\-]+)", args)
                    upd = shapes.get(names[1], []) if len(names) > 1 else []
                    n = 1
                    for d in upd:
                        n *= d
                    rep.bytes += 2 * n * 4 * m  # read+write, assume <=4B elems
                else:
                    rep.bytes += shape_bytes(s) * m
        # ---- collectives ---------------------------------------------------
        lhs, _, rhs = s.partition("=")
        rhs = rhs.strip()
        for op in COLLECTIVE_OPS:
            mm = re.search(rf"(^|\s)({op})(-start)?\(", rhs)
            if mm and not re.search(r"-done\(", rhs):
                head = rhs[: mm.start(2)]
                rb = shape_bytes(head)
                if mm.group(3) and op in ("all-gather", "all-reduce"):
                    rb = rb / 2 if rb else rb
                n = _group_size(s, default_group)
                rep.collectives.ops.append(
                    CollectiveOp(
                        kind=op,
                        result_bytes=rb,
                        group_size=n,
                        wire_bytes=_wire_bytes(op, rb, n) * m,
                    )
                )
                break
    rep.multipliers = {k: v for k, v in mult.items() if v > 1}
    return rep
