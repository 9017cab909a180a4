"""Machine-dependent performance lints (never ``error`` severity).

Copy of ``repro.analysis.perf``; held ``==`` to it by
``tests/test_torch_analysis.py``.

These reuse the estimator's own primitives — warp-order address generation,
the §III.B bank-conflict model, occupancy arithmetic, symbolic line
footprints, TPU tile padding — so a lint and the estimate it annotates can
never disagree about the machine model.  Each finding carries a concrete
"swap these strides / shrink this tile" suggestion.

GPU lints run on element-granular IRs (which lower to a
:class:`~repro_torch.core.address.KernelSpec`); the VMEM capacity lint runs on
block-granular (Pallas) IRs against a :class:`~repro_torch.core.machine.TPUMachine`.
A granularity/machine mismatch simply produces no findings.
"""
from __future__ import annotations

import math

import numpy as np

from ..frontend.ir import AccessIR
from .findings import Finding


def run_perf_passes(ir: AccessIR, machine, cache=None, spec=None) -> list[Finding]:
    from ..core.machine import GPUMachine, TPUMachine

    if ir.granularity == "element" and isinstance(machine, GPUMachine):
        return _gpu_perf(ir, machine, cache, spec)
    if ir.granularity == "block" and isinstance(machine, TPUMachine):
        return _tpu_perf(ir, machine)
    return []


# --------------------------------------------------------------------------- #
# GPU (element-granular)


def _gpu_perf(ir: AccessIR, machine, cache=None, spec=None) -> list[Finding]:
    from ..core.estimator import EstimateCache, _BatchPrims
    from ..core.waves import interior_block_box
    from ..frontend.lower import lower_gpu

    if not ir.block:
        return []  # no launch geometry, nothing machine-specific to check
    if spec is None:
        spec = lower_gpu(ir)
    box = interior_block_box(spec.launch)
    # Sharing a Study's EstimateCache makes the lints near-free inside a sweep:
    # the bank cycles and block footprints computed here are the same memoized
    # sub-results the estimator's L1 stage consumes right after the gate.
    prims = _BatchPrims(cache if cache is not None else EstimateCache(), "sym")
    out: list[Finding] = []
    out += _uncoalesced(spec, box, machine)
    out += _bank_conflicts(spec, box, machine, prims)
    out += _occupancy(spec, machine)
    out += _l1_capacity(spec, box, machine, prims)
    return out


def _uncoalesced(spec, box, machine) -> list[Finding]:
    """First-warp sector count per access vs the perfectly coalesced count."""
    w = min(machine.warp_threads, box.count)
    if w < 2:
        return []
    # first w threads in CUDA linearization (x fastest, then y, then z) —
    # built directly instead of materializing the whole block's coords
    (x0, x1), (y0, y1), (z0, z1) = box.x, box.y, box.z
    bx, by = x1 - x0, y1 - y0
    lin = np.arange(w, dtype=np.int64)
    tx = x0 + lin % bx
    ty = y0 + (lin // bx) % by
    tz = z0 + lin // (bx * by)
    # fold copies share (field, coeffs): lint each distinct stride pattern once
    seen: dict[tuple, list] = {}
    for i, a in enumerate(spec.accesses):
        key = (a.field.name, a.coeffs, a.is_store)
        if key in seen:
            seen[key][1] += 1
        else:
            seen[key] = [i, 1, a]
    reps = list(seen.values())
    # one batched address matrix over all distinct patterns; per-row sector
    # count = run count of the sorted sector indices (no per-access np.unique)
    coeffs = np.array([r[2].coeffs for r in reps], dtype=np.int64)
    offs = np.array([r[2].offset for r in reps], dtype=np.int64)
    es_all = np.array([r[2].field.element_size for r in reps], dtype=np.int64)
    align = np.array([r[2].field.alignment for r in reps], dtype=np.int64)
    addr = align[:, None] + (
        offs[:, None] + coeffs @ np.stack([tx, ty, tz])
    ) * es_all[:, None]
    sec = np.sort(addr // machine.sector_bytes, axis=1)
    sectors_all = 1 + (sec[:, 1:] != sec[:, :-1]).sum(axis=1)
    out: list[Finding] = []
    for row, (i, n, a) in enumerate(reps):
        es = a.field.element_size
        sectors = int(sectors_all[row])
        ideal = max(1, math.ceil(w * es / machine.sector_bytes))
        if sectors < 2 * ideal:
            continue
        first_addr = int(addr[row, 0])
        cx = a.coeffs[0]
        kind = "store" if a.is_store else "load"
        many = f" ({n} accesses share this stride)" if n > 1 else ""
        out.append(
            Finding(
                rule="perf.uncoalesced",
                severity="warn",
                field=a.field.name,
                access=i,
                message=(
                    f"{kind} touches {sectors} {machine.sector_bytes}B sectors "
                    f"per warp (coalesced would need {ideal}): the x-fastest "
                    f"lane stride is {cx} elements ({cx * es} B), not unit{many}"
                ),
                address=first_addr,
                suggestion=(
                    f"swap the access strides so the unit-stride axis is x "
                    f"(coeffs {tuple(a.coeffs)} -> x coefficient 1), or "
                    f"transpose {a.field.name!r}'s layout"
                ),
            )
        )
    return out


def _bank_conflicts(spec, box, machine, prims) -> list[Finding]:
    """§III.B model on the interior block: actual vs conflict-free L1 cycles."""
    half = 16
    n_loads = sum(1 for a in spec.accesses if not a.is_store)
    if n_loads == 0 or box.count < half:
        return []
    if (machine.bank_bytes, machine.n_banks) == (8, 16):
        cycles = prims.l1_cycles(spec.accesses, box)
    else:
        # exotic bank geometry: the machine-independent cache key would lie
        from ..core.bankconflict import block_l1_cycles_fast

        cycles = block_l1_cycles_fast(
            spec.accesses, box, word_bytes=machine.bank_bytes, n_banks=machine.n_banks
        )
    rows_per_load = math.ceil(box.count / half)
    ideal = n_loads * rows_per_load  # >=1 cycle per half-warp instruction
    if cycles <= 2 * ideal:
        return []
    return [
        Finding(
            rule="perf.bank_conflict",
            severity="warn",
            message=(
                f"L1 bank conflicts: {cycles} cycles per block for {n_loads} "
                f"load(s) x {rows_per_load} half-warps (conflict-free would be "
                f"{ideal}) — some {machine.bank_bytes}B-word strides land many "
                f"lanes on one of the {machine.n_banks} banks"
            ),
            suggestion=(
                "pad the x extent of the conflicting field by one element (or "
                "make the lane stride odd) so consecutive lanes hit distinct banks"
            ),
        )
    ]


def _occupancy(spec, machine) -> list[Finding]:
    threads = spec.launch.block_threads
    if threads <= 0:
        return []
    blocks = machine.blocks_per_sm(threads, spec.regs_per_thread)
    occ = blocks * threads / machine.max_threads_per_sm
    by_threads = machine.max_threads_per_sm // threads
    by_regs = machine.regs_per_sm // max(spec.regs_per_thread * threads, 1)
    out: list[Finding] = []
    if occ < 0.25:
        limiter = "register file" if by_regs < by_threads else "block size"
        out.append(
            Finding(
                rule="perf.occupancy",
                severity="warn",
                message=(
                    f"occupancy cliff: {blocks} block(s)/SM x {threads} threads "
                    f"= {occ:.0%} of {machine.max_threads_per_sm} resident "
                    f"threads ({limiter}-limited) — too few warps to hide "
                    f"memory latency"
                ),
                suggestion=(
                    f"reduce regs_per_thread (now {spec.regs_per_thread}) or "
                    f"pick a block size dividing {machine.max_threads_per_sm} "
                    f"more finely"
                ),
            )
        )
    elif by_regs < by_threads:
        out.append(
            Finding(
                rule="perf.occupancy",
                severity="info",
                message=(
                    f"register-limited: {by_regs} block(s)/SM fit the register "
                    f"file vs {by_threads} by thread count "
                    f"({spec.regs_per_thread} regs/thread x {threads} threads)"
                ),
                suggestion="shaving registers would raise occupancy",
            )
        )
    return out


def _l1_capacity(spec, box, machine, prims) -> list[Finding]:
    if machine.line_bytes % machine.sector_bytes == 0:
        # warm the estimator's own sector-granularity key first: the line sets
        # below then coarsen from it arithmetically, so the sweep evaluates the
        # load footprint once instead of once per consumer
        prims.line_sets(spec.accesses, (box,), machine.sector_bytes, stores=False)
    (_, sets), block_bytes = prims.line_sets(
        spec.accesses, (box,), machine.line_bytes, stores=None
    )
    if block_bytes <= machine.l1_bytes:
        return []
    biggest = max(sets, key=lambda k: sets[k].cardinality)
    return [
        Finding(
            rule="perf.capacity",
            severity="warn",
            message=(
                f"one block's line footprint ({block_bytes / 1024:.0f} kB over "
                f"{len(sets)} field(s), largest {biggest!r}) exceeds L1 "
                f"({machine.l1_bytes // 1024} kB) — intra-block reuse spills to "
                f"L2 even at one resident block"
            ),
            suggestion=(
                f"shrink the thread block (now {tuple(spec.launch.block)}) or "
                f"split the widest-halo field into passes"
            ),
        )
    ]


# --------------------------------------------------------------------------- #
# TPU (block-granular)


def _tpu_perf(ir: AccessIR, machine) -> list[Finding]:
    from ..core.tpu_estimator import _tile_padded

    fields = ir.field_map
    vmem = ir.scratch_bytes
    per_op: list[tuple[str, int]] = []
    pad_losers: list[tuple[str, float, tuple, int]] = []
    for a in ir.accesses:
        bits = fields[a.field].dtype_bits
        padded = _tile_padded(a.tile, bits, machine)
        # double buffering, as the estimator charges it
        op_bytes = 2 * int(padded * bits / 8)
        vmem += op_bytes
        per_op.append((a.field, op_bytes))
        block = int(np.prod(a.tile)) if a.tile else 1
        if block and padded / block >= 2:
            pad_losers.append((a.field, padded / block, tuple(a.tile), bits))
    out: list[Finding] = []
    if vmem > machine.vmem_usable:
        worst = max(per_op, key=lambda kv: kv[1])
        out.append(
            Finding(
                rule="perf.capacity",
                severity="warn",
                field=worst[0],
                message=(
                    f"VMEM overflow: {vmem / 2**20:.1f} MiB of double-buffered "
                    f"blocks + scratch > {machine.vmem_usable / 2**20:.0f} MiB "
                    f"usable on {machine.name} — the estimator will mark this "
                    f"config infeasible; largest operand is {worst[0]!r} at "
                    f"{worst[1] / 2**20:.1f} MiB"
                ),
                suggestion=(
                    f"shrink {worst[0]!r}'s block shape (halving its innermost "
                    f"tiled dim frees {worst[1] / 2**21:.1f} MiB)"
                ),
            )
        )
    for name, ratio, tile, bits in pad_losers:
        sub = machine.sublane_multiple(bits)
        out.append(
            Finding(
                rule="perf.layout_padding",
                severity="info",
                field=name,
                message=(
                    f"block {tile} pads {ratio:.1f}x to the native "
                    f"({sub}, {machine.lanes}) tile at {bits}-bit — most of "
                    f"each DMA moves padding"
                ),
                suggestion=(
                    f"round the last two block dims of {name!r} up to "
                    f"multiples of ({sub}, {machine.lanes})"
                ),
            )
        )
    return out
