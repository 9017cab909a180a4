"""Deterministic cache simulation — the measurement stand-in.

Copy of ``repro.core.exactcount`` over the port's ``address``, ``machine``
and ``waves`` (held ``==`` to it by ``tests/test_torch_exactcount.py``).
On the card, ``chip_smoke.py``'s phase ``simulate`` sets its volumes
beside the measured ones of phase ``rank``.

The paper validates its estimates against hardware performance counters (nvprof
metrics).  Without a GPU, we validate against an exact, deterministic cache
simulation: sectored LRU caches fed with the very address streams the kernels would
issue (warps round-robin within a block; blocks wave-ordered).  This is independent
of the estimator's compulsory/capacity-split assumptions, so it plays the role of
the "measured" columns in EXPERIMENTS.md.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from .address import KernelSpec, ThreadBox
from .machine import GPUMachine, V100
from .waves import Wave, interior_block_box, representative_waves


class LRUCache:
    """Sectored LRU cache: lines of ``line_bytes`` allocated whole, sectors of
    ``sector_bytes`` transferred individually (Volta-style)."""

    def __init__(self, capacity: int, line_bytes: int, sector_bytes: int):
        self.capacity_lines = max(1, capacity // line_bytes)
        self.line_bytes = line_bytes
        self.sector_bytes = sector_bytes
        self.sectors_per_line = line_bytes // sector_bytes
        self.lines: OrderedDict[int, int] = OrderedDict()  # line -> sector bitmask
        self.miss_bytes = 0
        self.evicted_dirty_bytes = 0
        self.dirty: dict[int, int] = {}

    def access(self, sector_addr: int, is_store: bool = False) -> None:
        line = sector_addr // self.sectors_per_line
        bit = 1 << (sector_addr % self.sectors_per_line)
        mask = self.lines.get(line)
        if mask is None:
            if len(self.lines) >= self.capacity_lines:
                old, _ = self.lines.popitem(last=False)
                dirty_mask = self.dirty.pop(old, 0)
                self.evicted_dirty_bytes += bin(dirty_mask).count("1") * self.sector_bytes
            self.lines[line] = bit
            if not is_store:
                self.miss_bytes += self.sector_bytes
        else:
            self.lines.move_to_end(line)
            if not (mask & bit):
                self.lines[line] = mask | bit
                if not is_store:
                    self.miss_bytes += self.sector_bytes
        if is_store:
            self.dirty[line] = self.dirty.get(line, 0) | bit

    def flush_dirty_bytes(self) -> int:
        total = self.evicted_dirty_bytes
        for mask in self.dirty.values():
            total += bin(mask).count("1") * self.sector_bytes
        return total


def _block_sector_stream(
    spec: KernelSpec, box: ThreadBox, sector: int
) -> tuple[np.ndarray, np.ndarray]:
    """(sector_addresses, is_store) in program order, warps interleaved.

    Each warp instruction contributes its unique sectors once (coalescing); warps of
    a block are round-robin interleaved to mimic concurrent progress.
    """
    tx, ty, tz = box.coords_flat_warp_order()
    n = tx.size
    warp = 32
    pad = (-n) % warp
    streams: list[np.ndarray] = []  # per (access, warp): unique sectors
    flags: list[bool] = []
    per_warp: list[list[tuple[np.ndarray, bool]]] = []
    nwarps = (n + pad) // warp
    per_warp = [[] for _ in range(nwarps)]
    for a in spec.accesses:
        addr = a.byte_address(tx, ty, tz) // sector
        if pad:
            addr = np.concatenate([addr, np.repeat(addr[-1], pad)])
        rows = addr.reshape(nwarps, warp)
        for w in range(nwarps):
            per_warp[w].append((np.unique(rows[w]), a.is_store))
    # round-robin: warp0 access0, warp1 access0, ..., warp0 access1, ...
    n_acc = len(spec.accesses)
    out_addr: list[np.ndarray] = []
    out_store: list[np.ndarray] = []
    for ai in range(n_acc):
        for w in range(nwarps):
            sec, st = per_warp[w][ai]
            out_addr.append(sec)
            out_store.append(np.full(sec.shape, st, dtype=bool))
    return np.concatenate(out_addr), np.concatenate(out_store)


@dataclass
class SimResult:
    v_l2l1_load: float  # per LUP
    v_l2l1_store: float
    v_dram_load: float
    v_dram_store: float


def simulate(spec: KernelSpec, machine: GPUMachine = V100) -> SimResult:
    """Simulate L1 (per representative block) and L2 (per representative wave)."""
    sector, line = machine.sector_bytes, machine.line_bytes

    # --- L1: one representative interior block, write-through stores ---------
    blk = interior_block_box(spec.launch)
    blk_lups = max(1, blk.count * spec.lups_per_thread)
    addrs, stores = _block_sector_stream(spec, blk, sector)
    l1 = LRUCache(machine.l1_bytes, line, sector)
    store_through = 0
    for sa, st in zip(addrs.tolist(), stores.tolist()):
        if st:
            store_through += sector  # write-through, no allocate on store
        else:
            l1.access(sa, is_store=False)
    v_l2l1_load = l1.miss_bytes / blk_lups
    v_l2l1_store = store_through / blk_lups

    # --- L2: representative wave; L1-filtered per-block streams --------------
    prev, curr = representative_waves(spec, machine)[-1]
    l2 = LRUCache(machine.l2_bytes, line, sector)
    dram_load = 0
    wave_lups = 0
    for wave, count_misses in ((prev, False), (curr, True)):
        for box in wave.boxes(spec.launch):
            if box.count == 0:
                continue
            baddrs, bstores = _block_sector_stream(spec, box, sector)
            bl1 = LRUCache(machine.l1_bytes, line, sector)
            before = l2.miss_bytes
            for sa, st in zip(baddrs.tolist(), bstores.tolist()):
                if st:
                    l2.access(sa, is_store=True)
                else:
                    pre = bl1.miss_bytes
                    bl1.access(sa, is_store=False)
                    if bl1.miss_bytes > pre:  # L1 miss -> request hits L2
                        l2.access(sa, is_store=False)
            if count_misses:
                dram_load += l2.miss_bytes - before
                wave_lups += box.count * spec.lups_per_thread
    wave_lups = max(1, wave_lups)
    dram_store = l2.flush_dirty_bytes()
    # dirty traffic accumulated over both waves; attribute per-LUP over both
    total_lups = max(
        1,
        sum(
            b.count
            for w in (prev, curr)
            for b in w.boxes(spec.launch)
        )
        * spec.lups_per_thread,
    )
    return SimResult(
        v_l2l1_load=v_l2l1_load,
        v_l2l1_store=v_l2l1_store,
        v_dram_load=dram_load / wave_lups,
        v_dram_store=dram_store / total_lups,
    )
