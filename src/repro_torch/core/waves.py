"""Wave construction (paper §III.G).

Thread blocks are scheduled in X-Y-Z launch order; only a small portion runs
concurrently.  We subdivide the block grid into discrete waves of
``W = n_SM * blocks_per_SM`` consecutively numbered blocks.  The L2 collaborative
group is the current wave; DRAM reuse comes from the overlap of the current wave's
footprint with the previous wave's.
"""
from __future__ import annotations

from dataclasses import dataclass

from .address import KernelSpec, LaunchConfig, ThreadBox
from .machine import GPUMachine


def interior_block_box(launch: LaunchConfig) -> ThreadBox:
    """A representative interior block (paper: averaging over representative groups
    avoids boundary outliers; we pick the center block)."""
    gx, gy, gz = launch.grid_blocks
    return launch.block_box((gx // 2, gy // 2, gz // 2))


@dataclass(frozen=True)
class Wave:
    """One wave of concurrently running blocks: linear block ids [start, start+n)."""

    start: int
    n: int

    def boxes(self, launch: LaunchConfig) -> list[ThreadBox]:
        return [
            launch.block_box(launch.block_index(i))
            for i in range(self.start, self.start + self.n)
        ]

    def merged_boxes(self, launch: LaunchConfig) -> list[ThreadBox]:
        """The same thread set as :meth:`boxes`, as a few large strips.

        Consecutive linear block ids along x form one contiguous strip; full
        x-rows with consecutive y at the same z form one plane strip.  This
        collapses a wave of W blocks into O(few) boxes, which makes footprint
        evaluation cost independent of W (the paper's ISL-style decoupling).
        """
        gx, gy, gz = launch.grid_blocks
        bx, by, bz = launch.block
        tx, ty, tz = launch.threads
        out: list[ThreadBox] = []
        i, end = self.start, self.start + self.n
        while i < end:
            ix, iy, iz = launch.block_index(i)
            remaining = end - i
            if ix == 0 and remaining >= gx:
                rows = min(remaining // gx, gy - iy)
                out.append(
                    ThreadBox(
                        x=(0, tx),
                        y=(iy * by, min((iy + rows) * by, ty)),
                        z=(iz * bz, min((iz + 1) * bz, tz)),
                    )
                )
                i += rows * gx
            else:
                cnt = min(remaining, gx - ix)
                out.append(
                    ThreadBox(
                        x=(ix * bx, min((ix + cnt) * bx, tx)),
                        y=(iy * by, min((iy + 1) * by, ty)),
                        z=(iz * bz, min((iz + 1) * bz, tz)),
                    )
                )
                i += cnt
        return out

    def lups(self, launch: LaunchConfig, lups_per_thread: int) -> int:
        return sum(b.count for b in self.boxes(launch)) * lups_per_thread


def wave_size(spec: KernelSpec, machine: GPUMachine) -> int:
    per_sm = machine.blocks_per_sm(spec.launch.block_threads, spec.regs_per_thread)
    return max(1, machine.n_sm * per_sm)


def representative_waves(
    spec: KernelSpec, machine: GPUMachine, n_samples: int = 2
) -> list[tuple[Wave, Wave]]:
    """(previous, current) wave pairs at representative positions in the launch.

    If the whole grid is smaller than two waves there is no previous wave.
    """
    W = wave_size(spec, machine)
    total = spec.launch.num_blocks
    if total <= W:
        return [(Wave(0, 0), Wave(0, total))]
    pairs: list[tuple[Wave, Wave]] = []
    n_waves = total // W
    # sample wave indices away from the very first and the ragged last wave
    picks = sorted({max(1, n_waves // 4), max(1, n_waves // 2)})[:n_samples]
    for w in picks:
        prev = Wave((w - 1) * W, W)
        curr = Wave(w * W, min(W, total - w * W))
        pairs.append((prev, curr))
    return pairs
