"""Plain PyTorch version of the range-r 3D star stencil (paper §IV.C).

Counterpart of ``repro.kernels.stencil25.ref``: the same offset order and
weights (copied here, since the port imports nothing of ``repro``), and the
same edge-clamped halo, so ``stencil25_plain`` equals ``stencil25_ref``.
"""
from __future__ import annotations

import numpy as np
import torch


def star_weights_np(r: int = 4) -> np.ndarray:
    """Deterministic normalized weights: center + 6r axis neighbors (numpy)."""
    n = 6 * r + 1
    w = np.arange(1, n + 1, dtype=np.float64)
    w /= w.sum()
    return w


def star_offsets(r: int = 4) -> list[tuple[int, int, int]]:
    """Canonical offset order (z, y, x): center, then per distance d the six
    axis neighbors in (+x, -x, +y, -y, +z, -z) order.  The CUDA kernel, this
    version and the JAX package share this order, so weights line up."""
    offs = [(0, 0, 0)]
    for d in range(1, r + 1):
        offs += [
            (0, 0, d),
            (0, 0, -d),
            (0, d, 0),
            (0, -d, 0),
            (d, 0, 0),
            (-d, 0, 0),
        ]
    return offs


def _shifted(src: torch.Tensor, dz: int, dy: int, dx: int) -> torch.Tensor:
    """``src[p + o]`` with every index clamped to the grid (edge halo)."""
    out = src
    for axis, d in enumerate((dz, dy, dx)):
        if d:
            n = src.shape[axis]
            idx = (torch.arange(n, device=src.device) + d).clamp_(0, n - 1)
            out = out.index_select(axis, idx)
    return out


def stencil25_plain(src: torch.Tensor, r: int = 4) -> torch.Tensor:
    """dst[p] = sum_k w_k * src[p + o_k] with an edge-clamped halo.

    ``src``: (nz, ny, nx).  Sums in ``src``'s dtype, in offset order, as
    ``stencil25_ref`` does.
    """
    w = torch.as_tensor(star_weights_np(r), dtype=src.dtype, device=src.device)
    out = torch.zeros_like(src)
    for k, (dz, dy, dx) in enumerate(star_offsets(r)):
        out = out + w[k] * _shifted(src, dz, dy, dx)
    return out
