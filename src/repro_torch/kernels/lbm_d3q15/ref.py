"""Plain PyTorch version of the D3Q15 conservative Allen-Cahn LB step.

Counterpart of ``repro.kernels.lbm_d3q15.ref`` (paper §IV.D): the same
velocity set, weights and operation order, periodic on all three axes via
``torch.roll``, so ``lbm_step_plain`` equals ``lbm_step_ref``.  The step

  * pulls the 15 pdf components from the neighbor in direction -c_q,
  * computes the new phase field phi = sum_q f_q,
  * takes the 3D7pt central-difference gradient of the *input* phase field,
  * BGK-relaxes towards the Allen-Cahn equilibrium with an
    interface-sharpening forcing term,
  * returns the 15 post-collision pdfs and the new phase.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device

# D3Q15: rest, 6 faces, 8 corners — (cx, cy, cz) per component.
DIRS: tuple[tuple[int, int, int], ...] = (
    (0, 0, 0),
    (1, 0, 0),
    (-1, 0, 0),
    (0, 1, 0),
    (0, -1, 0),
    (0, 0, 1),
    (0, 0, -1),
    (1, 1, 1),
    (1, 1, -1),
    (1, -1, 1),
    (1, -1, -1),
    (-1, 1, 1),
    (-1, 1, -1),
    (-1, -1, 1),
    (-1, -1, -1),
)

WEIGHTS: tuple[float, ...] = (2.0 / 9.0,) + (1.0 / 9.0,) * 6 + (1.0 / 72.0,) * 8


def lbm_step_plain(
    f: torch.Tensor,  # (15, nz, ny, nx) pdfs
    phase: torch.Tensor,  # (nz, ny, nx)
    vel: torch.Tensor,  # (3, nz, ny, nx) — (ux, uy, uz)
    tau: float = 0.8,
    width: float = 4.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (f_out, phase_out)."""
    ux, uy, uz = vel[0], vel[1], vel[2]
    # pull streaming: f_q(p) <- f_q(p - c_q); roll by +c moves value p-c to p
    pulled = [
        torch.roll(f[q], shifts=(cz, cy, cx), dims=(0, 1, 2))
        for q, (cx, cy, cz) in enumerate(DIRS)
    ]
    phi_new = pulled[0]
    for q in range(1, 15):
        phi_new = phi_new + pulled[q]
    # 3D7pt central differences on the INPUT phase field
    gx = 0.5 * (torch.roll(phase, -1, 2) - torch.roll(phase, 1, 2))
    gy = 0.5 * (torch.roll(phase, -1, 1) - torch.roll(phase, 1, 1))
    gz = 0.5 * (torch.roll(phase, -1, 0) - torch.roll(phase, 1, 0))
    inv_norm = 1.0 / torch.sqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    nx_, ny_, nz_ = gx * inv_norm, gy * inv_norm, gz * inv_norm
    sharp = (4.0 * phi_new * (1.0 - phi_new)) / width
    outs = []
    inv_tau = 1.0 / tau
    for q, (cx, cy, cz) in enumerate(DIRS):
        w = WEIGHTS[q]
        cu = 3.0 * (cx * ux + cy * uy + cz * uz)
        heq = w * phi_new * (1.0 + cu)
        forcing = w * sharp * (cx * nx_ + cy * ny_ + cz * nz_)
        outs.append(pulled[q] - inv_tau * (pulled[q] - heq) + forcing)
    return torch.stack(outs, dim=0), phi_new


def init_fields(
    shape: tuple[int, int, int],
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic droplet initial condition: the same numpy draws as
    ``repro.kernels.lbm_d3q15.init_fields``, so the same arrays.  ``device``
    defaults to ``"cuda"`` and raises without CUDA."""
    dev = resolve_device(device)
    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    # broadcast axes in place of the reference's meshgrid: the same
    # elementwise operations in the same order, so the same values
    z, y, x = np.arange(nz)[:, None, None], np.arange(ny)[None, :, None], np.arange(nx)
    r0 = min(shape) / 4.0
    dist = np.sqrt(
        (z - nz / 2.0) ** 2 + (y - ny / 2.0) ** 2 + (x - nx / 2.0) ** 2
    )
    phase = 0.5 * (1.0 - np.tanh(2.0 * (dist - r0) / 4.0))
    vel = 0.01 * rng.standard_normal((3, nz, ny, nx))
    # f = w_i * phase in f64, formed where it lives: 15 times phase's bytes
    # never pass through the host
    phase64 = torch.as_tensor(phase, device=dev)
    f = torch.stack([w * phase64 for w in WEIGHTS])
    return f.to(dtype), phase64.to(dtype), torch.as_tensor(vel, dtype=dtype, device=dev)
