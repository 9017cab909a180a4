"""Entry point of the chunked RWKV6 WKV, with its chunk choice.

Counterpart of ``repro.kernels.wkv.ops``.  The JAX package ranks chunk
lengths with its TPU estimator (VMEM, MXU), which says nothing about this
kernel, and the registry's ``wkv_gpu_ir`` models the intra-chunk pass alone,
not the fused kernel with its state.  So the chunk is not ranked: it is
fixed by measurement.  :data:`MEASURED_ORDER` lists the compiled chunks by
their time on an NVIDIA H100 80GB HBM3 (700 W) at RWKV6-1.6B's width (32
heads of K = 64 at batch 2: BH = 64, S = 4096, f32), and
:func:`select_chunk` takes the first that divides S.  Since 16 divides
every multiple of 32 and 64, that is always L = 16; ``chip_smoke.py``
times every compiled chunk at that shape on every run and ``PERF.md``
records the times, so the order stays checkable.
"""
from __future__ import annotations

from ...core import tpu_estimator as te
from .kernel import HEAD_DIMS, wkv_cuda
from .ref import wkv_plain

# fastest first, by chip_smoke.py's per-chunk times at that shape with the
# kernel split over v's columns (PERF.md, Findings)
MEASURED_ORDER = (16, 32, 64)


def config_space(BH: int, S: int, K: int) -> list[int]:
    """The compiled chunk lengths that divide ``S`` at head size ``K``, in
    :data:`MEASURED_ORDER`.  ``BH`` is not read: it keeps the JAX package's
    signature."""
    return [c for c in MEASURED_ORDER if not S % c] if K in HEAD_DIMS else []


def select_chunk(BH: int, S: int, K: int) -> int:
    """The first chunk of :func:`config_space`, the fastest measured chunk
    that this shape admits: 16 if 16 divides ``S`` and ``K`` is compiled,
    else ``ValueError``."""
    space = config_space(BH, S, K)
    if not space:
        raise ValueError(f"no compiled chunk divides seq {S} at K = {K}")
    return space[0]


def wkv(r, k, v, wlog, u, chunk: int | None = None, s0=None):
    """Chunked WKV of r, k, v, wlog (BH, S, K) and u (K,) or (H, K), from the
    state s0 (BH, K, K) or zeros; picks the chunk with :func:`select_chunk`
    where none is given.  Returns ``(out, s)`` as ``wkv_ref`` does (the JAX
    ``wkv`` returns out alone)."""
    if chunk is None:
        chunk = select_chunk(*r.shape)
    return wkv_cuda(r, k, v, wlog, u, chunk=chunk, s0=s0)


# The JAX package's Pallas tiles, for the TPU backend's host-side ranking.
TPU_CANDIDATE_CHUNKS = (16, 32, 64, 128, 256)


def tpu_config_space(BH: int, S: int, K: int, dtype_bits: int = 32):
    """Candidate chunk lengths L: per-step flops grow ~L^2*K (intra matmuls) while
    the sequential grid and per-token HBM traffic shrink ~1/L — the estimator
    finds the knee analytically.

    Copy of ``repro.kernels.wkv.ops.config_space`` (the Pallas tile space
    that :mod:`repro_torch.core.tpu_estimator` ranks on the host; the port
    launches no Pallas kernel).
    """
    out = []
    for L in TPU_CANDIDATE_CHUNKS:
        if S % L:
            continue
        accesses = tuple(
            te.BlockAccess(nm, (1, L, K), lambda b, c: (b, c, 0), dtype_bits)
            for nm in ("r", "k", "v", "w")
        ) + (
            te.BlockAccess("o", (1, L, K), lambda b, c: (b, c, 0), dtype_bits, True),
        )
        out.append(
            te.PallasConfig(
                name=f"wkv_L{L}",
                grid=(BH, S // L),
                accesses=accesses,
                # intra: A (L^2 K) + A@v (L^2 K) + inter/inject (2 L K^2)
                flops_per_step=2.0 * (2 * L * L * K + 2 * L * K * K),
                is_matmul=True,
                scratch_bytes=4 * K * K,
                meta={"chunk": L},
            )
        )
    return out


__all__ = ["config_space", "select_chunk", "wkv", "wkv_plain", "tpu_config_space"]
