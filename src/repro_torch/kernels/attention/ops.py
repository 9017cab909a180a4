"""Entry point of GQA flash attention, with its tile choice.

Counterpart of ``repro.kernels.attention.ops``.  The JAX package ranks
Pallas (block_q, block_kv) tiles with its TPU estimator, which models VMEM
and the MXU and so says nothing about this kernel.  No GPU IR describes the
fused flash kernel either (the registry's ``attention_gpu_ir`` models a
naive pass over the score matrix).  So the tile is not ranked: it is fixed
by measurement.  :data:`MEASURED_ORDER` lists the compiled tiles of each
input type's kernel by their time on an NVIDIA H100 80GB HBM3 (700 W) at
Qwen2.5-14B's width (B = 1, Hq = 40, Hkv = 8, S = 4096, D = 128, causal),
and :func:`select_blocks` takes the first that the kernel compiles at the
head dim and that takes S.  bf16 (the models' type) runs Hopper's kernel,
whose (128, block_kv) tiles take any S; ``chip_smoke.py`` times both of its
tiles at that shape on every run.  f32 runs the scalar kernel, whose tiles
must divide S: its order is the one measured for the earlier bf16 kernel
on the same four tiles, kept since no model path runs attention in f32.
``PERF.md`` records the times.
"""
from __future__ import annotations

import torch

from ...core import tpu_estimator as te
from .kernel import compiled, flash_attention_cuda, takes_seq
from .ref import mha_plain

# fastest first, by input type: bf16 by chip_smoke.py's per-tile times at
# that shape with Hopper's kernel, f32 as stated above (PERF.md, Findings)
MEASURED_ORDER = {
    torch.bfloat16: ((128, 128), (128, 64)),
    torch.float32: ((64, 64), (64, 32), (128, 64), (32, 32)),
}


def _kernel_dtype(dtype) -> torch.dtype:
    """The input type whose kernel's tiles ``dtype`` takes: bf16's, else
    f32's (on the CPU any other type runs the plain version with f32's
    tiles)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _order(dtype) -> tuple[tuple[int, int], ...]:
    return MEASURED_ORDER[_kernel_dtype(dtype)]


def config_space(
    b: int, hq: int, hkv: int, s: int, d: int, dtype=torch.bfloat16, causal: bool = True
) -> list[tuple[int, int]]:
    """The (block_q, block_kv) tiles compiled for ``dtype`` at head dim
    ``d`` that take ``s`` (any ``s`` in bf16, tiles that divide it in f32),
    in :data:`MEASURED_ORDER`.  ``b``, ``hq``, ``hkv`` and ``causal`` are
    not read: they keep the JAX package's signature, whose estimator ranks by
    them."""
    return [t for t in _order(dtype) if takes_seq(*t, s, dtype) and compiled(*t, d, _kernel_dtype(dtype))]


def select_blocks(
    b: int, hq: int, hkv: int, s: int, d: int, dtype=torch.bfloat16, causal: bool = True
) -> tuple[int, int]:
    """The first tile of :func:`config_space`, the fastest measured tile
    that this shape admits; ``ValueError`` where there is none (a head dim
    that is not compiled, or in f32 an ``s`` that no tile divides)."""
    space = config_space(b, hq, hkv, s, d, dtype, causal)
    if not space:
        raise ValueError(f"no compiled {dtype} tile takes seq {s} at head dim {d}")
    return space[0]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int | None = None,
    block_kv: int | None = None,
) -> torch.Tensor:
    """GQA attention of ``q`` (B, Hq, S, D) over ``k``, ``v`` (B, Hkv, S, D);
    picks the tile with :func:`select_blocks` where one is not given.  A CPU
    tensor runs the plain version, which does not tile: there the tile
    :func:`select_blocks` picks, or at a head dim the card does not compile
    the first listed tile of q's dtype that takes S.  (A fake tensor of a
    dry run lies on the CPU and reaches the kernel's path: it needs the
    compiled tile.)"""
    if block_q is None or block_kv is None:
        b, hq, s, d = q.shape
        if q.device.type == "cpu":
            fits = (config_space(b, hq, k.shape[1], s, d, q.dtype, causal)
                    or [t for t in _order(q.dtype) if takes_seq(*t, s, q.dtype)])
            bq, bkv = fits[0] if fits else select_blocks(b, hq, k.shape[1], s, d, q.dtype, causal)
        else:
            bq, bkv = select_blocks(b, hq, k.shape[1], s, d, q.dtype, causal)
        block_q = block_q or bq
        block_kv = block_kv or bkv
    return flash_attention_cuda(q, k, v, causal=causal, block_q=block_q, block_kv=block_kv)


# The JAX package's Pallas tiles, for the TPU backend's host-side ranking.
TPU_CANDIDATE_BLOCKS = (128, 256, 512, 1024)


def tpu_config_space(
    b: int, hq: int, hkv: int, s: int, d: int, dtype_bits: int, causal: bool = True
):
    """Candidate (block_q, block_kv) configs.

    Copy of ``repro.kernels.attention.ops.config_space`` (the Pallas tile
    space that :mod:`repro_torch.core.tpu_estimator` ranks on the host;
    the port launches no Pallas kernel).

    The kv refetch across the q-block loop is the V_red analogue: k/v blocks are
    refetched for every q block of the same head.  Larger kv blocks reduce grid
    overhead but raise VMEM; the estimator trades these off analytically.

    The grid splits the batch*head loop into (batch, kv_head, group) dims so
    every ``index_map`` is *affine* in the grid coordinates — the fused-``bh``
    form indexed kv heads through an integer division, which the AccessIR
    tracer rightly rejects (and which the old probe-based store keys silently
    mis-fingerprinted).  The enumeration order, and therefore the Pallas
    revisit/fetch schedule, is unchanged: ``bh == batch*hq + kv_head*g + grp``
    iterates exactly as the old fused dimension did.
    """
    group = max(1, hq // max(hkv, 1))
    out = []
    for bq in TPU_CANDIDATE_BLOCKS:
        for bkv in TPU_CANDIDATE_BLOCKS:
            if s % bq or s % bkv:
                continue
            nq, nkv = s // bq, s // bkv
            accesses = (
                te.BlockAccess(
                    "q",
                    (1, bq, d),
                    lambda bb, hk, gg, i, j, g=group, hq=hq: (
                        bb * hq + hk * g + gg,
                        i,
                        0,
                    ),
                    dtype_bits,
                ),
                te.BlockAccess(
                    "k",
                    (1, bkv, d),
                    lambda bb, hk, gg, i, j, hkv=hkv: (bb * hkv + hk, j, 0),
                    dtype_bits,
                ),
                te.BlockAccess(
                    "v",
                    (1, bkv, d),
                    lambda bb, hk, gg, i, j, hkv=hkv: (bb * hkv + hk, j, 0),
                    dtype_bits,
                ),
                te.BlockAccess(
                    "o",
                    (1, bq, d),
                    lambda bb, hk, gg, i, j, g=group, hq=hq: (
                        bb * hq + hk * g + gg,
                        i,
                        0,
                    ),
                    dtype_bits,
                    True,
                ),
            )
            # causal: ~half the kv blocks do useful work; flops halve but the
            # fetch schedule (grid) is unchanged
            useful = 0.5 if causal else 1.0
            out.append(
                te.PallasConfig(
                    name=f"flash_bq{bq}_bkv{bkv}",
                    grid=(b, hkv, group, nq, nkv),
                    accesses=accesses,
                    flops_per_step=useful * (4.0 * bq * bkv * d),
                    is_matmul=True,
                    scratch_bytes=4 * (bq * d + 2 * bq),
                    meta={"block_q": bq, "block_kv": bkv},
                )
            )
    return out


__all__ = ["config_space", "flash_attention", "mha_plain", "select_blocks", "tpu_config_space"]
