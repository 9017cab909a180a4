"""GPU-space AccessIR builders for the frontier kernels (attention, WKV):
copies of ``repro.frontend.builders``.

These play the role the paper assigns to the code generator: emit the address
expressions a straightforward CUDA implementation of each kernel would
generate.  The whole-model estimator (``repro_torch.graph.kernels``) prices
its attention and WKV mixer nodes with them.

Both kernels are modelled at *score-space* granularity — one thread per
(column, row) pair of the dominant inner product — which keeps every address
affine in the thread coordinates:

* **attention** — naive (non-flash) multi-head attention: thread
  ``(skv, sq, h)`` reads the q/k/v rows feeding score ``S[h, sq, skv]`` and
  stores the score element.  MHA only: grouped-query attention indexes kv
  heads through an integer division of the head coordinate, which is not
  affine.
* **wkv** — the intra-chunk pass of chunked WKV (RWKV-6): thread
  ``(t2, t1, z)`` with ``z = bh * n_chunks + c`` reads the r/w rows at
  ``t1``, the k/v rows at ``t2`` of chunk ``c``, and stores the attention-like
  ``A[t1, t2]`` tile element.  The ``z`` packing makes the per-chunk base
  offset affine: ``bh*S*K + c*L*K == z*L*K`` exactly because ``S = n_chunks*L``.

These model a naive score pass, not the port's flash and chunked-WKV CUDA
kernels (ROADMAP Queue 2 item 7).
"""
from __future__ import annotations

from .ir import AccessIR, IRAccess, IRField, dedupe_ir


def attention_gpu_ir(
    block: tuple[int, int, int],
    s: int = 2048,
    heads: int = 32,
    d: int = 64,
    dtype_bits: int = 32,
) -> AccessIR:
    """Naive MHA attention, one thread per (kv, q, head) score element."""
    q = IRField("q", (d, s, heads), dtype_bits, alignment=0)
    k = IRField("k", (d, s, heads), dtype_bits, alignment=32)
    v = IRField("v", (d, s, heads), dtype_bits, alignment=64)
    scores = IRField("scores", (s, s, heads), dtype_bits, alignment=96)
    accesses = []
    for kk in range(d):  # q/k/v rows are d contiguous elements each
        accesses.append(IRAccess("q", (0, d, s * d), kk))
        accesses.append(IRAccess("k", (d, 0, s * d), kk))
        accesses.append(IRAccess("v", (d, 0, s * d), kk))
    accesses.append(IRAccess("scores", (1, s, s * s), 0, is_store=True))
    return AccessIR(
        name=f"attention_s{s}h{heads}d{d}",
        fields=(q, k, v, scores),
        accesses=dedupe_ir(accesses),
        iter_shape=(s, s, heads),
        block=tuple(block),
        flops_per_iter=4.0 * d,  # 2d score dot + 2d value accumulation
        regs_per_thread=64,
        meta={"app": "attention", "s": s, "heads": heads, "d": d},
    )


def wkv_gpu_ir(
    block: tuple[int, int, int],
    chunk: int = 64,
    BH: int = 64,
    S: int = 4096,
    K: int = 64,
    dtype_bits: int = 32,
) -> AccessIR:
    """Chunked-WKV intra-chunk pass, one thread per (t2, t1, chunk) pair."""
    L = int(chunk)
    if S % L:
        raise ValueError(f"chunk {L} does not divide sequence length {S}")
    nc = S // L
    r = IRField("r", (K, S, BH), dtype_bits, alignment=0)
    k = IRField("k", (K, S, BH), dtype_bits, alignment=32)
    v = IRField("v", (K, S, BH), dtype_bits, alignment=64)
    w = IRField("w", (K, S, BH), dtype_bits, alignment=96)
    a = IRField("a", (L, L, BH * nc), dtype_bits, alignment=128)
    accesses = []
    for kk in range(K):  # r/w at row t1, k/v at row t2, K elements each
        accesses.append(IRAccess("r", (0, K, L * K), kk))
        accesses.append(IRAccess("w", (0, K, L * K), kk))
        accesses.append(IRAccess("k", (K, 0, L * K), kk))
        accesses.append(IRAccess("v", (K, 0, L * K), kk))
    accesses.append(IRAccess("a", (1, L, L * L), 0, is_store=True))
    return AccessIR(
        name=f"wkv_intra_L{L}_K{K}",
        fields=(r, k, v, w, a),
        accesses=dedupe_ir(accesses),
        iter_shape=(L, L, BH * nc),
        block=tuple(block),
        flops_per_iter=4.0 * K,  # rk^T dot + Av accumulation, decay folded in
        regs_per_thread=64,
        meta={"app": "wkv", "chunk": L, "BH": BH, "S": S, "K": K},
    )
