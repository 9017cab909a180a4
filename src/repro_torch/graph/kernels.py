"""Backend-parametric AccessIR builders for whole-model graph nodes: a copy
of ``repro.graph.kernels``.

These play the role `frontend/builders.py` plays for the frontier kernels, at
the granularity a model tracer needs: every layer of every supported family
decomposes into three primitive kernels — matmul, elementwise stream, and the
family's mixer (which `frontend.builders` already models on the GPU path).

Matmul granularity: the GPU §III estimator consumes per-thread affine address
lists, so a full-K dot per thread would cost K accesses per IR — and model is
what a *generated* kernel does anyway: a k-panel loop.  ``matmul_ir`` emits the
IR of ONE k-panel (one thread per output element, ``kp <= 64`` k-steps, output
accumulated in place) and returns ``repeat = K / kp``: the graph node runs the
panel kernel ``repeat`` times back-to-back.  Identical panels across layers
and weights share one fingerprint, so a whole model estimates a handful of
unique kernels.  On the TPU path the same call emits the block-granular
(grid x BlockSpec) IR of a tiled Pallas matmul directly — ``repeat`` is 1
because the k loop is the innermost grid dimension.

All fields are 32-bit: the §III model is fp32-granular (the paper's
instruction-mix calibration), and the smoke configs train in fp32.
"""
from __future__ import annotations

from ..frontend.builders import attention_gpu_ir, wkv_gpu_ir
from ..frontend.ir import AccessIR, IRAccess, IRField

DTYPE_BITS = 32
# GPU launch geometry for generated model kernels (one pinned, occupancy-sane
# shape per primitive — the graph predicts the model, not the block space)
MATMUL_BLOCK = (32, 8, 1)
ELEMWISE_BLOCK = (256, 1, 1)
MIXER_BLOCK = (64, 4, 1)


def _divisor_leq(n: int, cap: int) -> int:
    """Largest power-of-two-ish divisor of ``n`` not exceeding ``cap``."""
    best = 1
    d = 1
    while d <= cap:
        if n % d == 0:
            best = d
        d *= 2
    return best


def matmul_ir(m: int, n: int, k: int, *, backend: str, tag: str = "") -> tuple[AccessIR, int]:
    """(M, K) x (K, N) matmul node kernel -> (ir, repeat)."""
    if min(m, n, k) < 1:
        raise ValueError(f"degenerate matmul {m}x{k}x{n}")
    if backend == "gpu":
        kp = _divisor_leq(k, 64)
        a = IRField("a", (kp, m), DTYPE_BITS, alignment=0)
        b = IRField("b", (n, kp), DTYPE_BITS, alignment=32)
        c = IRField("c", (n, m), DTYPE_BITS, alignment=64)
        accesses = []
        for j in range(kp):  # one k-panel: kp a-elements + kp b-elements
            accesses.append(IRAccess("a", (0, kp, 0), j))
            accesses.append(IRAccess("b", (1, 0, 0), j * n))
        accesses.append(IRAccess("c", (1, n, 0), 0, is_store=True))
        ir = AccessIR(
            name=f"mm_m{m}n{n}kp{kp}{tag}",
            fields=(a, b, c),
            accesses=tuple(accesses),
            iter_shape=(n, m, 1),
            block=MATMUL_BLOCK,
            flops_per_iter=2.0 * kp,
            regs_per_thread=64,
            meta={"app": "matmul", "m": m, "n": n, "k": k, "kp": kp},
        )
        return ir, k // kp
    # TPU: block-granular tiled matmul, k innermost grid dim (accumulate)
    bm = _divisor_leq(m, 256)
    bn = _divisor_leq(n, 256)
    bk = _divisor_leq(k, 256)
    a = IRField("a", (m, k), DTYPE_BITS)
    b = IRField("b", (k, n), DTYPE_BITS)
    c = IRField("c", (m, n), DTYPE_BITS)
    accesses = (
        IRAccess("a", ((1, 0, 0), (0, 0, 1)), (0, 0), tile=(bm, bk)),
        IRAccess("b", ((0, 0, 1), (0, 1, 0)), (0, 0), tile=(bk, bn)),
        IRAccess("c", ((1, 0, 0), (0, 1, 0)), (0, 0), tile=(bm, bn), is_store=True),
    )
    ir = AccessIR(
        name=f"mm_m{m}n{n}k{k}{tag}",
        fields=(a, b, c),
        accesses=accesses,
        iter_shape=(m // bm, n // bn, k // bk),
        flops_per_iter=2.0 * bm * bn * bk,
        is_matmul=True,
        meta={"app": "matmul", "m": m, "n": n, "k": k, "tiles": (bm, bn, bk)},
    )
    return ir, 1


def elementwise_ir(
    nelem: int,
    *,
    backend: str,
    reads: int = 1,
    writes: int = 1,
    flops_per_elem: float = 4.0,
    tag: str = "",
) -> tuple[AccessIR, int]:
    """Streaming elementwise kernel over ``nelem`` elements -> (ir, repeat=1)."""
    if nelem < 1:
        raise ValueError(f"degenerate elementwise size {nelem}")
    if backend == "gpu":
        fields = []
        accesses = []
        for i in range(reads):
            fields.append(IRField(f"r{i}", (nelem,), DTYPE_BITS, alignment=32 * i))
            accesses.append(IRAccess(f"r{i}", (1, 0, 0), 0))
        for i in range(writes):
            fields.append(
                IRField(f"w{i}", (nelem,), DTYPE_BITS, alignment=32 * (reads + i))
            )
            accesses.append(IRAccess(f"w{i}", (1, 0, 0), 0, is_store=True))
        ir = AccessIR(
            name=f"ew_n{nelem}r{reads}w{writes}{tag}",
            fields=tuple(fields),
            accesses=tuple(accesses),
            iter_shape=(nelem, 1, 1),
            block=ELEMWISE_BLOCK,
            flops_per_iter=float(flops_per_elem),
            regs_per_thread=32,
            meta={"app": "elementwise", "n": nelem, "reads": reads, "writes": writes},
        )
        return ir, 1
    # TPU: stream (rows, 128) tiles; rb bounded so a double-buffered tile pair
    # per operand stays well under VMEM
    lanes = 128
    if nelem % lanes == 0:
        rows = nelem // lanes
        rb = _divisor_leq(rows, 1024)
        grid = (rows // rb,)
        tile = (rb, lanes)
        coeffs = ((1,), (0,))
        offset = (0, 0)
    else:  # tiny non-aligned smoke sizes: one block
        grid = (1,)
        tile = (1, nelem)
        coeffs = ((0,), (0,))
        offset = (0, 0)
    fields = []
    accesses = []
    for i in range(reads):
        fields.append(IRField(f"r{i}", (nelem,), DTYPE_BITS))
        accesses.append(IRAccess(f"r{i}", coeffs, offset, tile=tile))
    for i in range(writes):
        fields.append(IRField(f"w{i}", (nelem,), DTYPE_BITS))
        accesses.append(IRAccess(f"w{i}", coeffs, offset, tile=tile, is_store=True))
    steps = grid[0]
    ir = AccessIR(
        name=f"ew_n{nelem}r{reads}w{writes}{tag}",
        fields=tuple(fields),
        accesses=tuple(accesses),
        iter_shape=grid,
        flops_per_iter=float(flops_per_elem) * (nelem // steps),
        is_matmul=False,
        meta={"app": "elementwise", "n": nelem, "reads": reads, "writes": writes},
    )
    return ir, 1


def wkv_mixer_ir(
    *, BH: int, S: int, K: int, backend: str
) -> tuple[AccessIR, int]:
    """RWKV6 chunked-WKV mixer -> (ir, repeat)."""
    chunk = _divisor_leq(S, 64)
    if backend == "gpu":
        return wkv_gpu_ir(MIXER_BLOCK, chunk=chunk, BH=BH, S=S, K=K), 1
    # TPU: the intra-chunk pass is (L, L, K) + (L, K, L) matmuls per
    # (batch*head, chunk) pair — two tiled-matmul nodes with a repeat count
    nc = S // chunk
    ir, rep = matmul_ir(chunk, chunk, K, backend=backend, tag="_wkv")
    return ir, rep * 2 * BH * nc  # scores + value accumulation passes


def attention_mixer_ir(
    *, batch: int, heads: int, S: int, hd: int, backend: str
) -> tuple[AccessIR, int]:
    """Naive MHA mixer (scores + value matmul) -> (ir, repeat)."""
    if backend == "gpu":
        return attention_gpu_ir(MIXER_BLOCK, s=S, heads=heads, d=hd), batch
    ir, rep = matmul_ir(S, S, hd, backend=backend, tag="_attn")
    return ir, rep * 2 * batch * heads  # qk^T scores + attention-weighted values


def scan_mixer_ir(
    *, nelem: int, state: int, backend: str
) -> tuple[AccessIR, int]:
    """Mamba2/SSD chunked-scan mixer, modelled as a state-weighted stream:
    one pass over the (B, S, d_inner) activations with 2*N flops per element
    (decay-masked outer-product accumulate against the (N, P) state)."""
    return elementwise_ir(
        nelem,
        backend=backend,
        reads=4,  # x, dt, B, C streams
        writes=1,
        flops_per_elem=2.0 * state,
        tag="_scan",
    )
