"""AccessIR builders for whole-model graph nodes: the GPU branches of
``repro.graph.kernels``.

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
unique kernels.  The JAX package's TPU branches (block-granular Pallas IR),
and the ``backend`` parameter that selects them, wait for the port's TPU
backend (ROADMAP Queue 1 item 10); ``trace_step`` refuses that backend.

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


def matmul_ir(m: int, n: int, k: int, *, tag: str = "") -> tuple[AccessIR, int]:
    """(M, K) x (K, N) matmul node kernel -> (ir, repeat)."""
    if min(m, n, k) < 1:
        raise ValueError(f"degenerate matmul {m}x{k}x{n}")
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


def elementwise_ir(
    nelem: int,
    *,
    reads: int = 1,
    writes: int = 1,
    flops_per_elem: float = 4.0,
    tag: str = "",
) -> tuple[AccessIR, int]:
    """Streaming elementwise kernel over ``nelem`` elements -> (ir, repeat=1)."""
    if nelem < 1:
        raise ValueError(f"degenerate elementwise size {nelem}")
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


def wkv_mixer_ir(*, BH: int, S: int, K: int) -> tuple[AccessIR, int]:
    """RWKV6 chunked-WKV mixer -> (ir, repeat)."""
    chunk = _divisor_leq(S, 64)
    return wkv_gpu_ir(MIXER_BLOCK, chunk=chunk, BH=BH, S=S, K=K), 1


def attention_mixer_ir(*, batch: int, heads: int, S: int, hd: int) -> tuple[AccessIR, int]:
    """Naive MHA mixer (scores + value matmul) -> (ir, repeat)."""
    return attention_gpu_ir(MIXER_BLOCK, s=S, heads=heads, d=hd), batch


def scan_mixer_ir(*, nelem: int, state: int) -> tuple[AccessIR, int]:
    """Mamba2/SSD chunked-scan mixer, modelled as a state-weighted stream:
    one pass over the (B, S, d_inner) activations with 2*N flops per element
    (decay-masked outer-product accumulate against the (N, P) state)."""
    return elementwise_ir(
        nelem,
        reads=4,  # x, dt, B, C streams
        writes=1,
        flops_per_elem=2.0 * state,
        tag="_scan",
    )
