"""Per-backend lowering of :class:`~repro_torch.frontend.ir.AccessIR`.

Copy of ``repro.frontend.lower`` (held ``==`` to it by
``tests/test_torch_estimator.py`` and ``tests/test_torch_tpu_estimator.py``).

* :func:`lower_gpu` — element-granular IR -> :class:`repro_torch.core.address.KernelSpec`,
  the input of the paper §III GPU pipeline.  The translation is positional and
  arithmetic-free.
* :func:`lower_tpu` — block-granular IR -> :class:`repro_torch.core.tpu_estimator.PallasConfig`
  (affine ``index_map`` closures reconstructed from the coefficient matrix);
  the exact inverse of :func:`repro_torch.frontend.pallas.trace_pallas`.  The
  port launches no Pallas kernel: the TPU backend prices such configs on
  the host.
* :func:`from_kernel_spec` — the canonical IR of an already-built
  :class:`KernelSpec`, whose fingerprint breaks ties in
  :func:`repro_torch.core.ranking.rank_configs`.
"""
from __future__ import annotations

from ..core.address import Access, Field, KernelSpec, LaunchConfig
from .ir import AccessIR, IRAccess, IRField


def _pad3(t: tuple[int, ...], fill: int) -> tuple[int, int, int]:
    if len(t) > 3:
        raise ValueError(f"GPU lowering supports at most 3 dims, got {t}")
    return tuple(t) + (fill,) * (3 - len(t))


def lower_gpu(ir: AccessIR) -> KernelSpec:
    """Lower an element-granular IR to the GPU estimator's KernelSpec."""
    if ir.granularity != "element":
        raise ValueError(
            f"IR {ir.name!r} is block-granular (Pallas-traced); it lowers to "
            "the TPU backend (core.tpu_estimator.estimate_ir), not the GPU one"
        )
    if not ir.block:
        raise ValueError(f"IR {ir.name!r}: GPU lowering needs a launch block")
    fields = {
        f.name: Field(
            name=f.name,
            shape=_pad3(f.shape, 1),
            element_size=f.element_size,
            alignment=f.alignment,
            components=f.components,
        )
        for f in ir.fields
    }
    accesses = tuple(
        Access(
            field=fields[a.field],
            coeffs=_pad3(a.coeffs[0], 0),
            offset=a.offset[0],
            is_store=a.is_store,
        )
        for a in ir.accesses
    )
    return KernelSpec(
        name=ir.name,
        fields=tuple(fields.values()),
        accesses=accesses,
        launch=LaunchConfig(
            block=_pad3(ir.block, 1), threads=_pad3(ir.iter_shape, 1)
        ),
        lups_per_thread=ir.lups_per_iter,
        flops_per_lup=ir.flops_per_iter,
        regs_per_thread=ir.regs_per_thread,
        meta=dict(ir.meta),
    )


def from_kernel_spec(spec: KernelSpec) -> AccessIR:
    """Canonical IR of an already-built KernelSpec (inverse of :func:`lower_gpu`)."""
    return AccessIR(
        name=spec.name,
        fields=tuple(
            IRField(
                name=f.name,
                shape=f.shape,
                dtype_bits=f.element_size * 8,
                alignment=f.alignment,
                components=f.components,
            )
            for f in spec.fields
        ),
        accesses=tuple(
            IRAccess(
                field=a.field.name,
                coeffs=a.coeffs,
                offset=a.offset,
                is_store=a.is_store,
            )
            for a in spec.accesses
        ),
        iter_shape=spec.launch.threads,
        block=spec.launch.block,
        lups_per_iter=spec.lups_per_thread,
        flops_per_iter=spec.flops_per_lup,
        regs_per_thread=spec.regs_per_thread,
        meta=dict(spec.meta),
    )


def _affine_index_map(matrix, offset):
    """Rebuild a Pallas-style ``index_map`` closure from its affine form."""

    def index_map(*coords):
        return tuple(
            o + sum(c * x for c, x in zip(row, coords))
            for row, o in zip(matrix, offset)
        )

    return index_map


def lower_tpu(ir: AccessIR):
    """Lower a block-granular IR back to a PallasConfig.

    Round-trips with :func:`repro_torch.frontend.pallas.trace_pallas`:
    ``trace_pallas(lower_tpu(ir)) == ir``.
    """
    from ..core import tpu_estimator as te  # deferred: core imports frontend

    if ir.granularity != "block":
        raise ValueError(
            f"IR {ir.name!r} is element-granular; it lowers to the GPU "
            "backend (lower_gpu), not to a PallasConfig"
        )
    fm = ir.field_map
    accesses = tuple(
        te.BlockAccess(
            name=a.field,
            block_shape=a.tile,
            index_map=_affine_index_map(a.coeffs, a.offset),
            dtype_bits=fm[a.field].dtype_bits,
            is_output=a.is_store,
        )
        for a in ir.accesses
    )
    return te.PallasConfig(
        name=ir.name,
        grid=ir.iter_shape,
        accesses=accesses,
        flops_per_step=ir.flops_per_iter,
        is_matmul=ir.is_matmul,
        scratch_bytes=ir.scratch_bytes,
        meta=dict(ir.meta),
    )
