"""Seeded-bug IR fixtures: each one a minimal AccessIR carrying exactly the
defect its name says, used by the differential tests, the golden lint
reports, and the CI ``lint-smoke`` job (which fails if any of these pass
clean).

Copy of ``repro.analysis.fixtures``; held ``==`` to it by
``tests/test_torch_analysis.py``.

``FIXTURES`` maps fixture name -> zero-arg builder; ``EXPECTED_RULES`` maps
fixture name -> the rule id that must fire (at any severity).
"""
from __future__ import annotations

from ..frontend.ir import AccessIR, IRAccess, IRField


def racy_store() -> AccessIR:
    """Two distinct parallel points store the same element: the map
    ``(i, j) -> i + 4 j`` over an 8x8 space folds 64 points onto 36 addresses."""
    return AccessIR(
        name="fixture_racy_store",
        fields=(IRField(name="out", shape=(64,)),),
        accesses=(
            IRAccess(field="out", coeffs=((1, 4),), offset=(0,), is_store=True),
        ),
        iter_shape=(8, 8),
        block=(8, 8),
    )


def inplace_update() -> AccessIR:
    """Read-write race: each point loads its right neighbor of the same field
    it stores (classic un-buffered stencil update)."""
    return AccessIR(
        name="fixture_inplace_update",
        fields=(IRField(name="buf", shape=(64,)),),
        accesses=(
            IRAccess(field="buf", coeffs=((1,),), offset=(1,)),
            IRAccess(field="buf", coeffs=((1,),), offset=(0,), is_store=True),
        ),
        iter_shape=(63,),
        block=(63,),
    )


def oob_halo() -> AccessIR:
    """+-1 halo reads without padding: base map in bounds, offsets walk out."""
    return AccessIR(
        name="fixture_oob_halo",
        fields=(
            IRField(name="src", shape=(64,)),
            IRField(name="dst", shape=(64,), alignment=64),
        ),
        accesses=(
            IRAccess(field="src", coeffs=((1,),), offset=(-1,)),
            IRAccess(field="src", coeffs=((1,),), offset=(1,)),
            IRAccess(field="dst", coeffs=((1,),), offset=(0,), is_store=True),
        ),
        iter_shape=(64,),
        block=(64,),
    )


def oob_store() -> AccessIR:
    """A store whose image lies entirely past the allocation."""
    return AccessIR(
        name="fixture_oob_store",
        fields=(IRField(name="out", shape=(64,)),),
        accesses=(
            IRAccess(field="out", coeffs=((1,),), offset=(100,), is_store=True),
        ),
        iter_shape=(32,),
        block=(32,),
    )


def aliased_pair() -> AccessIR:
    """Two fields the model cannot tell apart: identical declaration and
    identical address image (the flash-attention-style aliasing bug)."""
    return AccessIR(
        name="fixture_aliased_pair",
        fields=(
            IRField(name="a", shape=(128,)),
            IRField(name="b", shape=(128,)),
            IRField(name="out", shape=(128,), alignment=128),
        ),
        accesses=(
            IRAccess(field="a", coeffs=((1,),), offset=(0,)),
            IRAccess(field="b", coeffs=((1,),), offset=(0,)),
            IRAccess(field="out", coeffs=((1,),), offset=(0,), is_store=True),
        ),
        iter_shape=(128,),
        block=(128,),
    )


def gap_store() -> AccessIR:
    """Stores tile only every other element of the declared output."""
    return AccessIR(
        name="fixture_gap_store",
        fields=(IRField(name="out", shape=(32,)),),
        accesses=(
            IRAccess(field="out", coeffs=((2,),), offset=(0,), is_store=True),
        ),
        iter_shape=(16,),
        block=(16,),
    )


def block_revisit() -> AccessIR:
    """Pallas accumulation idiom: the output index_map ignores a grid dim."""
    return AccessIR(
        name="fixture_block_revisit",
        fields=(
            IRField(name="x", shape=(512, 512), dtype_bits=32),
            IRField(name="o", shape=(512, 128), dtype_bits=32),
        ),
        accesses=(
            IRAccess(
                field="x",
                coeffs=((1, 0), (0, 1)),
                offset=(0, 0),
                tile=(128, 128),
            ),
            IRAccess(
                field="o",
                coeffs=((1, 0), (0, 0)),
                offset=(0, 0),
                tile=(128, 128),
                is_store=True,
            ),
        ),
        iter_shape=(4, 4),
    )


def block_revisit_parallel() -> AccessIR:
    """Same shape as :func:`block_revisit` but the revisited grid dim is
    declared parallel — a genuine block-space write-write race."""
    ir = block_revisit()
    return AccessIR(
        name="fixture_block_revisit_parallel",
        fields=ir.fields,
        accesses=ir.accesses,
        iter_shape=ir.iter_shape,
        meta={"parallel_dims": (0, 1)},
    )


FIXTURES = {
    "racy_store": racy_store,
    "inplace_update": inplace_update,
    "oob_halo": oob_halo,
    "oob_store": oob_store,
    "aliased_pair": aliased_pair,
    "gap_store": gap_store,
    "block_revisit": block_revisit,
    "block_revisit_parallel": block_revisit_parallel,
}

#: rule that must fire for each fixture (CI fails if it does not)
EXPECTED_RULES = {
    "racy_store": "race.write_write",
    "inplace_update": "race.read_write",
    "oob_halo": "bounds.halo",
    "oob_store": "bounds.oob",
    "aliased_pair": "alias.identical_field",
    "gap_store": "coverage.gap",
    "block_revisit": "race.block_revisit",
    "block_revisit_parallel": "race.write_write",
}
