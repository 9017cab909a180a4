"""Pallas-tracing frontend: derive AccessIR from a PallasConfig automatically.

Copy of ``repro.frontend.pallas``; held ``==`` to it by
``tests/test_torch_tpu_estimator.py``.

A Pallas code generator already holds everything the estimator needs *before
emitting code*: the grid, each operand's block shape and its ``index_map`` from
grid coordinates to block coordinates.  Index maps are opaque Python closures,
so we recover their affine form by probing:

* the grid **origin** gives the offset vector,
* each **unit step** along a grid dim gives that dim's coefficient column,
* extra **verification probes** (double steps, the mixed ones-vector, the far
  grid corner) check that the recovered affine map reproduces the closure —
  a non-affine map (e.g. clamped boundary indexing ``min(i+1, n-1)``) that
  merely agrees at the origin/unit probes is detected and rejected with
  :class:`NonAffineIndexMapError` instead of silently aliasing a different
  access pattern (the failure mode the old store-key probes were open to).

All probes stay inside the grid domain, so a map is accepted iff it is affine
*over the coordinates it will actually see*; dims of extent 1 contribute a zero
coefficient (their step is unobservable and irrelevant).
"""
from __future__ import annotations

from ..obs import metrics as obs_metrics
from .ir import AccessIR, IRAccess, IRField


class NonAffineIndexMapError(ValueError):
    """An ``index_map`` is not an affine function of the grid coordinates.

    Structured: ``kernel`` / ``operand`` name the offending config and access,
    ``point`` is the failing probe (a concrete grid coordinate), ``want`` /
    ``got`` the predicted vs actual block index there.  The message is the
    rendering of :attr:`finding`, so trace-time diagnostics read exactly like
    lint-time ones (``repro_torch.analysis``).
    """

    def __init__(
        self,
        message: str,
        *,
        kernel: str | None = None,
        operand: str | None = None,
        point: tuple[int, ...] | None = None,
        want: tuple[int, ...] | None = None,
        got: tuple[int, ...] | None = None,
    ):
        self.kernel = kernel
        self.operand = operand
        self.point = point
        self.want = want
        self.got = got
        super().__init__(self._render(message))

    def _render(self, message: str) -> str:
        self.finding = self._finding(message)
        return self.finding.render()

    def _finding(self, message: str):
        # lazy import: analysis.passes imports frontend.ir, so this module
        # must not import analysis at module scope
        from ..analysis.findings import Finding

        return Finding(
            rule="trace.non_affine",
            severity="error",
            field=self.operand,
            message=message,
            witness=() if self.point is None else (self.point,),
            address=self.got,
            suggestion=(
                "only affine index maps have an exact AccessIR form; rewrite "
                "the map (e.g. model clamped boundaries with an interior "
                "representative block) or estimate it out-of-band"
            ),
        )


def _context(kernel: str | None, operand: str | None, where: str) -> str:
    if operand is not None:
        return f"{kernel}.{operand}" if kernel else operand
    return where


def _probe(
    index_map, point, where: str, kernel: str | None = None, operand: str | None = None
) -> tuple[int, ...]:
    obs_metrics.counter("pallas.probes").inc()
    try:
        out = index_map(*point)
    except Exception as e:  # pragma: no cover - defensive
        raise NonAffineIndexMapError(
            f"{_context(kernel, operand, where)}: index_map raised {e!r} when "
            f"probed at grid point {point}",
            kernel=kernel,
            operand=operand,
            point=point,
        ) from e
    if not isinstance(out, tuple):
        out = (out,)
    return tuple(int(v) for v in out)


def _verification_points(grid: tuple[int, ...]) -> list[tuple[int, ...]]:
    """In-domain probe points beyond origin + unit steps."""
    dims = len(grid)
    pts: list[tuple[int, ...]] = []
    for d in range(dims):
        if grid[d] >= 3:  # double unit step: catches curvature along one dim
            pts.append(tuple(2 if j == d else 0 for j in range(dims)))
    # mixed point: catches cross terms between dims
    pts.append(tuple(min(1, g - 1) for g in grid))
    # far corner: catches boundary clamping anywhere in the domain
    pts.append(tuple(g - 1 for g in grid))
    return pts


def trace_index_map(
    index_map,
    grid: tuple[int, ...],
    where: str = "index_map",
    *,
    kernel: str | None = None,
    operand: str | None = None,
) -> tuple[tuple[tuple[int, ...], ...], tuple[int, ...]]:
    """Recover ``(matrix, offset)`` with ``out = matrix @ coords + offset``.

    Raises :class:`NonAffineIndexMapError` when the closure disagrees with the
    recovered affine map at any verification probe; ``kernel``/``operand``
    give the error provenance (the config and access being traced) — ``where``
    is the fallback context string for anonymous maps.
    """
    dims = len(grid)
    ctx = _context(kernel, operand, where)
    origin = (0,) * dims
    offset = _probe(index_map, origin, where, kernel, operand)
    n_out = len(offset)
    cols: list[tuple[int, ...]] = []
    for d in range(dims):
        if grid[d] >= 2:
            pt = tuple(1 if j == d else 0 for j in range(dims))
            step = _probe(index_map, pt, where, kernel, operand)
            if len(step) != n_out:
                raise NonAffineIndexMapError(
                    f"{ctx}: output rank changed between probes "
                    f"({n_out} at origin, {len(step)} at unit step {d})",
                    kernel=kernel,
                    operand=operand,
                    point=pt,
                    got=step,
                )
            cols.append(tuple(step[o] - offset[o] for o in range(n_out)))
        else:
            cols.append((0,) * n_out)  # extent-1 dim: step unobservable
    matrix = tuple(tuple(cols[d][o] for d in range(dims)) for o in range(n_out))
    seen = {origin} | {
        tuple(1 if j == d else 0 for j in range(dims))
        for d in range(dims)
        if grid[d] >= 2
    }
    for pt in _verification_points(grid):
        if pt in seen:
            continue
        seen.add(pt)
        want = tuple(
            offset[o] + sum(matrix[o][d] * pt[d] for d in range(dims))
            for o in range(n_out)
        )
        got = _probe(index_map, pt, where, kernel, operand)
        if got != want:
            raise NonAffineIndexMapError(
                f"{ctx}: not affine over the grid {grid} — the origin/unit-"
                f"step probes predict {want} at grid point {pt}, but the map "
                f"returns {got}",
                kernel=kernel,
                operand=operand,
                point=pt,
                want=want,
                got=got,
            )
    return matrix, offset


def trace_pallas(cfg) -> AccessIR:
    """AccessIR of a :class:`~repro_torch.core.tpu_estimator.PallasConfig`.

    ``cfg`` is duck-typed (``name, grid, accesses, flops_per_step, is_matmul,
    scratch_bytes, meta`` with per-access ``name, block_shape, index_map,
    dtype_bits, is_output``) so this module stays import-independent of the
    estimator it feeds.
    """
    grid = tuple(int(g) for g in cfg.grid)
    fields: list[IRField] = []
    accesses: list[IRAccess] = []
    seen: set[str] = set()
    probes_before = obs_metrics.counter("pallas.probes").value
    for acc in cfg.accesses:
        if acc.name in seen:
            raise ValueError(
                f"config {cfg.name!r}: duplicate operand name {acc.name!r} — "
                "operands need unique names to be addressable in the IR"
            )
        seen.add(acc.name)
        tile = tuple(int(b) for b in acc.block_shape)
        matrix, offset = trace_index_map(
            acc.index_map, grid, kernel=cfg.name, operand=acc.name
        )
        if len(matrix) != len(tile):
            raise ValueError(
                f"config {cfg.name!r}, operand {acc.name!r}: index_map returns "
                f"{len(matrix)} block coordinates but block_shape has rank "
                f"{len(tile)}"
            )
        fields.append(
            IRField(name=acc.name, shape=tile, dtype_bits=acc.dtype_bits)
        )
        accesses.append(
            IRAccess(
                field=acc.name,
                coeffs=matrix,
                offset=offset,
                tile=tile,
                is_store=acc.is_output,
            )
        )
    obs_metrics.histogram("pallas.probes_per_trace").observe(
        obs_metrics.counter("pallas.probes").value - probes_before
    )
    return AccessIR(
        name=cfg.name,
        fields=tuple(fields),
        accesses=tuple(accesses),
        iter_shape=grid,
        block=(),
        flops_per_iter=cfg.flops_per_step,
        is_matmul=cfg.is_matmul,
        scratch_bytes=cfg.scratch_bytes,
        meta=dict(cfg.meta),
    )
