"""Kernel + machine registry for the exploration engine: a copy of
``repro.explore.registry``.

Every explorable kernel is one *family* (``stencil25``, ``lbm_d3q15``,
``attention``, ``wkv``) with one :class:`KernelEntry` per estimation backend:

* **gpu** — the entry declares an IR-producing builder
  (``build_ir: (**config) -> AccessIR``); the engine lowers the IR through
  :func:`repro_torch.frontend.lower.lower_gpu` into the paper §III pipeline and keys
  its store on the canonical IR fingerprint.
* **tpu** — the entry declares a PallasConfig space factory; the engine traces
  each config to the same AccessIR (:func:`repro_torch.frontend.pallas.trace_pallas`)
  for the Pallas adaptation (``core.tpu_estimator.estimate_ir``).

:func:`get_kernel` resolves either an exact entry name or a family + backend
(``get_kernel("attention", backend="tpu")`` -> the ``attention_tpu`` entry),
which is what the CLI's ``--backend`` flag uses.  TPU spaces are built lazily
(``kernels/<name>/ops.tpu_config_space``, the JAX package's Pallas tile
spaces), so importing the registry (e.g. inside process-pool workers) does
not pull in torch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core import appspec
from ..core.machine import (
    MACHINES,
    canonical_machine_name,
    get_machine,
)
from ..core.suggest import unknown_name_message
from ..frontend.builders import attention_gpu_ir, wkv_gpu_ir
from ..frontend.lower import lower_gpu
from .space import SearchSpace, choice, exact_volume, pow2, predicate

__all__ = [
    "ESTIMATORS",
    "KERNELS",
    "MACHINES",
    "KernelEntry",
    "canonical_machine_name",
    "get_estimator",
    "get_kernel",
    "get_machine",
]


def _make_gpu_estimator(method: str = "sym", fits=None):
    from ..core.estimator import GPUAnalyticEstimator

    return GPUAnalyticEstimator(method=method, fits=fits)


def _make_tpu_estimator(method: str = "tpu", fits=None):
    # fits/method are GPU capacity-model concepts; the Pallas model has one
    # deterministic method and a hard VMEM gate, so both are ignored here
    from ..core.tpu_estimator import TPUPallasEstimator

    return TPUPallasEstimator()


# backend name -> Estimator factory (lazy imports keep pool workers light).
# Adding a backend = implementing core.record.Estimator + registering it here
# (plus KernelEntry rows for the kernels it can estimate) — the Study facade,
# store schema and CLI need no changes.
ESTIMATORS: dict[str, Callable] = {
    "gpu": _make_gpu_estimator,
    "tpu": _make_tpu_estimator,
}


def get_estimator(backend: str, method: str | None = None, fits=None):
    """Resolve a backend name to a fresh :class:`~repro_torch.core.record.Estimator`."""
    factory = ESTIMATORS.get(backend)
    if factory is None:
        raise KeyError(unknown_name_message("backend", backend, ESTIMATORS))
    kwargs = {} if method is None else {"method": method}
    return factory(fits=fits, **kwargs)


def _block_fold_space(total_threads: int, zmax: int, folds) -> SearchSpace:
    """The paper §IV.B space: pow2 block dims, fixed thread count, fold variants."""
    return SearchSpace(
        axes=(
            pow2("bx", 1, 512),
            pow2("by", 1, 512),
            pow2("bz", 1, zmax),
            choice("fold", tuple(folds)),
        ),
        constraints=(exact_volume(("bx", "by", "bz"), total_threads),),
        assemble=lambda raw: {
            "block": (raw["bx"], raw["by"], raw["bz"]),
            "fold": raw["fold"],
        },
    )


def stencil25_space() -> SearchSpace:
    """162 configs: 54 pow2 block shapes (1024 threads) x {none, 2y, 2z} folding."""
    return _block_fold_space(1024, 64, [(1, 1, 1), (1, 2, 1), (1, 1, 2)])


def stencil25_wide_space() -> SearchSpace:
    """2160 configs: the *wide* stencil space for search smoke tests and benches.

    Relaxes the paper's fixed 1024-thread constraint to {128, 256, 512, 1024}
    (180 pow2 block shapes) and widens folding to 12 variants.  Too large to
    sweep exhaustively in CI — the point: :class:`~repro_torch.explore.search.
    SuccessiveHalving` must find the good region on a budget.
    """
    folds = (
        (1, 1, 1), (1, 2, 1), (1, 1, 2), (1, 2, 2),
        (1, 4, 1), (1, 1, 4), (1, 4, 2), (1, 2, 4),
        (2, 1, 1), (2, 2, 1), (2, 1, 2), (1, 4, 4),
    )
    return SearchSpace(
        axes=(
            pow2("bx", 1, 512),
            pow2("by", 1, 512),
            pow2("bz", 1, 64),
            choice("fold", folds),
        ),
        constraints=(
            predicate(
                "block volume not in {128, 256, 512, 1024}",
                lambda c: c["bx"] * c["by"] * c["bz"] in (128, 256, 512, 1024),
            ),
        ),
        assemble=lambda raw: {
            "block": (raw["bx"], raw["by"], raw["bz"]),
            "fold": raw["fold"],
        },
    )


def lbm_d3q15_space() -> SearchSpace:
    """49 configs: pow2 block shapes at 512 threads (register limited), no folding."""
    return _block_fold_space(512, 64, [(1, 1, 1)])


def attention_gpu_space() -> SearchSpace:
    """19 configs: pow2 (bx, by) score-space tiles at 256 or 512 threads."""
    return SearchSpace(
        axes=(pow2("bx", 1, 512), pow2("by", 1, 512)),
        constraints=(
            predicate(
                "block volume not in {256, 512}",
                lambda c: c["bx"] * c["by"] in (256, 512),
            ),
        ),
        assemble=lambda raw: {"block": (raw["bx"], raw["by"], 1)},
    )


def wkv_gpu_space() -> SearchSpace:
    """25 configs: chunk length x pow2 (bx, by) intra-chunk tiles (256 threads)."""
    return SearchSpace(
        axes=(
            choice("chunk", (16, 32, 64, 128, 256)),
            pow2("bx", 1, 256),
            pow2("by", 1, 256),
        ),
        constraints=(
            exact_volume(("bx", "by"), 256),
            predicate(
                "block tile exceeds chunk",
                lambda c: c["bx"] <= c["chunk"] and c["by"] <= c["chunk"],
            ),
        ),
        assemble=lambda raw: {
            "block": (raw["bx"], raw["by"], 1),
            "chunk": raw["chunk"],
        },
    )


def _tpu_stencil_configs():
    from ..kernels.stencil25.ops import tpu_config_space

    return tpu_config_space((256, 256, 512), r=4, dtype_bits=32)


def _tpu_attention_configs():
    from ..kernels.attention.ops import tpu_config_space

    return tpu_config_space(4, 32, 8, 8192, 128, 16)


def _tpu_wkv_configs():
    from ..kernels.wkv.ops import tpu_config_space

    return tpu_config_space(64, 4096, 64)


def _tpu_lbm_configs():
    from ..kernels.lbm_d3q15.ops import tpu_config_space

    return tpu_config_space((128, 128, 128), dtype_bits=32)


@dataclass(frozen=True)
class KernelEntry:
    """One explorable (kernel family, backend) pair.

    GPU entries declare ``build_ir``; ``build`` (the picklable-by-name spec
    builder the engine and its pool workers call) is derived as
    ``lower_gpu(build_ir(**cfg))``.  TPU entries declare ``tpu_configs``.
    """

    name: str
    family: str
    backend: str  # "gpu" (paper §III estimator) | "tpu" (Pallas adaptation)
    describe: str
    build_ir: Callable[..., object] | None = None  # gpu: (**cfg) -> AccessIR
    space: Callable[[], SearchSpace] | None = None  # gpu: default search space
    wide_space: Callable[[], SearchSpace] | None = None  # gpu: search-scale space
    tpu_configs: Callable[[], list] | None = None  # tpu: PallasConfig list
    default_machine: str = "V100"

    @property
    def build(self) -> Callable[..., object] | None:
        """GPU spec builder ``(**cfg) -> KernelSpec`` (lowered from the IR)."""
        build_ir = self.build_ir
        if build_ir is None:
            return None

        def _build(**cfg):
            return lower_gpu(build_ir(**cfg))

        _build.__name__ = _build.__qualname__ = f"{self.name}__build"
        return _build


KERNELS: dict[str, KernelEntry] = {
    "stencil25": KernelEntry(
        name="stencil25",
        family="stencil25",
        backend="gpu",
        describe="range-4 3D25pt star stencil, V100 (paper §IV.C / Fig 17)",
        build_ir=appspec.star3d_ir,
        space=stencil25_space,
        wide_space=stencil25_wide_space,
        default_machine="V100",
    ),
    "lbm_d3q15": KernelEntry(
        name="lbm_d3q15",
        family="lbm_d3q15",
        backend="gpu",
        describe="D3Q15 Allen-Cahn LBM kernel, V100 (paper §IV.D / Fig 18)",
        build_ir=appspec.lbm_d3q15_ir,
        space=lbm_d3q15_space,
        default_machine="V100",
    ),
    "attention": KernelEntry(
        name="attention",
        family="attention",
        backend="gpu",
        describe="naive MHA attention score-space pass, GPU §III pipeline",
        build_ir=attention_gpu_ir,
        space=attention_gpu_space,
        default_machine="A100",
    ),
    "wkv": KernelEntry(
        name="wkv",
        family="wkv",
        backend="gpu",
        describe="chunked WKV intra-chunk pass (chunk x block space), GPU §III pipeline",
        build_ir=wkv_gpu_ir,
        space=wkv_gpu_space,
        default_machine="A100",
    ),
    "stencil25_tpu": KernelEntry(
        name="stencil25_tpu",
        family="stencil25",
        backend="tpu",
        describe="stencil25 Pallas block-shape space on TPU v5e",
        tpu_configs=_tpu_stencil_configs,
        default_machine="TPUv5e",
    ),
    "lbm_d3q15_tpu": KernelEntry(
        name="lbm_d3q15_tpu",
        family="lbm_d3q15",
        backend="tpu",
        describe="LBM D3Q15 Pallas block space on TPU v5e",
        tpu_configs=_tpu_lbm_configs,
        default_machine="TPUv5e",
    ),
    "attention_tpu": KernelEntry(
        name="attention_tpu",
        family="attention",
        backend="tpu",
        describe="flash-attention Pallas (block_q, block_kv) space on TPU v5e",
        tpu_configs=_tpu_attention_configs,
        default_machine="TPUv5e",
    ),
    "wkv_tpu": KernelEntry(
        name="wkv_tpu",
        family="wkv",
        backend="tpu",
        describe="chunked WKV Pallas chunk-length space on TPU v5e",
        tpu_configs=_tpu_wkv_configs,
        default_machine="TPUv5e",
    ),
}


def get_kernel(name: str, backend: str | None = None) -> KernelEntry:
    """Resolve an entry by exact name, or by family + requested backend."""
    entry = KERNELS.get(name)
    if entry is None:
        raise KeyError(unknown_name_message("kernel", name, KERNELS))
    if backend is None or entry.backend == backend:
        return entry
    for other in KERNELS.values():
        if other.family == entry.family and other.backend == backend:
            return other
    raise KeyError(
        f"kernel family {entry.family!r} has no {backend!r} backend entry "
        f"(available: {sorted(e.name for e in KERNELS.values() if e.family == entry.family)})"
    )
