"""Configuration ranking primitives (paper §I.A, §IV.H).

Counterpart of ``repro.core.ranking``.  The code generator enumerates
candidate configurations; the estimator and the model rank them, in place
of the generate, compile and benchmark cycle of autotuning.

:class:`RankedConfig`, :func:`top_k`, :func:`kendall_tau` and
:func:`spearman_rho` are copies.  The JAX package's :func:`rank_configs`
delegates to its exploration ``Study``, which the port does not have; here
it runs the batched estimator (:func:`~repro_torch.core.estimator.estimate_many`)
and the model directly, and sorts as that ``Study`` sorts GPU records: by
the canonical AccessIR fingerprint descending, then stably by predicted
GLup/s descending.  ``tests/test_torch_ranking.py`` holds the result equal
to the JAX function's, element for element.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .address import KernelSpec
from .capacity import CapacityFits
from .estimator import VolumeEstimate, estimate_many
from .machine import V100, GPUMachine
from .model import Prediction, predict


@dataclass
class RankedConfig:
    config: dict
    estimate: VolumeEstimate
    prediction: Prediction

    @property
    def glups(self) -> float:
        return self.prediction.glups


def rank_configs(
    build: Callable[..., KernelSpec],
    configs: Sequence[dict],
    machine: GPUMachine = V100,
    fits: CapacityFits | None = None,
    method: str = "sym",
) -> list[RankedConfig]:
    """Estimate and predict every configuration; return them best-first.

    Ties in predicted GLup/s keep the order of the descending IR
    fingerprint of the built spec (``frontend.lower.from_kernel_spec``),
    so the order never depends on how the configurations were listed.
    ``fits=None`` uses ``machine.fits``.
    """
    from ..frontend.ir import ir_fingerprint  # deferred: the frontend imports core
    from ..frontend.lower import from_kernel_spec

    specs = [build(**cfg) for cfg in configs]
    ests = estimate_many(specs, machine, fits, method=method)
    keyed = [
        (ir_fingerprint(from_kernel_spec(spec)),
         RankedConfig(config=dict(cfg), estimate=est, prediction=predict(spec, est, machine)))
        for cfg, spec, est in zip(configs, specs, ests)
    ]
    keyed.sort(key=lambda item: item[0], reverse=True)
    keyed.sort(key=lambda item: -item[1].glups)  # stable: ties keep fingerprint order
    return [rc for _, rc in keyed]


def top_k(ranked: Sequence[RankedConfig], k: int = 5) -> list[RankedConfig]:
    return list(ranked[:k])


def kendall_tau(a: Sequence[float], b: Sequence[float]) -> float:
    """Kendall rank correlation (no scipy offline). O(n^2), fine for <=few hundred."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = a.size
    assert b.size == n
    if n < 2:
        return 1.0
    da = np.sign(a[:, None] - a[None, :])
    db = np.sign(b[:, None] - b[None, :])
    iu = np.triu_indices(n, k=1)
    prod = da[iu] * db[iu]
    concordant = (prod > 0).sum()
    discordant = (prod < 0).sum()
    denom = concordant + discordant
    return float((concordant - discordant) / denom) if denom else 1.0


def spearman_rho(a: Sequence[float], b: Sequence[float]) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert b.size == a.size
    if a.size < 2:
        return 1.0  # vacuous ordering, same convention as kendall_tau
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / denom) if denom else 1.0
