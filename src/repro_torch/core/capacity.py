"""Capacity-miss models (paper §III.E, §III.G).

The portion of redundant accesses that miss, R_cap = V_cap / V_red, is modeled as a
Gompertz sigmoid of the oversubscription factor O = V_alloc / V_cache::

    R(O) = a * exp(-b * exp(-c * O))

(The paper's Eq. 6 prints O = V_cache/V_alloc, but its surrounding text — "for an
oversubscription factor less than one, there is enough cache capacity for the
complete footprint and R_cap should be zero" — fixes the intended definition as
allocation/capacity; we use that.)

For the DRAM↔L2 wave-overlap reuse, the miss ratio of the *overlapping* volume is a
decreasing sigmoid of the coverage factor C (paper Eq. 8)::

    R_overmiss(C) = a * exp(-b * exp(-c * (1 - C)))

Default parameters are calibrated against the deterministic cache simulator
(`core/exactcount.py`), which plays the role of the paper's performance-counter
measurements; `fit()` re-fits them from (x, y) samples with a coarse-to-fine grid
search (no scipy available).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Sigmoid:
    """R(x) = a * exp(-b * exp(-c * (x - x0)))."""

    a: float
    b: float
    c: float
    x0: float = 0.0

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        # far-tail inputs overflow the inner exp; exp(-inf) == 0 is the exact
        # limit value, so the result is right — only the warning is noise
        with np.errstate(over="ignore"):
            out = self.a * np.exp(-self.b * np.exp(-self.c * (x - self.x0)))
        return float(out) if out.ndim == 0 else out


@dataclass(frozen=True)
class CapacityModel:
    """R_cap as a function of oversubscription O = V_alloc / V_cache."""

    sig: Sigmoid

    def __call__(self, oversubscription: float) -> float:
        if oversubscription <= 1.0:
            # enough capacity for the complete footprint -> no capacity misses
            return 0.0
        return min(1.0, float(self.sig(oversubscription)))


@dataclass(frozen=True)
class OverlapMissModel:
    """R_overmiss as a decreasing function of the coverage factor C (paper Eq. 8).

    C >= 1: the previous wave's footprint still fits beside the current one -> ~0.
    C -> -inf (current wave alone overflows L2) -> -> a (overlap almost all misses).
    """

    sig: Sigmoid

    def __call__(self, coverage: float) -> float:
        return min(1.0, float(self.sig(1.0 - coverage)))


# Defaults calibrated against core/exactcount.py LRU simulation (see
# benchmarks/paper_capacity_fit.py); shapes match paper Figs 9-12.
DEFAULT_L1_CAP = CapacityModel(Sigmoid(a=0.95, b=20.0, c=2.0))
DEFAULT_L2_LOAD_CAP = CapacityModel(Sigmoid(a=0.90, b=16.0, c=1.6))
DEFAULT_L2_STORE_CAP = CapacityModel(Sigmoid(a=0.90, b=16.0, c=1.6))
DEFAULT_OVERMISS = OverlapMissModel(Sigmoid(a=0.95, b=3.0, c=2.5))


@dataclass(frozen=True)
class CapacityFits:
    l1: CapacityModel = DEFAULT_L1_CAP
    l2_load: CapacityModel = DEFAULT_L2_LOAD_CAP
    l2_store: CapacityModel = DEFAULT_L2_STORE_CAP
    overmiss: OverlapMissModel = DEFAULT_OVERMISS


DEFAULT_FITS = CapacityFits()

# Per-architecture calibrations.  R_cap is a function of the oversubscription
# *factor* O = V_alloc/V_cache, which already normalizes out absolute cache
# size, so the V100-calibrated sigmoid parameters transfer as the initial
# calibration for Ampere/Hopper (arXiv:2204.14242 re-fits the same functional
# family on A100 and lands near the Volta shape).  Each machine carries its own
# CapacityFits instance (`GPUMachine.fits`) so a per-architecture re-fit
# (`fit_sigmoid` against core/exactcount.py) changes one constant here without
# touching any call site — and the exploration cache keys fingerprint the fit
# parameters AND the full machine constants, so re-calibrated or re-measured
# machines never alias stale cache entries.
V100_FITS = DEFAULT_FITS
A100_FITS = CapacityFits()
H100_FITS = CapacityFits()


def fit_sigmoid(
    x: np.ndarray,
    y: np.ndarray,
    a_grid=None,
    b_grid=None,
    c_grid=None,
    refine: int = 2,
) -> Sigmoid:
    """Least-squares Gompertz fit via coarse-to-fine grid search (no scipy)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    a_grid = np.linspace(0.2, 1.0, 9) if a_grid is None else np.asarray(a_grid)
    b_grid = np.geomspace(0.5, 64.0, 17) if b_grid is None else np.asarray(b_grid)
    c_grid = np.geomspace(0.1, 8.0, 17) if c_grid is None else np.asarray(c_grid)
    best = (np.inf, Sigmoid(0.9, 8.0, 1.0))
    for _ in range(refine + 1):
        for a in a_grid:
            # vectorize over b, c
            for b in b_grid:
                pred = a * np.exp(-b * np.exp(-np.outer(c_grid, x)))
                err = ((pred - y[None, :]) ** 2).sum(axis=1)
                k = int(np.argmin(err))
                if err[k] < best[0]:
                    best = (float(err[k]), Sigmoid(float(a), float(b), float(c_grid[k])))
        s = best[1]
        a_grid = np.linspace(max(0.05, s.a * 0.8), min(1.0, s.a * 1.2), 7)
        b_grid = np.geomspace(max(1e-2, s.b * 0.5), s.b * 2.0, 9)
        c_grid = np.geomspace(max(1e-2, s.c * 0.5), s.c * 2.0, 9)
    return best[1]
