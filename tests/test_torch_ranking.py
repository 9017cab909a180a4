"""The port's ranking primitives (``repro_torch.core.ranking``) against
``repro.core.ranking``, and the pure helpers of the rank check
(``benchmarks/torch_rank_check.py``) on synthetic times.

``kendall_tau`` and ``spearman_rho`` must equal the JAX package's with
``==`` on seeded numpy arrays, ties included.  ``rank_configs`` runs the
batched estimator directly where the JAX function goes through its
``Study``; the two lists must agree element for element, in order (ties in
predicted GLup/s ordered by the descending IR fingerprint).
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import appspec as j_appspec
from repro.core import machine as j_machine
from repro.core import ranking as j_ranking
from repro_torch.core import appspec, ranking
from repro_torch.core.machine import H100_SXM

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import torch_rank_check as rank_check  # noqa: E402

STENCIL_GRID = (640, 512, 512)
LBM_GRID = (512, 256, 256)


def _pair(seed: int, n: int, ties: bool) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = a + rng.normal(scale=0.7, size=n)
    if ties:  # few distinct values: many tied pairs on both sides
        a, b = np.round(a), np.round(b * 2) / 2
    return a, b


@pytest.mark.parametrize("n", [0, 1, 2, 200])
@pytest.mark.parametrize("ties", [False, True])
def test_rank_correlations_equal_jax(n, ties):
    a, b = _pair(n + 7 * ties, n, ties)
    assert ranking.kendall_tau(a, b) == j_ranking.kendall_tau(a, b)
    assert ranking.spearman_rho(a, b) == j_ranking.spearman_rho(a, b)
    assert ranking.kendall_tau(a, -b) == j_ranking.kendall_tau(a, -b)
    assert ranking.spearman_rho(list(a), list(b)) == j_ranking.spearman_rho(list(a), list(b))


def test_rank_correlations_of_constant_and_reversed_orders():
    up = np.arange(10.0)
    assert ranking.kendall_tau(up, up) == 1.0 and ranking.kendall_tau(up, -up) == -1.0
    assert ranking.spearman_rho(up, -up) == -1.0
    assert ranking.kendall_tau(up, np.ones(10)) == j_ranking.kendall_tau(up, np.ones(10)) == 1.0
    assert ranking.spearman_rho(np.ones(10), up) == j_ranking.spearman_rho(np.ones(10), up)


def _assert_same_ranking(port, jax_side):
    assert len(port) == len(jax_side)
    for p, j in zip(port, jax_side):
        assert p.config == j.config
        assert dataclasses.asdict(p.estimate) == dataclasses.asdict(j.estimate), p.config
        assert dataclasses.astuple(p.prediction) == dataclasses.astuple(j.prediction), p.config
        assert p.glups == j.glups


@pytest.mark.parametrize("stride", [2, 3])
def test_stencil_rank_configs_equal_jax_in_order(stride):
    cfgs = [dict(c, grid=STENCIL_GRID) for c in appspec.stencil_config_space()[::stride]]
    port = ranking.rank_configs(appspec.star3d, cfgs, H100_SXM)
    jax_side = j_ranking.rank_configs(j_appspec.star3d, cfgs, j_machine.H100_SXM)
    _assert_same_ranking(port, jax_side)
    glups = [r.glups for r in port]
    assert glups == sorted(glups, reverse=True)
    assert len(set(glups)) < len(glups)  # ties are real here: the fingerprint orders them
    assert ranking.top_k(port, 3) == port[:3]


def test_lbm_rank_configs_equal_jax_in_order():
    cfgs = [dict(c, grid=LBM_GRID) for c in appspec.lbm_config_space()]
    port = ranking.rank_configs(appspec.lbm_d3q15, cfgs, H100_SXM)
    _assert_same_ranking(port, j_ranking.rank_configs(j_appspec.lbm_d3q15, cfgs, j_machine.H100_SXM))


# --- the rank check's pure helpers --------------------------------------------

def test_best_first_breaks_ties_by_list_order():
    assert rank_check.best_first([1.0, 3.0, 2.0, 3.0]) == [1, 3, 2, 0]
    assert rank_check.best_first([]) == []


def test_measured_rank_counts_the_strictly_faster():
    ms = [2.0, 1.0, 3.0, 1.0]
    assert [rank_check.measured_rank(ms, i) for i in range(4)] == [3, 1, 4, 1]


def test_pick_over_best_and_top_overlap():
    ms = [2.0, 1.0, 4.0, 3.0, 8.0, 5.0, 6.0]
    assert rank_check.pick_over_best(ms, 0) == 2.0 and rank_check.pick_over_best(ms, 1) == 1.0
    predicted = [7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0]  # best first: 0 .. 6
    assert rank_check.top_overlap(predicted, ms, k=5) == 4  # measured top 5: 1, 0, 3, 2, 5
    assert rank_check.top_overlap(predicted, ms, k=2) == 2
    assert rank_check.top_overlap(predicted, ms[::-1], k=2) == 0


def test_summarize_on_synthetic_times():
    cells = 10**6
    predicted = [4.0, 3.0, 3.0, 1.0]
    # two passes a configuration: config 1 is fastest, the predicted winner 0 second
    passes = [[2.0, 2.2], [1.0, 1.2], [3.0, 2.8], [9.0, 9.0]]
    s = rank_check.summarize(predicted, passes, cells)
    assert s["configs"] == 4 and s["winner"] == 0 and s["fastest"] == 1
    assert s["winner_ms"] == pytest.approx(2.1) and s["fastest_ms"] == pytest.approx(1.1)
    assert s["winner_measured_rank"] == 2 and s["fastest_predicted_rank"] == 2
    assert s["pick_over_best"] == pytest.approx(2.1 / 1.1)
    assert s["winner_predicted_ties"] == 1 and s["top5_overlap"] == 4
    glups = [cells / np.mean(p) / 1e6 for p in passes]
    assert s["kendall_tau"] == ranking.kendall_tau(predicted, glups)
    assert s["spearman_rho"] == ranking.spearman_rho(predicted, glups)
    assert s["tau_noise"] == 1.0  # the two passes order the four alike


def test_summarize_reads_disagreeing_passes_as_noise():
    s = rank_check.summarize([2.0, 1.0], [[1.0, 2.0], [2.0, 1.0]], 10**6)
    assert s["tau_noise"] == -1.0 and s["winner_measured_rank"] == 1
