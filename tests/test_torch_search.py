"""The port's budget-aware search (``repro_torch.explore.search``) held `==`
to the JAX package's: the same ``SearchStats`` (pool, rungs, budget
accounting, the order of full evaluations) and the same records on every
machine, with and without ``LocalSearch``, on the wide stencil space
(sampled lazily, as a search of a space too large to enumerate does) and on
the paper space, across two machines; the convergence metrics; a search
through a store that the JAX package's search warmed; and the CLI's
``search --json``.
"""
from __future__ import annotations

import dataclasses
import json

import pytest

import repro.explore as jx
import repro.explore.search as jsearch
import repro_torch.explore as tx
import repro_torch.explore.search as tsearch
from repro.explore import cli as jcli
from repro.explore import registry as jreg
from repro_torch.explore import cli as tcli
from repro_torch.explore import registry as treg
from test_torch_explore import rec_tuple

CASES = {
    "wide": dict(space="stencil25_wide_space", machines=["v100", "a100"],
                 search=dict(budget=24, sample=400, seed=0)),
    "wide_local": dict(space="stencil25_wide_space", machines=["a100", "h100"],
                       search=dict(budget=24, sample=400, seed=3, propose=2)),
    "wide_classic": dict(space="stencil25_wide_space", machines=["h100", "v100"],
                         search=dict(budget=16, eta=2, screen=False, sample=250, seed=1,
                                     stratified=False)),
    "paper": dict(space=None, machines=["h100", "a100"], search=dict(budget=54, seed=0, propose=1)),
}


def _run(pkg, case: dict, stores=None):
    explore, search, reg = (tx, tsearch, treg) if pkg == "port" else (jx, jsearch, jreg)
    kw = dict(case["search"])
    rounds = kw.pop("propose", 0)
    if rounds:
        kw["proposer"] = search.LocalSearch(rounds=rounds)
    space = getattr(reg, case["space"])() if case["space"] else None
    study = explore.Study("stencil25", space, machines=case["machines"], stores=stores)
    return study.run(search=search.SuccessiveHalving(**kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_equals_jax(case):
    got, want = _run("port", CASES[case]), _run("jax", CASES[case])
    assert dataclasses.asdict(got.search_stats) == dataclasses.asdict(want.search_stats)
    assert got.search_stats.summary() == want.search_stats.summary()
    assert got.machines == want.machines
    for m in got.machines:
        g, w = got.result(m), want.result(m)
        assert [rec_tuple(r) for r in g.records] == [rec_tuple(r) for r in w.records]
        assert (g.stats.candidates, g.stats.evaluated, g.stats.cache_hits) == (
            w.stats.candidates, w.stats.evaluated, w.stats.cache_hits)
    s = got.search_stats
    assert s.full_selected <= s.budget and len(got.result(got.machines[0]).records) == s.full_selected
    if case == "wide_local":
        assert s.proposed > 0 and s.promoted > 0


def test_searched_records_equal_the_exhaustive_run_and_recall_equals_jax():
    case = CASES["paper"]
    got = _run("port", case)
    truth = tx.Study("stencil25", machines=case["machines"]).run()
    jtruth = jx.Study("stencil25", machines=case["machines"]).run()
    primary = case["machines"][0]
    by_cfg = {json.dumps(r.config, default=list): rec_tuple(r) for r in truth.result(primary).records}
    for r in got.result(primary).records:
        assert rec_tuple(r) == by_cfg[json.dumps(r.config, default=list)]
    front, jfront = truth.result(primary).pareto(), jtruth.result(primary).pareto()
    assert [rec_tuple(r) for r in front] == [rec_tuple(r) for r in jfront]
    found = got.result(primary).records
    assert tsearch.pareto_recall(found, front) == jsearch.pareto_recall(found, jfront)
    keys = got.search_stats.full_keys
    assert tsearch.recall_curve(keys, front) == jsearch.recall_curve(keys, jfront)
    curve = tsearch.recall_curve(keys, front)
    assert tsearch.evaluations_to_recall(curve, 0.5) == jsearch.evaluations_to_recall(curve, 0.5)
    assert [tsearch.config_key(r) for r in found] == [jsearch.config_key(r) for r in found]
    assert tsearch.pareto_recall([], []) == 1.0
    for bad in (dict(budget=0), dict(budget=4, eta=1), dict(budget=4, proxy_method="x")):
        with pytest.raises(ValueError):
            tsearch.SuccessiveHalving(**bad)


def test_search_through_a_store_the_jax_search_warmed(tmp_path):
    case = CASES["wide"]
    stores = {m: tmp_path / f"{m}.jsonl" for m in case["machines"]}
    cold = _run("jax", case, stores={m: str(p) for m, p in stores.items()})
    warm = _run("port", case, stores={m: str(p) for m, p in stores.items()})
    s = warm.search_stats
    assert s.full_cache_hits == s.full_selected == cold.search_stats.full_selected
    primary = case["machines"][0]
    assert [rec_tuple(r)[:-2] for r in warm.result(primary).records] == [
        rec_tuple(r)[:-2] for r in cold.result(primary).records]
    assert all(r.from_cache for r in warm.result(primary).records)


@pytest.mark.parametrize("extra", [
    ["--machines", "a100,h100", "--budget", "18", "--propose", "1"],
    ["--machine", "v100", "--budget", "30", "--recall", "--no-screen"],
    ["--wide", "--sample", "300", "--machine", "h100", "--budget", "12", "--no-proxy"],
], ids=lambda a: " ".join(a[:4]))
def test_cli_search_json_equals_the_jax_cli(extra, tmp_path, monkeypatch, capsys):
    outs = []
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        rc = main(["search", "--kernel", "stencil25", "--json", *extra])
        out = capsys.readouterr()
        assert rc == 0, out.err
        doc = json.loads(out.out)
        doc.pop("wall_s")
        outs.append(doc)
    assert outs[1] == outs[0]
    assert outs[1]["search"]["full_selected"] <= int(extra[extra.index("--budget") + 1])
