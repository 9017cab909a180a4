"""The port's static auditor (``repro_torch.analysis``) held `==` to the JAX
package's (``repro.analysis``), on the CPU.

* **fixtures:** every seeded-bug fixture gives the same ``Report``
  (``render()`` and ``to_json()``) in each correctness tier, and fires its
  ``EXPECTED_RULES`` rule;
* **the paper spaces:** all 211 configurations (162 stencil, 49 LBM) give
  the same reports on ``"h100"``, and every fourth one on ``"a100"`` and
  ``"v100"``; the four Pallas spaces' traced IRs give the same TPU lints on
  ``tpuv5e`` and ``tpuv6e``;
* **the tiers:** ``mode="enum"`` and ``"structured"`` each give the JAX
  package's findings on seeded random IRs (``tests/test_analysis.py``'s
  generator), and ``"auto"`` switches between them at the same 2^16
  iteration points;
* **the API:** ``validate_report_json``, ``LintError`` at each threshold,
  ``severity_at_least``, the numpy witness coercion and the ``lint.*``
  counters of the two caches;
* **the CLI:** ``lint`` prints ``tests/golden/lint_stencil25.txt`` (exit 0)
  and ``lint_fixture_racy_store.txt`` (exit 1) byte for byte, and its JSON
  output equals the JAX CLI's.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from repro import analysis as janalysis
from repro.analysis import findings as jfindings
from repro.analysis import passes as jpasses
from repro.explore import cli as jcli
from repro.explore import registry as jreg
from repro.frontend import ir as jir
from repro.frontend.pallas import trace_pallas as j_trace
from repro.obs import metrics as jmetrics
from repro_torch import analysis as tanalysis
from repro_torch.analysis import findings as tfindings
from repro_torch.analysis import passes as tpasses
from repro_torch.explore import cli as tcli
from repro_torch.explore import registry as treg
from repro_torch.frontend import ir as tir
from repro_torch.frontend.pallas import trace_pallas as t_trace
from repro_torch.obs import metrics as tmetrics

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "tests" / "golden"
LINT_GOLDENS = {  # tests/test_golden_lint.py's cases: file -> (exit code, argv)
    "lint_stencil25.txt": (0, ["lint", "--kernel", "stencil25",
                               "--config", '{"block": [32, 4, 8], "fold": [1, 1, 1]}', "--machine", "V100"]),
    "lint_fixture_racy_store.txt": (1, ["lint", "--fixture", "racy_store", "--machine", "V100"]),
}
PAPER_KERNELS = ("stencil25", "lbm_d3q15")
TPU_KERNELS = ("stencil25_tpu", "lbm_d3q15_tpu", "attention_tpu", "wkv_tpu")


def report_data(rep) -> tuple:
    return rep.render(), rep.to_json(), rep.counts, rep.ok("error"), rep.ok("warn")


def _paper_irs(kernel: str):
    """(port IR, JAX IR) of every configuration of a paper space."""
    t_entry, j_entry = treg.get_kernel(kernel), jreg.get_kernel(kernel)
    cfgs = j_entry.space().configs()
    assert t_entry.space().configs() == cfgs
    return [(t_entry.build_ir(**c), j_entry.build_ir(**c)) for c in cfgs]


# --------------------------------------------------------------------------- #
# fixtures
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(janalysis.FIXTURES))
def test_fixture_reports_equal_jax(name):
    assert sorted(tanalysis.FIXTURES) == sorted(janalysis.FIXTURES)
    assert tanalysis.EXPECTED_RULES == janalysis.EXPECTED_RULES
    ir, ref = tanalysis.FIXTURES[name](), janalysis.FIXTURES[name]()
    assert tir.ir_fingerprint(ir) == jir.ir_fingerprint(ref)
    modes = ("auto",) if ref.granularity == "block" else ("auto", "enum", "structured")
    for mode in modes:
        for machine in (None, "V100", "H100"):
            got = tanalysis.analyze_ir(ir, machine, cache=False, mode=mode)
            want = janalysis.analyze_ir(ref, machine, cache=False, mode=mode)
            assert report_data(got) == report_data(want), (mode, machine)
            assert tanalysis.EXPECTED_RULES[name] in {f.rule for f in got.findings}, (mode, machine)
            assert tanalysis.validate_report_json(json.loads(json.dumps(got.to_json()))) == []


# --------------------------------------------------------------------------- #
# the paper spaces and the Pallas spaces
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kernel", PAPER_KERNELS)
@pytest.mark.parametrize("machine, step", [("h100", 1), ("a100", 4), ("v100", 4)])
def test_paper_space_reports_equal_jax(kernel, machine, step):
    pairs = _paper_irs(kernel)[::step]
    for ir, ref in pairs:
        got = tanalysis.analyze_ir(ir, machine, cache=False)
        want = janalysis.analyze_ir(ref, machine, cache=False)
        assert report_data(got) == report_data(want), ir.meta
        assert got.ok("error")  # every configuration the port launches is free of errors
    assert len(pairs) == {"stencil25": 162, "lbm_d3q15": 49}[kernel] // step + (step > 1)


@pytest.mark.parametrize("kernel", TPU_KERNELS)
def test_pallas_space_lints_equal_jax(kernel):
    got_cfgs, want_cfgs = treg.get_kernel(kernel).tpu_configs(), jreg.get_kernel(kernel).tpu_configs()
    for machine in ("tpuv5e", "tpuv6e"):
        for c, r in zip(got_cfgs, want_cfgs, strict=True):
            got = tanalysis.analyze_ir(t_trace(c), machine, cache=False)
            want = janalysis.analyze_ir(j_trace(r), machine, cache=False)
            assert report_data(got) == report_data(want), (c.name, machine)
            assert got.granularity == "block"


# --------------------------------------------------------------------------- #
# the two correctness tiers
# --------------------------------------------------------------------------- #


def _random_ir(mod, rng: np.random.Generator):
    """``tests/test_analysis.py``'s ``random_ir``, for either package."""
    ndim = int(rng.integers(1, 3))
    iter_shape = tuple(int(v) for v in rng.integers(1, 7, size=ndim))
    nfields = int(rng.integers(1, 3))
    fields = tuple(mod.IRField(name=f"f{k}", shape=(int(rng.integers(4, 40)),)) for k in range(nfields))
    accesses = []
    for _ in range(int(rng.integers(1, 4))):
        f = fields[int(rng.integers(0, nfields))]
        row = tuple(int(v) for v in rng.integers(-3, 4, size=ndim))
        accesses.append(mod.IRAccess(field=f.name, coeffs=(row,), offset=(int(rng.integers(-4, 8)),),
                                     is_store=bool(rng.integers(0, 2))))
    return mod.AccessIR(name="rand", fields=fields, accesses=tuple(accesses),
                        iter_shape=iter_shape, block=iter_shape)


@pytest.mark.parametrize("mode", ["enum", "structured"])
@pytest.mark.parametrize("seed", range(2))
def test_tiers_equal_jax_on_random_irs(mode, seed):
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(60):
        ir, ref = _random_ir(tir, rng_t), _random_ir(jir, rng_j)
        got = tpasses.run_correctness_passes(ir, mode=mode)
        want = jpasses.run_correctness_passes(ref, mode=mode)
        assert [f.to_json() for f in got] == [f.to_json() for f in want], ref


def _skewed(mod, steps: int):
    """A 2-D IR of ``steps`` iteration points (256 × steps / 256) whose
    non-injective load x[i + j] overlaps its injective store x[i + 256 j]:
    enumeration finds the read-write race, the structured tier can only call
    it potential, so the two tiers' findings tell which one ran."""
    fields = (mod.IRField(name="x", shape=(steps + 4,)),)
    accesses = (mod.IRAccess(field="x", coeffs=((1, 256),), offset=(0,), is_store=True),
                mod.IRAccess(field="x", coeffs=((1, 1),), offset=(0,)))
    return mod.AccessIR(name="skewed", fields=fields, accesses=accesses, iter_shape=(256, steps // 256),
                        block=(256, 1))


def test_auto_switches_tiers_at_the_same_point():
    assert tpasses.ENUM_LIMIT == jpasses.ENUM_LIMIT == 1 << 16
    for steps in (tpasses.ENUM_LIMIT, tpasses.ENUM_LIMIT + 256):
        ir, ref = _skewed(tir, steps), _skewed(jir, steps)
        got = [f.to_json() for f in tpasses.run_correctness_passes(ir)]
        assert got == [f.to_json() for f in jpasses.run_correctness_passes(ref)]
        tiers = {m: [f.to_json() for f in tpasses.run_correctness_passes(ir, mode=m)]
                 for m in ("enum", "structured")}
        assert tiers["enum"] != tiers["structured"]
        assert got == tiers["enum" if steps <= tpasses.ENUM_LIMIT else "structured"], steps


# --------------------------------------------------------------------------- #
# findings, reports, the gate's error and the caches
# --------------------------------------------------------------------------- #


def test_findings_api_equals_jax():
    assert (tfindings.SCHEMA, tfindings.SEVERITIES) == (jfindings.SCHEMA, jfindings.SEVERITIES)
    for s in tfindings.SEVERITIES:
        for th in tfindings.SEVERITIES:
            assert tfindings.severity_at_least(s, th) == jfindings.severity_at_least(s, th)
    witness = ((np.int64(1), np.int64(2)),)
    got = tfindings.Finding(rule="race.write_write", severity="error", message="m", witness=witness,
                            address=np.int64(3))
    want = jfindings.Finding(rule="race.write_write", severity="error", message="m", witness=witness,
                             address=np.int64(3))
    assert got.witness == ((1, 2),) and got.address == 3 and type(got.address) is int
    assert got.to_json() == want.to_json() and got.render() == want.render()
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    findings = [tanalysis.analyze_ir(tanalysis.FIXTURES[n](), "V100", cache=False).findings
                for n in ("racy_store", "oob_halo", "gap_store")]
    ref = [janalysis.analyze_ir(janalysis.FIXTURES[n](), "V100", cache=False).findings
           for n in ("racy_store", "oob_halo", "gap_store")]
    flat, ref_flat = [f for fs in findings for f in fs], [f for fs in ref for f in fs]
    assert [f.to_json() for f in tfindings.sort_findings(flat[::-1])] == [
        f.to_json() for f in jfindings.sort_findings(ref_flat[::-1])]


@pytest.mark.parametrize("name", ["racy_store", "oob_halo", "aliased_pair"])
def test_validate_and_lint_error_equal_jax(name):
    got = tanalysis.analyze_ir(tanalysis.FIXTURES[name](), "V100", cache=False)
    want = janalysis.analyze_ir(janalysis.FIXTURES[name](), "V100", cache=False)
    doc = json.loads(json.dumps(got.to_json()))
    assert tanalysis.validate_report_json(doc) == [] == janalysis.validate_report_json(doc)
    for bad in (dict(doc, schema="nope"), {k: v for k, v in doc.items() if k != "findings"},
                dict(doc, findings=[dict(doc["findings"][0], severity="fatal")])):
        assert tanalysis.validate_report_json(bad) == janalysis.validate_report_json(bad) != []
    for threshold in tanalysis.SEVERITIES:
        assert got.ok(threshold) == want.ok(threshold)
        e = tanalysis.LintError(got, threshold, context="config x")
        assert str(e) == str(janalysis.LintError(want, threshold, context="config x"))
        assert e.report is got and e.threshold == threshold and isinstance(e, ValueError)


def _lint_counters(metrics) -> dict:
    return {k: v for k, v in metrics.snapshot()["counters"].items() if k.startswith("lint.")}


def test_cache_counters_equal_jax():
    """One sequence of calls through each package's two caches (correctness,
    keyed on structure; perf, keyed on fingerprint and machine) moves the
    ``lint.reports``, ``lint.findings`` and ``lint.cache_hits`` counters
    alike, and the cached reports equal the uncached ones."""
    def run(analysis, metrics, ir_mod):
        analysis.clear_cache()
        before = _lint_counters(metrics)
        base = analysis.FIXTURES["racy_store"]()
        reblocked = ir_mod.AccessIR(name="renamed", fields=base.fields, accesses=base.accesses,
                                    iter_shape=base.iter_shape, block=(4, 4))
        reps = [analysis.analyze_ir(ir, m) for ir, m in (
            (base, None), (base, None), (reblocked, None), (base, "V100"), (base, "V100"),
            (base, "H100"), (reblocked, "V100"))]
        reps.append(analysis.analyze_ir(base, "V100", rules=("race",)))
        after = _lint_counters(metrics)
        delta = {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}
        analysis.clear_cache()
        return [report_data(r) for r in reps], delta

    got, want = run(tanalysis, tmetrics, tir), run(janalysis, jmetrics, jir)
    assert got == want
    assert got[1]["lint.cache_hits"] == 4.0 and got[1]["lint.reports"] == 4.0
    assert all(r[1]["findings"] and r[1]["findings"][0]["rule"].startswith("race") for r in got[0][-1:])


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("golden", sorted(LINT_GOLDENS))
def test_lint_cli_prints_the_golden(golden, capsys):
    want_rc, argv = LINT_GOLDENS[golden]
    tanalysis.clear_cache()
    rc = tcli.main(argv)
    out = capsys.readouterr().out
    assert rc == want_rc
    assert out == (GOLDEN_DIR / golden).read_text()


@pytest.mark.parametrize("argv", [
    ["lint", "--fixture", "all", "--json"],
    ["lint", "--kernel", "lbm_d3q15", "--machine", "h100", "--rules", "perf,bounds", "--json"],
    ["lint", "--kernel", "wkv", "--backend", "tpu", "--machine", "tpuv6e"],
    ["lint", "--kernel", "attention_tpu", "--config", "bq512", "--fail-on", "warn"],
    ["lint", "--kernel", "stencil25", "--mode", "structured", "--fail-on", "never",
     "--config", '{"block": [64, 2, 8], "fold": [1, 2, 1]}'],
    ["lint"],
], ids=lambda a: " ".join(a[1:4]) or "lint")
def test_lint_cli_equals_the_jax_cli(argv, capsys):
    runs = []
    for main, analysis in ((jcli.main, janalysis), (tcli.main, tanalysis)):
        analysis.clear_cache()
        rc = main(argv)
        cap = capsys.readouterr()
        runs.append((rc, cap.out, cap.err))
    assert runs[1] == runs[0]
    if "--json" in argv:
        doc = json.loads(runs[1][1])
        assert doc["schema"] == tanalysis.SCHEMA
        assert all(tanalysis.validate_report_json(r) == [] for r in doc["reports"])
