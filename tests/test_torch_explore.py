"""The port's exploration (``repro_torch.explore``) held `==` to the JAX
package's (``repro.explore``), on the CPU.

* **spaces:** each registered space's enumeration order, ``FilterReport``,
  ``subsample(seed)``, lazy and stratified samples and one-step neighbours;
* **pruning and Pareto:** ``prune_configs``' report and the Pareto fronts;
* **the multi-machine batch:** ``estimate_many_machines`` and
  ``estimate_batch_machines`` against the JAX package's and against the
  one-machine path;
* **Study:** the records (metrics, volumes, the full §III estimate and
  prediction, fingerprints, order, ``feasible``) of the four GPU kernels on
  ``v100``, ``a100`` and ``h100`` (the larger spaces sampled), a
  multi-machine run and ``compare()``, ``workers=2`` against the serial run,
  a warm aliased store that traces no IR, ``"h100"`` over both paper spaces
  in ``core.ranking.rank_configs``' order, ``Study.step_time``, and the
  TPU backend, ``explain`` and the ``lint=`` gate, equal to the JAX
  package's;
* **the CLI:** the sweep prints ``tests/golden/explore_stencil25_{a100,
  v100}.json`` byte for byte after ``tests/test_golden_cli.py``'s
  stripping; ``--list``, ``--machines``, ``--prune``, ``--pareto``, the
  store and alias flags, ``--backend tpu``, a TPU machine, ``--explain`` and
  ``lint`` print what the JAX CLI prints.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.explore as jx
import repro_torch.explore as tx
from repro.core import estimator as jest
from repro.explore import cli as jcli
from repro.explore import registry as jreg
from repro.explore import space as jspace
from repro_torch.core import estimator as test
from repro_torch.core import machine as tmach
from repro_torch.core.ranking import rank_configs as t_rank_configs
from repro_torch.explore import cli as tcli
from repro_torch.explore import registry as treg
from repro_torch.explore import space as tspace
from repro_torch.obs import trace as obs_trace

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "tests" / "golden"
GOLDEN_BASE_ARGS = ["--kernel", "stencil25", "--sample", "24", "--seed", "7", "--top", "5",
                    "--no-store", "--json"]  # tests/test_golden_cli.py's BASE_ARGS
MACHINES = ("v100", "a100", "h100")
KERNEL_SAMPLE = {"stencil25": 40, "lbm_d3q15": 20, "attention": None, "wkv": 10}
SPACES = ("stencil25_space", "stencil25_wide_space", "lbm_d3q15_space", "attention_gpu_space",
          "wkv_gpu_space")


def rec_tuple(r) -> tuple:
    """Everything a record carries, as plain data the two packages share."""
    ranked = None
    if r.ranked is not None:
        ranked = (r.ranked.config, dataclasses.asdict(r.ranked.estimate),
                  dataclasses.asdict(r.ranked.prediction))
    return (r.config, r.backend, r.time_s, r.limiter, r.feasible, r.volumes, r.metrics,
            r.fingerprint, getattr(r, "from_cache", None), ranked)


def assert_results_equal(got, want) -> None:
    assert (got.kernel, got.backend, got.machine, got.method) == (
        want.kernel, want.backend, want.machine, want.method)
    assert [rec_tuple(r) for r in got.records] == [rec_tuple(r) for r in want.records]
    assert (got.stats.candidates, got.stats.evaluated, got.stats.cache_hits, got.stats.pruned) == (
        want.stats.candidates, want.stats.evaluated, want.stats.cache_hits, want.stats.pruned)
    if want.space_report is None:
        assert got.space_report is None
    else:
        assert dataclasses.asdict(got.space_report) == dataclasses.asdict(want.space_report)


@functools.lru_cache(maxsize=None)
def jax_multi(kernel: str):
    """The JAX package's three-machine study of one kernel (its records
    equal its one-machine studies', which ``tests/test_study.py`` holds)."""
    return jx.Study(kernel, machines=list(MACHINES), sample=KERNEL_SAMPLE[kernel], seed=5).run()


@functools.lru_cache(maxsize=None)
def port_single(kernel: str, machine: str):
    return tx.Study(kernel, machine=machine, sample=KERNEL_SAMPLE[kernel], seed=5).result()


# --------------------------------------------------------------------------- #
# spaces, pruning, Pareto
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", SPACES)
def test_space_equals_jax(name):
    got_space, want_space = getattr(treg, name)(), getattr(jreg, name)()
    got_rep, want_rep = tspace.FilterReport(), jspace.FilterReport()
    got, want = got_space.configs(got_rep), want_space.configs(want_rep)
    assert got == want and len(got) > 0
    assert dataclasses.asdict(got_rep) == dataclasses.asdict(want_rep)
    assert str(got_rep) == str(want_rep)
    assert got_space.raw_size == want_space.raw_size
    for seed in (0, 7):
        n = max(1, len(want) // 3)
        assert tspace.subsample(got, n, seed) == jspace.subsample(want, n, seed)
        assert got_space.sample(n, seed) == want_space.sample(n, seed)
        assert got_space.sample_lazy(n, seed, with_raw=True) == want_space.sample_lazy(n, seed, with_raw=True)
        assert got_space.sample_stratified(n, seed, with_raw=True) == want_space.sample_stratified(
            n, seed, with_raw=True)
    raws = [want_space.decode(i) for i in range(0, want_space.raw_size, max(1, want_space.raw_size // 17))]
    assert [got_space.decode(i) for i in range(0, got_space.raw_size, max(1, got_space.raw_size // 17))] == raws
    assert [got_space.neighbors(r) for r in raws] == [want_space.neighbors(r) for r in raws]
    assert [got_space.accept(r) for r in raws] == [want_space.accept(r) for r in raws]


@pytest.mark.parametrize("machine", ["v100", "h100"])
@pytest.mark.parametrize("kernel", ["stencil25", "lbm_d3q15"])
def test_prune_report_equals_jax(kernel, machine):
    got = tx.Study(kernel, machine=machine, prune=True, keep_fraction=0.3, sample=60, seed=2).result()
    want = jx.Study(kernel, machine=machine, prune=True, keep_fraction=0.3, sample=60, seed=2).result()
    assert dataclasses.asdict(got.prune_report) == dataclasses.asdict(want.prune_report)
    assert str(got.prune_report) == str(want.prune_report)
    assert_results_equal(got, want)
    entry = treg.get_kernel(kernel)
    cfgs = treg.get_kernel(kernel).space().configs()[:30]
    specs = [entry.build(**c) for c in cfgs]
    jentry = jreg.get_kernel(kernel)
    jspecs = [jentry.build(**c) for c in cfgs]
    m_t, m_j = tmach.get_machine(machine), jreg.get_machine(machine)
    from repro.explore import prune as jprune
    from repro_torch.explore import prune as tprune

    assert [tprune.upper_bound_glups(s, m_t) for s in specs] == [jprune.upper_bound_glups(s, m_j) for s in jspecs]
    assert [tprune.compulsory_bytes_per_lup(s) for s in specs] == [jprune.compulsory_bytes_per_lup(s) for s in jspecs]
    assert [tprune.sanity_reason(s, m_t) for s in specs] == [jprune.sanity_reason(s, m_j) for s in jspecs]


@pytest.mark.parametrize("kernel", ["stencil25", "lbm_d3q15"])
def test_pareto_fronts_equal_jax(kernel):
    from repro.explore import pareto as jpareto
    from repro_torch.explore import pareto as tpareto

    for m in MACHINES:
        res = jax_multi(kernel).result(m)
        metrics = [r.metrics for r in res.records]
        for obj in (tpareto.GPU_OBJECTIVES, (("glups", "max"), ("v_dram", "min")), (("occupancy", "max"),)):
            assert tpareto.pareto_front(metrics, obj) == jpareto.pareto_front(metrics, obj)
        got = port_single(kernel, m)
        assert [rec_tuple(r) for r in got.pareto()] == [rec_tuple(r) for r in res.pareto()]
        assert [rec_tuple(r) for r in got.top(4)] == [rec_tuple(r) for r in res.top(4)]
    with pytest.raises(ValueError) as got_e:
        tpareto.validate_objectives((("nope", "max"),), {"glups"})
    with pytest.raises(ValueError) as want_e:
        jpareto.validate_objectives((("nope", "max"),), {"glups"})
    assert str(got_e.value) == str(want_e.value)


# --------------------------------------------------------------------------- #
# the multi-machine batch
# --------------------------------------------------------------------------- #


def test_estimate_many_machines_equals_jax_and_one_machine():
    cfgs = treg.get_kernel("stencil25").space().configs()[::9]
    specs = [treg.get_kernel("stencil25").build(**c) for c in cfgs]
    jspecs = [jreg.get_kernel("stencil25").build(**c) for c in cfgs]
    ms_t = [tmach.get_machine(m) for m in MACHINES]
    ms_j = [jreg.get_machine(m) for m in MACHINES]
    got = test.estimate_many_machines(specs, ms_t, cache=test.EstimateCache())
    want = jest.estimate_many_machines(jspecs, ms_j, cache=jest.EstimateCache())
    for m in ms_t:
        one = test.estimate_many(specs, m, cache=test.EstimateCache())
        assert [dataclasses.asdict(e) for e in got[m.name]] == [dataclasses.asdict(e) for e in want[m.name]]
        assert [dataclasses.asdict(e) for e in got[m.name]] == [dataclasses.asdict(e) for e in one]
    irs = [treg.get_kernel("stencil25").build_ir(**c) for c in cfgs]
    jirs = [jreg.get_kernel("stencil25").build_ir(**c) for c in cfgs]
    got_r = test.GPUAnalyticEstimator().estimate_batch_machines(irs, ms_t, configs=cfgs)
    want_r = jest.GPUAnalyticEstimator().estimate_batch_machines(jirs, ms_j, configs=cfgs)
    for m in ms_t:
        one = test.GPUAnalyticEstimator().estimate_batch(irs, m, configs=cfgs)
        assert [rec_tuple(r) for r in got_r[m.name]] == [rec_tuple(r) for r in want_r[m.name]]
        assert [rec_tuple(r) for r in got_r[m.name]] == [rec_tuple(r) for r in one]


# --------------------------------------------------------------------------- #
# Study
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("kernel", sorted(KERNEL_SAMPLE))
def test_study_records_equal_jax(kernel, machine):
    got = port_single(kernel, machine)
    want = jax_multi(kernel).result(machine)
    assert_results_equal(got, want)
    assert len(got.records) == (KERNEL_SAMPLE[kernel] or 19)
    assert [r.config for r in got.ranked] == [r.config for r in want.ranked]


@pytest.mark.parametrize("kernel", ["stencil25", "wkv"])
def test_multi_machine_run_and_compare_equal_jax(kernel):
    study = tx.Study(kernel, machines=list(MACHINES), sample=KERNEL_SAMPLE[kernel], seed=5)
    got, want = study.run(), jax_multi(kernel)
    assert got.machines == want.machines
    for m in got.machines:
        assert_results_equal(got.result(m), want.result(m))
    cm, jcm = got.compare(), want.compare()
    assert cm.tau == jcm.tau
    summary, want_summary = cm.summary(5), jcm.summary(5)
    assert json.dumps(summary, sort_keys=True, default=list) == json.dumps(want_summary, sort_keys=True, default=list)
    with pytest.raises(ValueError, match="at least two machines"):
        tx.Study(kernel, machine="h100").compare()


_POOL = """
import json
from repro_torch.explore import Study
from test_torch_explore import rec_tuple
import sys
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
kw = dict(machines=["v100", "h100"], sample=24, seed=1)
serial, pooled = Study("stencil25", **kw).run(), Study("stencil25", workers=2, **kw).run()
print(json.dumps({m: [[rec_tuple(r) for r in res.result(m).records] for res in (serial, pooled)]
                  + [pooled.result(m).stats.metrics["counters"].get("estimate.cache_misses{backend=gpu}", 0)]
                  for m in serial.machines}, default=list))
"""


def test_workers_equal_the_serial_run():
    """In a fresh interpreter without jax: the pool forks, and a fork of a
    process where jax's threads run can deadlock."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", _POOL], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    for m, (serial, pooled, misses) in json.loads(out.stdout).items():
        assert pooled == serial and len(serial) == 24, m
        assert misses > 0  # the workers' estimates, merged into the parent's metrics


def test_warm_aliased_store_traces_nothing(tmp_path):
    kw = dict(machine="h100", store=tmp_path / "s.jsonl", alias=tmp_path / "alias.jsonl", sample=30, seed=4)
    cold = tx.Study("lbm_d3q15", **kw).result()
    tracer = obs_trace.enable()
    try:
        warm = tx.Study("lbm_d3q15", **kw).result()
        names = tracer.span_names()
    finally:
        obs_trace.disable()
    assert warm.stats.cache_hits == 30 and warm.stats.evaluated == 0
    assert "study.trace_ir" not in names and {"sweep", "sweep.store_lookup"} <= names
    assert [rec_tuple(r)[:-2] for r in warm.records] == [rec_tuple(r)[:-2] for r in cold.records]
    resumed = tx.Study("lbm_d3q15", **kw)
    resumed.run()
    assert resumed.resume().result().stats.cache_hits == 30


@pytest.mark.parametrize("kernel, build, configs", [
    ("stencil25", "star3d", "stencil_config_space"),
    ("lbm_d3q15", "lbm_d3q15", "lbm_config_space"),
])
def test_h100_paper_spaces_in_rank_configs_order(kernel, build, configs):
    from repro_torch.core import appspec

    ranked = t_rank_configs(getattr(appspec, build), getattr(appspec, configs)(), machine=tmach.H100_SXM)
    res = tx.Study(kernel, machine="h100").result()
    assert [r.ranked.config for r in res.records] == [rc.config for rc in ranked]
    assert [r.metrics["glups"] for r in res.records] == [rc.prediction.glups for rc in ranked]
    assert [dataclasses.asdict(r.ranked.estimate) for r in res.records] == [
        dataclasses.asdict(rc.estimate) for rc in ranked]


def test_step_time_is_graph_step_time():
    from repro_torch.configs import get_arch
    from repro_torch.graph import step_time

    cfg = get_arch("olmo-1b").smoke()
    a = tx.Study.step_time(cfg, "h100", batch=4, seq=128)
    b = step_time(cfg, "h100", batch=4, seq=128)
    assert a.step_time_s == b.step_time_s and a.render_json() == b.render_json()


def _outcome(fn):
    """What a call gives: its value, or its exception's type and message."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception is the outcome compared
        return (type(e).__name__, str(e))


def _lint_outcome(mod, lint):
    def run():
        study = mod.Study("stencil25", lint=lint, sample=8, seed=1)
        res = study.result()
        return [rec_tuple(r) for r in res.records], {fp: rep.to_json() for fp, rep in study.lint_reports.items()}
    return _outcome(run)


def test_tpu_explain_and_lint_raise_naming_their_items():
    """The TPU backend, ``explain`` and the ``lint=`` gate, which raised
    before the port had them, now run and give what the JAX package gives:
    the same records, the same reports and the same refusals."""
    for kernel, kw in (("stencil25", {"backend": "tpu"}), ("wkv_tpu", {"machines": ["tpuv5e", "tpuv6e"]})):
        got, want = tx.Study(kernel, **kw).run(), jx.Study(kernel, **kw).run()
        assert list(got.results) == list(want.results)
        for label in want.results:
            assert_results_equal(got.results[label], want.results[label])
    got = _outcome(lambda: tx.Study("stencil25", machine="tpuv5e"))
    assert got == _outcome(lambda: jx.Study("stencil25", machine="tpuv5e")) and got[0] == "ValueError"
    from repro.frontend.ir import ir_fingerprint as j_fp
    from repro.frontend.pallas import trace_pallas as j_trace
    from repro_torch.frontend.ir import ir_fingerprint as t_fp
    from repro_torch.frontend.pallas import trace_pallas as t_trace

    got_cfgs = treg.get_kernel("attention_tpu").tpu_configs()
    want_cfgs = jreg.get_kernel("attention_tpu").tpu_configs()
    assert [(c.name, c.grid, c.meta) for c in got_cfgs] == [(c.name, c.grid, c.meta) for c in want_cfgs]
    assert [t_fp(t_trace(c)) for c in got_cfgs] == [j_fp(j_trace(c)) for c in want_cfgs]
    wkv_cfgs = treg.get_kernel("wkv_tpu").tpu_configs(), jreg.get_kernel("wkv_tpu").tpu_configs()
    got = treg.get_estimator("tpu").estimate_batch([t_trace(c) for c in wkv_cfgs[0]], tmach.get_machine("tpuv6e"))
    want = jreg.get_estimator("tpu").estimate_batch([j_trace(c) for c in wkv_cfgs[1]],
                                                    jreg.get_machine("tpuv6e"))
    assert [rec_tuple(r) for r in got] == [rec_tuple(r) for r in want]
    for lint in ("error", "warn", "annotate"):
        got = _lint_outcome(tx, lint)
        assert got == _lint_outcome(jx, lint), lint
        assert (got[0] == "LintError") == (lint == "warn")  # the stencil's halo is a warn
    with pytest.raises(ValueError, match="lint="):
        tx.Study("stencil25", lint="loud")
    got = tx.Study("attention", machine="a100", lint="off").explain()
    want = jx.Study("attention", machine="a100", lint="off").explain()
    assert got.render() == want.render() and got.to_json() == want.to_json()
    from repro.configs import get_arch as j_arch
    from repro_torch.configs import get_arch as t_arch

    def step(mod, arch):
        return _outcome(lambda: mod.Study.step_time(arch("olmo-1b").smoke(), "a100", batch=4, seq=128,
                                                    lint="warn").render_json())
    assert step(tx, t_arch) == step(jx, j_arch)
    assert sorted(treg.KERNELS) == sorted(jreg.KERNELS)
    assert [dataclasses.astuple(e)[:4] for e in treg.KERNELS.values()] == [
        dataclasses.astuple(e)[:4] for e in jreg.KERNELS.values()]


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("golden", ["explore_stencil25_a100.json", "explore_stencil25_v100.json"])
def test_cli_prints_the_golden_sweep(golden, capsys):
    machine = golden.split("_")[-1].split(".")[0]
    rc, out, err = _run(tcli.main, GOLDEN_BASE_ARGS + ["--machine", machine], capsys)
    assert rc == 0, err
    doc = json.loads(out)
    doc.pop("wall_s")
    doc.pop("store")
    assert json.dumps(doc, indent=2, sort_keys=True) + "\n" == (GOLDEN_DIR / golden).read_text()


def _strip_wall(out: str) -> str:
    if out.lstrip().startswith("{"):
        doc = json.loads(out)
        doc.pop("wall_s", None)
        return json.dumps(doc, sort_keys=True)
    return "\n".join(ln for ln in out.splitlines() if not ln.startswith("swept "))


@pytest.mark.parametrize("argv", [
    ["--list"],
    ["--kernel", "stencil25", "--machines", "v100,a100,h100", "--sample", "16", "--no-store", "--json"],
    ["--kernel", "lbm_d3q15", "--machines", "a100,h100", "--sample", "12", "--no-store", "--pareto"],
    ["--kernel", "stencil25", "--machine", "h100", "--prune", "--keep-fraction", "0.4", "--sample", "40",
     "--no-store", "--pareto"],
    ["--kernel", "attention", "--machine", "h100", "--no-store", "--json"],
    ["--kernel", "wkv", "--machine", "A100-SXM4-40GB", "--sample", "6", "--no-store", "--top", "3"],
    ["--kernel", "stencil25", "--sample", "10", "--store", "STORE", "--store-backend", "sharded", "--alias"],
    ["--kernel", "stencl25", "--no-store"],
], ids=lambda a: " ".join(a[:4]))
def test_cli_equals_the_jax_cli(argv, tmp_path, monkeypatch, capsys):
    runs = []
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        args = [a.replace("STORE", "stores/sweep") for a in argv]
        runs.append(_run(main, args, capsys))
        if "--alias" in argv:  # a second run: warm, from the store and the alias
            runs.append(_run(main, args, capsys))
    assert [rc for rc, _, _ in runs] == [runs[0][0]] * len(runs)
    assert [_strip_wall(out) for _, out, _ in runs[len(runs) // 2:]] == [
        _strip_wall(out) for _, out, _ in runs[:len(runs) // 2]]
    assert [err for _, _, err in runs[len(runs) // 2:]] == [err for _, _, err in runs[:len(runs) // 2]]
    if "--alias" in argv:
        assert "cache: 10 hits, 0 misses" in runs[-1][1]


def test_cli_left_out_parts_exit_2(tmp_path, capsys):
    """What the port's CLI once refused (exit 2) now prints what the JAX
    CLI prints, with its exit code: a ``--backend tpu`` sweep (``wkv``:
    ``attention_tpu``'s 16 configurations take seconds each on the host), a
    ``*_tpu`` kernel, a GPU kernel on a TPU machine (exit 2 in both),
    ``--explain`` and ``lint --all``.  Then ``--trace``."""
    for argv in (["--kernel", "wkv", "--backend", "tpu", "--no-store"],
                 ["--kernel", "stencil25_tpu", "--machine", "tpuv6e", "--no-store", "--json"],
                 ["--kernel", "stencil25", "--machine", "tpuv6e", "--no-store"],
                 ["--kernel", "stencil25", "--sample", "12", "--explain", "best", "--no-store"],
                 ["--kernel", "lbm_d3q15", "--sample", "6", "--explain", "2", "--no-store", "--json"],
                 ["lint", "--all"]):
        got, want = _run(tcli.main, argv, capsys), _run(jcli.main, argv, capsys)
        assert (got[0], _strip_wall(got[1]), got[2]) == (want[0], _strip_wall(want[1]), want[2]), argv
        assert got[0] == (2 if "tpuv6e" in argv and "stencil25" in argv else 0), argv
    trace = tmp_path / "sweep_trace.json"
    rc, out, err = _run(tcli.main, ["--kernel", "lbm_d3q15", "--sample", "5", "--no-store", "--json",
                                    "--trace", str(trace)], capsys)
    assert rc == 0 and "trace:" in err
    doc = json.loads(trace.read_text())
    assert obs_trace.validate_chrome_trace(doc) == []
    assert {"sweep", "study.trace_ir", "estimate.batch"} <= {e["name"] for e in doc["traceEvents"]}
