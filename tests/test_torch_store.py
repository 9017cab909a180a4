"""The port's result stores (``repro_torch.store``) against the JAX
package's (``repro.store``): the same keys and payloads, byte for byte, so
a store written by either package is read by the other as all hits.

* each backend (single-file JSONL, sharded directory) round-trips, and the
  JAX package reads what the port wrote, record for record;
* a ``Study`` sweep written by one package is served whole from the store
  by the other, on either backend and through the alias layer (a warm
  aliased sweep traces no IR), and the two packages write the same lines;
* two writer processes, one of each package, share a sharded store and lose
  no record; ``store compact`` of either CLI folds what both wrote;
* an interrupted sweep resumes where it stopped, across packages, and a
  half-written last line is skipped, as ``tests/test_store_resume.py`` has
  it for the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.explore as jx
import repro.store as jstore
import repro_torch.explore as tx
import repro_torch.store as tstore
from repro_torch.obs import trace as obs_trace

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"repro": (jx, jstore), "repro_torch": (tx, tstore)}
OTHER = {"repro": "repro_torch", "repro_torch": "repro"}
SAMPLE = 12  # configurations of the stencil space each sweep here estimates


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _store_path(tmp_path: Path, backend: str) -> Path:
    return tmp_path / ("sweep.jsonl" if backend == "jsonl" else "sweep_dir")


def _sweep(pkg: str, path: Path, backend: str, **kw):
    explore, store = PACKAGES[pkg]
    s = store.open_store(path, backend=backend)
    return explore.Study("stencil25", machine="a100", store=s, sample=SAMPLE, seed=3, **kw).result()


def _lines(path: Path) -> list[dict]:
    files = [path] if path.is_file() else sorted(path.glob("*.jsonl"))
    out = []
    for f in files:
        for ln in f.read_text().splitlines():
            rec = json.loads(ln)
            rec.pop("ts", None)  # the wall clock of the write
            out.append(rec)
    return out


@pytest.mark.parametrize("backend", ["jsonl", "sharded"])
def test_backend_round_trip_and_the_jax_package_reads_it(backend, tmp_path):
    path = _store_path(tmp_path, backend)
    recs = {tstore.canonical_key(k=i, cfg=[i, 2 * i]): {"x": float(i) / 3, "i": i} for i in range(9)}
    s = tstore.open_store(path, backend=backend)
    for key, payload in recs.items():
        s.put(key, payload, machine="H100-SXM5-80GB", builder_version=1)
    for key in list(recs)[:2]:  # a later put of a key wins
        recs[key] = {"x": -1.0}
        s.put(key, recs[key], machine="H100-SXM5-80GB", builder_version=1)
    want_type = tstore.ResultStore if backend == "jsonl" else tstore.ShardedStore
    for reader in (tstore.open_store(path), jstore.open_store(path)):
        assert type(reader).__name__ == want_type.__name__
        assert len(reader) == len(recs)
        assert {k: reader.get(k) for k in reader.keys()} == recs
        assert reader.machines() == {"H100-SXM5-80GB": len(recs)}
        assert reader.builder_versions() == {1: len(recs)}
    assert tstore.canonical_key(b=1, a=(2, 3)) == jstore.canonical_key(b=1, a=(2, 3))


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
@pytest.mark.parametrize("backend", ["jsonl", "sharded"])
def test_a_sweep_written_by_one_package_is_all_hits_in_the_other(writer, backend, tmp_path):
    path = _store_path(tmp_path, backend)
    cold = _sweep(writer, path, backend)
    assert cold.stats.evaluated == SAMPLE and cold.stats.cache_hits == 0
    warm = _sweep(OTHER[writer], path, backend)
    assert warm.stats.cache_hits == SAMPLE and warm.stats.evaluated == 0
    assert all(r.from_cache for r in warm.records)
    for a, b in zip(cold.records, warm.records):
        assert (a.config, a.metrics, a.volumes, a.fingerprint, a.feasible) == (
            b.config, b.metrics, b.volumes, b.fingerprint, b.feasible)


@pytest.mark.parametrize("backend", ["jsonl", "sharded"])
def test_both_packages_write_the_same_lines(backend, tmp_path):
    paths = {pkg: _store_path(tmp_path / pkg, backend) for pkg in PACKAGES}
    for pkg, path in paths.items():
        _sweep(pkg, path, backend)
    want, got = _lines(paths["repro"]), _lines(paths["repro_torch"])
    assert len(got) == SAMPLE
    assert got == want


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_alias_store_written_by_one_package_skips_tracing_in_the_other(writer, tmp_path):
    path, alias = tmp_path / "sweep.jsonl", tmp_path / "alias.jsonl"
    _sweep(writer, path, "jsonl", alias=str(alias))
    a = tstore.AliasStore(alias)
    assert len(a) == SAMPLE
    tracer = obs_trace.enable()
    try:
        if OTHER[writer] == "repro_torch":
            warm = _sweep("repro_torch", path, "jsonl", alias=str(alias))
            assert warm.stats.cache_hits == SAMPLE
            assert "study.trace_ir" not in tracer.span_names()
            assert "study.enumerate" in tracer.span_names()
        else:
            warm = _sweep("repro", path, "jsonl", alias=str(alias))
            assert warm.stats.cache_hits == SAMPLE
    finally:
        obs_trace.disable()
    key = tstore.alias_key("stencil25", "gpu", warm.records[0].config)
    assert key == jstore.alias_key("stencil25", "gpu", warm.records[0].config)
    assert a.get(key) == jstore.AliasStore(alias).get(key) == warm.records[0].fingerprint


def test_alias_store_goes_cold_on_a_builder_bump(tmp_path, monkeypatch):
    from repro_torch.frontend import ir as tir

    a = tstore.AliasStore(tmp_path / "alias.jsonl")
    a.put("k", "fp1")
    assert tstore.AliasStore(tmp_path / "alias.jsonl").get("k") == "fp1"
    monkeypatch.setattr(tir, "BUILDER_VERSION", tir.BUILDER_VERSION + 1)
    assert tstore.AliasStore(tmp_path / "alias.jsonl").get("k") is None


_WRITER = """
import sys
pkg, path, who, n = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
store = __import__(pkg + ".store", fromlist=["ShardedStore"])
s = store.ShardedStore(path, writer_id=who)
for i in range(n):
    s.put(store.canonical_key(w=who, i=i), {"writer": who, "i": i})
print("done", who)
"""


def test_two_writers_of_two_packages_share_a_sharded_store(tmp_path):
    d, n = tmp_path / "store", 150
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, pkg, str(d), pkg, str(n)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for pkg in PACKAGES]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    for reader in (tstore.ShardedStore(d, writer_id="r"), jstore.ShardedStore(d, writer_id="r")):
        assert len(reader) == 2 * n
        for who in PACKAGES:
            for i in range(n):
                assert reader.get(tstore.canonical_key(w=who, i=i)) == {"writer": who, "i": i}
    assert tstore.ShardedStore(d, writer_id="r").segments() == {
        "segment-repro.jsonl": n, "segment-repro_torch.jsonl": n}


@pytest.mark.parametrize("compactor", ["repro", "repro_torch"])
def test_store_compact_of_either_cli_folds_both_packages_segments(compactor, tmp_path, capsys):
    from repro.explore import cli as jcli
    from repro_torch.explore import cli as tcli

    d = tmp_path / "store"
    tstore.ShardedStore(d, writer_id="port").put("a", {"v": 1})
    jstore.ShardedStore(d, writer_id="jax").put("b", {"v": 2})
    tstore.ShardedStore(d, writer_id="port").put("a", {"v": 3})
    main = tcli.main if compactor == "repro_torch" else jcli.main
    assert main(["store", "compact", str(d)]) == 0
    out = capsys.readouterr().out
    assert "2 live entries" in out and "folded 2 layer(s)" in out
    for cls in (tstore.ShardedStore, jstore.ShardedStore):
        s = cls(d, writer_id="r")
        assert {k: s.get(k) for k in s.keys()} == {"a": {"v": 3}, "b": {"v": 2}}
        assert s.segments() == {"compacted.jsonl": 2}


@pytest.mark.parametrize("first", ["repro", "repro_torch"])
def test_interrupted_sweep_resumes_in_the_other_package(first, tmp_path):
    """A sweep cut after part of its space, then a half-written line, as a
    killed writer leaves it: the other package's full sweep pays only for
    the rest, and equals a cold one."""
    from repro.core import appspec as japp
    from repro_torch.core import appspec as tapp

    grid = (128, 64, 64)
    cfgs = [{"block": (32, 8, 4), "fold": (1, 1, 1)}, {"block": (16, 8, 8), "fold": (1, 1, 1)},
            {"block": (128, 1, 8), "fold": (1, 2, 1)}]
    builders = {"repro": lambda block, fold=(1, 1, 1): japp.star3d(block=block, fold=fold, grid=grid),
                "repro_torch": lambda block, fold=(1, 1, 1): tapp.star3d(block=block, fold=fold, grid=grid)}

    def sweep(pkg, configs, store=None):
        return PACKAGES[pkg][0].Study(builders[pkg], configs=configs, machine="v100", store=store).result()

    p = tmp_path / "sweep.jsonl"
    assert sweep(first, cfgs[:2], p).stats.evaluated == 2
    with p.open("a") as f:
        f.write('{"key": "half-written rec')
    full = sweep(OTHER[first], cfgs, p)
    assert full.stats.cache_hits == 2 and full.stats.evaluated == 1
    cold = sweep("repro_torch", cfgs)
    assert [r.config for r in full.records] == [r.config for r in cold.records]
    assert [r.metrics for r in full.records] == [r.metrics for r in cold.records]
