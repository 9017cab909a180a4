"""The port's estimation daemon (``repro_torch.explore.serve``) held `==` to
the JAX package's, over loopback HTTP.

* cold and warm responses, records and hit counts, equal the JAX daemon's
  for the same queries, and equal a ``Study``'s records;
* a root the JAX daemon warmed is served warm by the port's, with no
  estimate;
* two client processes share the daemon's warm state: what one estimated
  cold, the other reads from the store;
* ``/health``, ``/metrics``, unknown paths and bad requests; the TPU
  kernels (the ported TPU backend) answer as the JAX daemon's do, records
  and refusals alike; ``python -m repro_torch.explore serve`` starts,
  answers and stops on ``/shutdown``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import repro.explore.serve as jserve
import repro_torch.explore as tx
import repro_torch.explore.serve as tserve

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = [{"block": b, "fold": f} for b, f in (
    ((64, 4, 4), (1, 1, 1)), ((32, 8, 4), (1, 2, 1)), ((16, 8, 8), (1, 1, 2)), ((128, 2, 4), (1, 1, 1)),
    ((256, 4, 1), (1, 2, 1)), ((8, 16, 8), (1, 1, 1)))]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


class Daemon:
    """One package's daemon on 127.0.0.1 and a free port, in a thread."""

    def __init__(self, mod, root: Path):
        self.server, self.service = mod.serve(host="127.0.0.1", port=0, root=str(root))
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.client = mod.ServeClient("127.0.0.1", self.server.server_address[1])

    def close(self):
        self.client.shutdown()
        self.client.close()
        self.thread.join(timeout=10)
        self.server.server_close()
        self.service.close()


@pytest.fixture
def daemons(tmp_path):
    ds = {"jax": Daemon(jserve, tmp_path / "jax"), "port": Daemon(tserve, tmp_path / "port")}
    yield ds
    for d in ds.values():
        d.close()


@pytest.mark.parametrize("kernel, machine, configs", [
    ("stencil25", "h100", CONFIGS),
    ("lbm_d3q15", "v100", [{"block": (64, 2, 4), "fold": (1, 1, 1)}, {"block": (8, 8, 8), "fold": (1, 1, 1)}]),
    ("attention", "a100", [{"block": (32, 8, 1)}, {"block": (16, 32, 1)}]),
], ids=lambda v: v if isinstance(v, str) else None)
def test_cold_and_warm_responses_equal_jax(kernel, machine, configs, daemons):
    for phase in ("cold", "warm"):
        got = daemons["port"].client.estimate(kernel, configs, machine=machine)
        want = daemons["jax"].client.estimate(kernel, configs, machine=machine)
        assert got == want
        n = len(configs)
        assert got["stats"] == ({"alias_hits": 0, "store_hits": 0, "estimated": n} if phase == "cold"
                                else {"alias_hits": n, "store_hits": n, "estimated": 0})
        assert all(r["from_cache"] is (phase == "warm") for r in got["records"])
    study = tx.Study(kernel, configs=configs, machine=machine).result()
    by_fp = {r.fingerprint: r for r in study.records}
    for wire in got["records"]:
        rec = by_fp[wire["fingerprint"]]
        assert (wire["metrics"], wire["volumes"], wire["time_s"], wire["limiter"], wire["feasible"]) == (
            rec.metrics, rec.volumes, rec.time_s, rec.limiter, rec.feasible)


def test_a_root_the_jax_daemon_warmed_is_warm_in_the_port(tmp_path):
    root = tmp_path / "shared"
    j = Daemon(jserve, root)
    try:
        cold = j.client.estimate("stencil25", CONFIGS, machine="a100")
    finally:
        j.close()
    t = Daemon(tserve, root)
    try:
        warm = t.client.estimate("stencil25", CONFIGS, machine="a100")
        assert warm["stats"] == {"alias_hits": len(CONFIGS), "store_hits": len(CONFIGS), "estimated": 0}
        assert [{k: v for k, v in r.items() if k != "from_cache"} for r in warm["records"]] == [
            {k: v for k, v in r.items() if k != "from_cache"} for r in cold["records"]]
        m = t.client.metrics()
        assert m["serve"]["queries"] == len(CONFIGS) and m["serve"]["cold_batches"] is not None
    finally:
        t.close()


_CLIENT = """
import json, sys
from repro_torch.explore.serve import ServeClient
port, lo, hi = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
cfgs = [{"block": [2 ** i, 1024 // 2 ** i // 4, 4], "fold": [1, 1, 1]} for i in range(lo, hi)]
c = ServeClient("127.0.0.1", port)
print(json.dumps(c.estimate("stencil25", cfgs, machine="h100")["stats"]))
c.close()
"""


def test_two_client_processes_share_warm_state(tmp_path):
    d = Daemon(tserve, tmp_path / "root")
    try:
        port = str(d.server.server_address[1])

        def client(lo, hi):
            out = subprocess.run([sys.executable, "-c", _CLIENT, port, str(lo), str(hi)], env=_env(),
                                 capture_output=True, text=True, timeout=120, check=True)
            return __import__("json").loads(out.stdout)

        assert client(0, 6) == {"alias_hits": 0, "store_hits": 0, "estimated": 6}
        assert client(2, 8) == {"alias_hits": 4, "store_hits": 4, "estimated": 2}
        assert client(0, 8) == {"alias_hits": 8, "store_hits": 8, "estimated": 0}
        assert d.client.metrics()["serve"]["queries"] == 20
    finally:
        d.close()


def test_health_errors_and_tpu_kernels(daemons):
    c = daemons["port"].client
    assert c.health()["ok"] is True
    m = c.metrics()
    assert set(m) == {"serve", "obs"} and m["serve"]["queries"] == 0
    for body, match in ((("nope", CONFIGS[:1]), "unknown kernel"),
                        (("stencil25", [1]), "not a config dict")):
        with pytest.raises(tserve.ServeError, match=match):
            c.estimate(*body)
    # a TPU kernel: an identity the registry did not generate is refused with
    # the JAX daemon's words; the registry's own are estimated, then warm
    for body in (("stencil25_tpu", [{"name": "x"}]), ("attention", [{"block": (8, 8, 1)}], "h100", None, "tpu")):
        with pytest.raises(tserve.ServeError) as got:
            c.estimate(*body)
        with pytest.raises(jserve.ServeError) as want:
            daemons["jax"].client.estimate(*body)
        assert str(got.value) == str(want.value) and "registry-generated identity" in str(got.value)
    tpu_cfgs = [{"name": "wkv_L64", "chunk": 64}, {"name": "wkv_L16", "chunk": 16}]
    for phase in ("cold", "warm"):
        got = c.estimate("wkv_tpu", tpu_cfgs, machine="tpuv6e")
        assert got == daemons["jax"].client.estimate("wkv_tpu", tpu_cfgs, machine="tpuv6e")
        assert got["stats"]["estimated"] == (2 if phase == "cold" else 0)
    with pytest.raises(tserve.ServeError, match="unknown path"):
        c._call("GET", "/nope")
    with pytest.raises(tserve.ServeError) as got:
        c.estimate("stencil25", CONFIGS[:1], machine="nope")
    with pytest.raises(jserve.ServeError) as want:
        daemons["jax"].client.estimate("stencil25", CONFIGS[:1], machine="not-a-machine")
    assert str(got.value).startswith("unknown machine 'nope'") and str(want.value).startswith("unknown machine")


def test_serve_cli_starts_answers_and_stops(tmp_path):
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.explore", "serve", "--port", "0",
                             "--root", str(tmp_path / "root"), "--store-backend", "sharded"],
                            env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:")
        c = tserve.ServeClient("127.0.0.1", int(line.rsplit(":", 1)[1]))
        res = c.estimate("stencil25", CONFIGS[:3], machine="v100")
        assert res["stats"]["estimated"] == 3
        c.shutdown()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert out.startswith("served 3 queries")
    assert (tmp_path / "root" / "stencil25__V100__sym").is_dir()
    warm = tx.Study("stencil25", configs=CONFIGS[:3], machine="v100",
                    store=tmp_path / "root" / "stencil25__V100__sym").result()
    assert warm.stats.cache_hits == 3 and warm.stats.evaluated == 0
