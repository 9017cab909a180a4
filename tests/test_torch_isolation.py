"""The port stands alone and never falls back silently.

* Importing every ``repro_torch`` module, ``chip_smoke.py``,
  ``benchmarks/torch_rank_check.py``, ``benchmarks/torch_ranking_host.py``,
  ``benchmarks/torch_step_time_check.py``,
  ``benchmarks/torch_flash_bwd_turns.py``,
  ``benchmarks/torch_flash_bwd_drift.py``,
  ``benchmarks/torch_simulate_check.py``,
  ``benchmarks/torch_span_profile.py`` or
  ``benchmarks/torch_norm_turns.py`` loads no ``jax`` and nothing of
  ``repro`` (checked in a fresh interpreter), and neither does a cell of
  the dry run.
* Without CUDA, the state-creating functions raise unless asked for the CPU,
  ``chip_smoke.py``, the rank check, the step-time check, the span
  profile and the norm turns exit non-zero and print no result, and the CPU path
  leaves the kernels' launch counters alone.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.attention import flash_attention, flash_attention_cuda
from repro_torch.kernels.attention.kernel import flash_attention_bwd_cuda
from repro_torch.kernels.lbm_d3q15 import init_fields, lbm_d3q15_cuda, lbm_step
from repro_torch.kernels.stencil25 import stencil25, stencil25_cuda
from repro_torch.kernels.wkv import wkv, wkv_cuda

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for name in ("repro_torch.convert", "repro_torch._build",
                 "repro_torch.kernels.stencil25.kernel", "repro_torch.kernels.lbm_d3q15.ops",
                 "repro_torch.core.estimator", "repro_torch.core.ranking",
                 "repro_torch.frontend.lower",
                 "repro_torch.kernels.attention.kernel", "repro_torch.kernels.attention.ops",
                 "repro_torch.kernels.attention.ref", "repro_torch.kernels.wkv.kernel",
                 "repro_torch.kernels.wkv.ops", "repro_torch.kernels.wkv.ref",
                 "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.qwen2_5_14b",
                 "repro_torch.configs.rwkv6_1_6b", "repro_torch.models.params",
                 "repro_torch.models.layers", "repro_torch.models.rwkv6",
                 "repro_torch.models.registry", "repro_torch.serve.engine",
                 "repro_torch.launch.serve", "repro_torch.optim.optimizers",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
                 "repro_torch.train.step", "repro_torch.train.trainer",
                 "repro_torch.launch.train", "repro_torch.launch.mesh",
                 "repro_torch.core.record", "repro_torch.core.hlo_analysis",
                 "repro_torch.frontend.builders", "repro_torch.models.shardctx",
                 "repro_torch.train.sharding",
                 "repro_torch.obs.metrics", "repro_torch.obs.trace",
                 "repro_torch.explore.registry", "repro_torch.explore.study",
                 "repro_torch.explore.cli", "repro_torch.graph.dag",
                 "repro_torch.graph.kernels", "repro_torch.graph.frontend",
                 "repro_torch.graph.replay", "repro_torch.graph.study",
                 "repro_torch.graph.classes", "repro_torch.store", "repro_torch.store.jsonl",
                 "repro_torch.store.sharded", "repro_torch.store.alias", "repro_torch.explore.store",
                 "repro_torch.explore.space", "repro_torch.explore.prune", "repro_torch.explore.pareto",
                 "repro_torch.explore.serve", "repro_torch.explore.search",
                 "repro_torch.explore.search.driver", "repro_torch.explore.search.halving",
                 "repro_torch.explore.search.propose", "repro_torch.explore.search.convergence",
                 "repro_torch.analysis", "repro_torch.analysis.affine", "repro_torch.analysis.findings",
                 "repro_torch.analysis.fixtures", "repro_torch.analysis.passes", "repro_torch.analysis.perf",
                 "repro_torch.obs.explain", "repro_torch.core.tpu_estimator", "repro_torch.frontend.pallas",
                 "repro_torch.core.roofline", "repro_torch.core.gpu_roofline", "repro_torch.core.exactcount",
                 "repro_torch.launch.dryrun", "repro_torch.launch.variants"):
        assert name in res["modules"]


@pytest.mark.parametrize("script", ["torch_rank_check", "torch_ranking_host", "torch_step_time_check",
                                    "torch_flash_bwd_turns", "torch_flash_bwd_drift", "torch_simulate_check",
                                    "torch_span_profile", "torch_norm_turns"])
def test_paper_path_benchmarks_import_no_jax_and_no_repro(script):
    """``benchmarks/<script>.py``, imported alone."""
    probe = (f"import json, sys; sys.path.insert(0, 'benchmarks'); import {script}; "
             "print(json.dumps(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))")
    out = subprocess.run(
        [sys.executable, "-c", probe], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_dry_run_loads_no_jax_and_no_repro(tmp_path):
    """A smoke cell of ``python -m repro_torch.launch.dryrun``, as
    ``chip_smoke.py`` starts it, in a fresh interpreter."""
    probe = ("import json, sys; from repro_torch.launch import dryrun; "
             f"r = dryrun.main(['--arch', 'rwkv6-1.6b', '--shape', 'decode_32k', '--smoke', '--out', {str(tmp_path)!r}]); "
             "print(json.dumps([r['status'], sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))]))")
    out = subprocess.run(
        [sys.executable, "-c", probe], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["ok", []]


def test_rank_check_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the rank check would run")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_rank_check.py")], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""


def test_step_time_check_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the step-time check would run")
    out_file = tmp_path / "out.json"
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_step_time_check.py"), "--out", str(out_file)],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert not out_file.exists()


def test_span_profile_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the span profile would run")
    out_file = tmp_path / "out.json"
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_span_profile.py"), "--workload", "olmo-1b.train_2k",
         "--seed", "1", "--seconds", "1", "--out", str(out_file)],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert not out_file.exists()


def test_norm_turns_fail_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the norm turns would run")
    out_file = tmp_path / "out.jsonl"
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_norm_turns.py"), "--out", str(out_file)],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert not out_file.exists()


def test_state_defaults_to_cuda():
    if torch.cuda.is_available():
        assert init_fields((4, 4, 8))[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_fields((4, 4, 8))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _launches():
    return tuple(fn.launches for fn in (stencil25_cuda, lbm_d3q15_cuda, flash_attention_cuda,
                                        flash_attention_bwd_cuda, wkv_cuda))


def test_cpu_path_leaves_launch_counters_alone():
    before = _launches()
    stencil25(torch.ones((8, 8, 16)), block=(16, 4, 2), fold=(1, 1, 1))
    f, phase, vel = init_fields((4, 4, 8), device="cpu")
    lbm_step(f, phase, vel, block=(8, 4, 4))
    q = torch.ones((1, 2, 64, 32))
    flash_attention(q, q, q)
    flash_attention_cuda(q, q, q, block_q=32, block_kv=64)
    dq, dk, dv = flash_attention_bwd_cuda(q, q, q, q, torch.zeros(q.shape[:3]), q)
    assert dq.shape == q.shape and dk.shape == dv.shape == q.shape
    t = torch.full((2, 32, 16), -0.5)
    wkv(t, t, t, t, torch.ones(16))
    wkv_cuda(t, t, t, t, torch.ones(16), chunk=16)
    assert _launches() == before


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: chip_smoke.py would run")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

