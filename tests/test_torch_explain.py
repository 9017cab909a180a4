"""The port's estimate provenance (``repro_torch.obs.explain``, through
``Study.explain``) held `==` to the JAX package's, on the CPU.

* **GPU:** the best record, ranks, a config dict and a configuration the
  sweep pruned (estimated on demand) on ``v100``, ``a100`` and ``h100``,
  with and without the lint gate's section; the refusals (a config outside
  the space, a rank out of range, a malformed target) say the same;
* **TPU:** the four ``*_tpu`` entries on ``tpuv5e`` and ``tpuv6e``, and a
  configuration the VMEM gate rejects;
* **cross-machine:** ``CrossMachineExplain``'s reports, divergence and
  rendering, on the GPUs and on the TPUs;
* **goldens:** ``tests/golden/explain_stencil25_{a100,v100}.txt``, printed
  byte for byte.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

import repro.explore as jx
import repro_torch.explore as tx
from repro.core import tpu_estimator as jte
from repro_torch.core import tpu_estimator as tte
from repro_torch.obs import explain as texplain

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "tests" / "golden"
EXPLAIN_CFG = {"block": (64, 2, 8), "fold": (1, 2, 1)}  # tests/test_obs.py's
EXPLAIN_GOLDENS = {"v100": "explain_stencil25_v100.txt", "a100": "explain_stencil25_a100.txt"}


def explain_data(rep) -> tuple:
    return rep.render(), json.dumps(rep.to_json(), sort_keys=True, default=list)


def _pruned(study, res):
    kept = {json.dumps(r.config, sort_keys=True, default=list) for r in res.records}
    return next(dict(c.config) for c in study._candidates()
                if json.dumps(c.config, sort_keys=True, default=list) not in kept)


@pytest.mark.parametrize("machine", sorted(EXPLAIN_GOLDENS))
def test_explain_prints_the_golden(machine):
    rep = tx.Study("stencil25", sample=24, seed=7, machine=machine).explain(dict(EXPLAIN_CFG))
    assert isinstance(rep, texplain.ExplainReport)
    assert rep.render() + "\n" == (GOLDEN_DIR / EXPLAIN_GOLDENS[machine]).read_text()


@pytest.mark.parametrize("kernel", ["stencil25", "lbm_d3q15", "attention", "wkv"])
@pytest.mark.parametrize("machine", ["v100", "a100", "h100"])
def test_gpu_reports_equal_jax(kernel, machine):
    kw = dict(sample=16, seed=3, machine=machine, prune=True, keep_fraction=0.4)
    got, want = tx.Study(kernel, **kw), jx.Study(kernel, **kw)
    res = want.result()
    assert [r.config for r in got.result().records] == [r.config for r in res.records]
    targets = ["best", 0, len(res.records) - 1, "1", json.dumps(res.records[0].config, default=list)]
    if len(res.records) < len(want._candidates()):
        targets.append(_pruned(want, res))
    for target in targets:
        g, w = got.explain(target), want.explain(target)
        assert explain_data(g) == explain_data(w), target
    for bad in ({"block": (3, 5, 7), "fold": (1, 1, 1)}, 10_000, "{not json", [1]):
        with pytest.raises(Exception) as g:
            got.explain(bad)
        with pytest.raises(Exception) as w:
            want.explain(bad)
        assert (type(g.value).__name__, str(g.value)) == (type(w.value).__name__, str(w.value))


def test_explain_with_the_lint_section_equals_jax():
    for machine in ("v100", "h100"):
        kw = dict(sample=12, seed=5, machine=machine, lint="annotate")
        got, want = tx.Study("stencil25", **kw).explain("best"), jx.Study("stencil25", **kw).explain("best")
        assert got.lint is not None and "bounds.halo" in got.render()
        assert explain_data(got) == explain_data(want)


def _small_attention(pkg):
    """Attention's Pallas space at (1, 8, 2, 2048, 128) bf16: the registry's
    shape takes seconds a configuration on the host."""
    mod = __import__(f"{pkg}.kernels.attention.ops", fromlist=["ops"])
    fn = mod.tpu_config_space if pkg == "repro_torch" else mod.config_space
    return {"backend": "tpu", "configs": fn(1, 8, 2, 2048, 128, 16)}


@pytest.mark.parametrize("kernel", ["stencil25_tpu", "lbm_d3q15_tpu", "wkv_tpu", "attention"])
def test_tpu_reports_equal_jax(kernel):
    kw = {"machines": ["tpuv5e", "tpuv6e"]}
    got_kw, want_kw = (_small_attention("repro_torch"), _small_attention("repro")) if kernel == "attention" else ({}, {})
    got, want = tx.Study(kernel, **kw, **got_kw), jx.Study(kernel, **kw, **want_kw)
    for label in want.run().results:
        assert [r.config for r in got.result(label).records] == [r.config for r in want.result(label).records]
        for target in ("best", 1, len(want.result(label).records) - 1):
            g, w = got.explain(target, machine=label), want.explain(target, machine=label)
            assert g.backend == "tpu" and explain_data(g) == explain_data(w), (label, target)
    cross, ref = got.explain("best"), want.explain("best")
    assert isinstance(cross, texplain.CrossMachineExplain)
    assert cross.divergence() == ref.divergence()
    assert cross.render() == ref.render() and cross.to_json() == ref.to_json()


def _gated_cfgs(te):
    def cfg(name, bz):
        return te.PallasConfig(
            name=name, grid=(256 // bz,),
            accesses=(te.BlockAccess(name="x", block_shape=(bz, 512, 128), index_map=lambda i: (i, 0, 0),
                                     dtype_bits=32),),
            flops_per_step=1.0, is_matmul=False, meta={"bz": bz})
    return [cfg("small", 8), cfg("mid", 16), cfg("huge", 256)]


def test_tpu_vmem_gated_config_equals_jax():
    got = tx.Study("attention", backend="tpu", configs=_gated_cfgs(tte), machine="tpuv5e")
    want = jx.Study("attention", backend="tpu", configs=_gated_cfgs(jte), machine="tpuv5e")
    for target in ("best", {"name": "huge", "bz": 256}):
        g, w = got.explain(target), want.explain(target)
        assert explain_data(g) == explain_data(w)
    assert not g.feasible and g.prune.rule == "vmem" and g.limiter.limiter == "VMEM"


@pytest.mark.parametrize("target", ["best", dict(EXPLAIN_CFG), 3])
def test_cross_machine_equals_jax(target):
    kw = dict(sample=24, seed=7, machines=["v100", "a100", "h100"])
    got, want = tx.Study("stencil25", **kw).explain(target), jx.Study("stencil25", **kw).explain(target)
    assert isinstance(got, texplain.CrossMachineExplain)
    assert got.machines == want.machines == ["V100", "A100", "H100"]
    assert got.divergence() == want.divergence()
    assert got.render() == want.render() and got.to_json() == want.to_json()
    for label in got.machines:
        assert explain_data(got.reports[label]) == explain_data(want.reports[label])
