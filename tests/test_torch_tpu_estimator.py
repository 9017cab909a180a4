"""The port's TPU backend held `==` to the JAX package's, on the CPU.

The TPU machines are the reference's analytic models and run on the host;
the port launches no Pallas kernel.  Held here:

* **the machines:** ``TPU_V5E``, ``TPU_V6E``, the registry with them, every
  spelling's canonical name, ``tpu_machines()``, and
  ``MeshSpec.axis_bandwidth`` / ``bandwidth`` on each axis of the three
  meshes, for both TPUs and the GPUs;
* **tracing:** ``trace_pallas`` over the four Pallas spaces
  (``kernels/<name>/ops.tpu_config_space``, the JAX ``config_space``'s
  copies, at the registry's shapes and at the JAX ops' own) gives the same
  IRs and fingerprints, and ``NonAffineIndexMapError`` the same message and
  provenance on a clamped map;
* **the estimator:** ``estimate``, ``estimate_ir``, ``rank_configs``,
  ``select_config`` (its refusal too), ``TPUPallasEstimator.estimate_batch``
  and ``record.tpu_record`` on ``tpuv5e`` and ``tpuv6e``;
* **the graph:** ``trace_step(backend="tpu")`` gives the JAX package's DAG
  for the ten smoke configs, both kinds, three meshes, and ``step_time`` on
  both TPUs the same report;
* **lowering:** ``lower_tpu`` rebuilds a ``PallasConfig`` that traces back to
  the same IR (``trace_pallas(lower_tpu(ir)) == ir``, as
  ``tests/test_frontend_ir.py`` holds the reference), estimates as the
  config it came from, equals the reference's lowering, and lowers the
  auditor's ``block_revisit_parallel`` fixture as
  ``tests/test_analysis.py`` does; an element-granular IR is refused with
  the reference's message.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.configs import get_arch as jax_get_arch
from repro.core import machine as jmach
from repro.core import record as jrecord
from repro.core import tpu_estimator as jte
from repro.frontend import ir as jir
from repro.frontend import pallas as jpallas
from repro.graph import step_time as jax_step_time
from repro.graph import trace_step as jax_trace_step
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core import machine as tmach
from repro_torch.core import record as trecord
from repro_torch.core import tpu_estimator as tte
from repro_torch.frontend import ir as tir
from repro_torch.frontend import pallas as tpallas
from repro_torch.graph import step_time, trace_step
from repro_torch.kernels.attention import ops as t_attn
from repro_torch.kernels.lbm_d3q15 import ops as t_lbm
from repro_torch.kernels.stencil25 import ops as t_stencil
from repro_torch.kernels.wkv import ops as t_wkv
from test_torch_graph import _node_fields, assert_reports_equal

TPUS = ("tpuv5e", "tpuv6e")
# (port space, JAX space's module, arguments): the registry's shapes, then
# the shapes the JAX ops' own selection ranks at
SPACES = {
    "stencil25": (t_stencil.tpu_config_space, "stencil25", ((256, 256, 512), 4, 32)),
    "stencil25_ops": (t_stencil.tpu_config_space, "stencil25", ((64, 64, 128), 4, 16)),
    "lbm_d3q15": (t_lbm.tpu_config_space, "lbm_d3q15", ((128, 128, 128), 32)),
    "lbm_d3q15_ops": (t_lbm.tpu_config_space, "lbm_d3q15", ((64, 32, 96), 64)),
    "attention": (t_attn.tpu_config_space, "attention", (4, 32, 8, 8192, 128, 16)),
    # a smaller grid for the estimates: the registry's takes seconds a configuration
    "attention_small": (t_attn.tpu_config_space, "attention", (1, 8, 2, 2048, 128, 16)),
    "attention_full": (t_attn.tpu_config_space, "attention", (1, 4, 4, 1024, 64, 32, False)),
    "wkv": (t_wkv.tpu_config_space, "wkv", (64, 4096, 64)),
    "wkv_bf16": (t_wkv.tpu_config_space, "wkv", (8, 512, 32, 16)),
}
ESTIMATED = ("stencil25", "stencil25_ops", "lbm_d3q15", "lbm_d3q15_ops", "attention_small",
             "attention_full", "wkv", "wkv_bf16")


def _spaces(name: str):
    fn, ref_name, args = SPACES[name]
    ref_fn = getattr(__import__(f"repro.kernels.{ref_name}.ops", fromlist=["config_space"]), "config_space")
    return fn(*args), ref_fn(*args)


def _ir_data(ir) -> tuple:
    return (ir.name, tuple(dataclasses.astuple(f) for f in ir.fields),
            tuple(dataclasses.astuple(a) for a in ir.accesses), ir.iter_shape,
            ir.block, ir.flops_per_iter, ir.is_matmul, ir.scratch_bytes, ir.granularity, ir.meta)


def _est_data(est) -> dict:
    return {**dataclasses.asdict(est), "time": est.time, "limiter": est.limiter}


# --------------------------------------------------------------------------- #
# the machines and the mesh
# --------------------------------------------------------------------------- #


def test_tpu_machines_equal_jax():
    for name in ("TPU_V5E", "TPU_V6E"):
        got, want = getattr(tmach, name), getattr(jmach, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for bits in (8, 16, 32):
            assert got.peak_flops(bits) == want.peak_flops(bits)
            assert got.sublane_multiple(bits) == want.sublane_multiple(bits)
    assert list(tmach.MACHINES) == list(jmach.MACHINES)
    assert list(tmach.tpu_machines()) == list(jmach.tpu_machines())
    assert list(tmach.gpu_machines()) == list(jmach.gpu_machines())
    for spelling in ("tpuv5e", "TPUv6e", "tpu-v5e", "TPU_V6E", "h100", "A100-SXM4-40GB"):
        assert tmach.canonical_machine_name(spelling) == jmach.canonical_machine_name(spelling)
        assert dataclasses.asdict(tmach.get_machine(spelling)) == dataclasses.asdict(
            jmach.get_machine(spelling))
    with pytest.raises(KeyError) as got:
        tmach.canonical_machine_name("tpuv7")
    with pytest.raises(KeyError) as want:
        jmach.canonical_machine_name("tpuv7")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mesh", ["SINGLE_DEVICE_MESH", "SINGLE_POD_MESH", "MULTI_POD_MESH"])
def test_axis_bandwidth_equals_jax(mesh):
    got, want = getattr(tmach, mesh), getattr(jmach, mesh)
    assert got.axes == want.axes and got.inter_pod_axes == want.inter_pod_axes
    for axis, _ in want.axes:
        assert got.axis_bandwidth(axis) == want.axis_bandwidth(axis)
        for name in ("TPU_V5E", "TPU_V6E"):
            assert got.axis_bandwidth(axis, getattr(tmach, name)) == want.axis_bandwidth(
                axis, getattr(jmach, name))
        for key in tmach.MACHINES:
            assert got.bandwidth(axis, tmach.MACHINES[key]) == want.bandwidth(axis, jmach.MACHINES[key])


# --------------------------------------------------------------------------- #
# tracing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(SPACES))
def test_trace_pallas_equals_jax(name):
    got_cfgs, want_cfgs = _spaces(name)
    assert [(c.name, c.grid, c.flops_per_step, c.is_matmul, c.scratch_bytes, c.meta) for c in got_cfgs] == [
        (c.name, c.grid, c.flops_per_step, c.is_matmul, c.scratch_bytes, c.meta) for c in want_cfgs]
    got = [tpallas.trace_pallas(c) for c in got_cfgs]
    want = [jpallas.trace_pallas(c) for c in want_cfgs]
    assert [tir.ir_fingerprint(i) for i in got] == [jir.ir_fingerprint(i) for i in want]
    assert [_ir_data(i) for i in got] == [_ir_data(i) for i in want]
    assert len(got) > 0


@pytest.mark.parametrize("index_map, grid", [
    (lambda i: (min(i + 1, 2),), (4,)),  # clamped at the far corner
    (lambda i, j: (i * j, 0), (3, 3)),  # a cross term
    (lambda i, j: (i * i, j), (4, 2)),  # curvature along one dim
    (lambda i: (i, 0) if i < 2 else (i,), (4,)),  # the output rank changes
])
def test_non_affine_error_equals_jax(index_map, grid):
    with pytest.raises(tpallas.NonAffineIndexMapError) as got:
        tpallas.trace_index_map(index_map, grid, kernel="clamped", operand="x")
    with pytest.raises(jpallas.NonAffineIndexMapError) as want:
        jpallas.trace_index_map(index_map, grid, kernel="clamped", operand="x")
    g, w = got.value, want.value
    assert str(g) == str(w) and "clamped.x" in str(g)
    assert (g.kernel, g.operand, g.point, g.want, g.got) == (w.kernel, w.operand, w.point, w.want, w.got)
    assert g.finding.to_json() == w.finding.to_json() and g.finding.rule == "trace.non_affine"


def test_trace_index_map_equals_jax_on_affine_maps():
    for index_map, grid in ((lambda i, j: (2 * i + 1, j - 3, 0), (4, 5)), (lambda i: (0, i), (1,)),
                            (lambda b, h, g, i, j: (b * 8 + h * 2 + g, i, 0), (2, 4, 2, 3, 3))):
        assert tpallas.trace_index_map(index_map, grid) == jpallas.trace_index_map(index_map, grid)


# --------------------------------------------------------------------------- #
# the estimator
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ESTIMATED)
@pytest.mark.parametrize("machine", TPUS)
def test_estimates_and_ranking_equal_jax(name, machine):
    got_cfgs, want_cfgs = _spaces(name)
    m, jm = tmach.get_machine(machine), jmach.get_machine(machine)
    got = [tte.estimate(c, m) for c in got_cfgs]
    want = [jte.estimate(c, jm) for c in want_cfgs]
    assert [_est_data(e) for e in got] == [_est_data(e) for e in want]
    irs = [tpallas.trace_pallas(c) for c in got_cfgs]
    assert [_est_data(tte.estimate_ir(ir, m)) for ir in irs] == [_est_data(e) for e in got]
    ranked, ref_ranked = tte.rank_configs(got_cfgs, m), jte.rank_configs(want_cfgs, jm)
    assert [(c.name, _est_data(e)) for c, e in ranked] == [(c.name, _est_data(e)) for c, e in ref_ranked]
    best, ref_best = tte.select_config(got_cfgs, m), jte.select_config(want_cfgs, jm)
    assert (best[0].name, _est_data(best[1])) == (ref_best[0].name, _est_data(ref_best[1]))
    recs = tte.TPUPallasEstimator().estimate_batch(irs, m)
    ref_recs = jte.TPUPallasEstimator().estimate_batch([jpallas.trace_pallas(c) for c in want_cfgs], jm)
    assert [dataclasses.asdict(r) for r in recs] == [dataclasses.asdict(r) for r in ref_recs]
    cfg = {"name": got_cfgs[0].name, **got_cfgs[0].meta}
    rec, ref_rec = trecord.tpu_record(cfg, got[0], "fp"), jrecord.tpu_record(cfg, want[0], "fp")
    assert dataclasses.asdict(rec) == dataclasses.asdict(ref_rec) and rec.backend == "tpu"
    assert trecord.record_payload(rec) == jrecord.record_payload(ref_rec)
    back = trecord.record_from_payload(trecord.record_payload(rec))
    assert dataclasses.asdict(back) == dataclasses.asdict(jrecord.record_from_payload(jrecord.record_payload(ref_rec)))


def _matmul(te, M, bm, bits):
    return te.PallasConfig(
        name=f"mm{bm}", grid=(M // bm, M // bm, M // bm),
        accesses=(te.BlockAccess("A", (bm, bm), lambda i, j, k: (i, k), bits),
                  te.BlockAccess("B", (bm, bm), lambda i, j, k: (k, j), bits),
                  te.BlockAccess("O", (bm, bm), lambda i, j, k: (i, j), bits, True)),
        flops_per_step=2.0 * bm ** 3)


@pytest.mark.parametrize("machine", TPUS)
def test_vmem_gate_and_ragged_lanes_equal_jax(machine):
    m, jm = tmach.get_machine(machine), jmach.get_machine(machine)
    huge, ref_huge = _matmul(tte, 8192, 8192, 32), _matmul(jte, 8192, 8192, 32)
    est = tte.estimate(huge, m)
    assert not est.feasible and _est_data(est) == _est_data(jte.estimate(ref_huge, jm))
    with pytest.raises(ValueError) as got:
        tte.select_config([huge], m)
    with pytest.raises(ValueError) as want:
        jte.select_config([ref_huge], jm)
    assert str(got.value) == str(want.value)
    for lanes in (128, 100, 260):
        cfg = tte.PallasConfig("x", (4,), (tte.BlockAccess("x", (8, lanes), lambda i: (i, 0), 32),), 0.0)
        ref = jte.PallasConfig("x", (4,), (jte.BlockAccess("x", (8, lanes), lambda i: (i, 0), 32),), 0.0)
        assert _est_data(tte.estimate(cfg, m)) == _est_data(jte.estimate(ref, jm))
    cands = [_matmul(tte, 4096, b, 16) for b in (128, 256, 512, 1024)]
    ref_cands = [_matmul(jte, 4096, b, 16) for b in (128, 256, 512, 1024)]
    assert [(c.name, _est_data(e)) for c, e in tte.rank_configs(cands, m)] == [
        (c.name, _est_data(e)) for c, e in jte.rank_configs(ref_cands, jm)]


# --------------------------------------------------------------------------- #
# the graph on the TPU backend
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_trace_step_tpu_equals_jax(arch):
    cfg, ref_cfg = get_arch(arch).smoke(), jax_get_arch(arch).smoke()
    for kind in ("forward", "train"):
        for mesh in (None, "data=2,model=2", "pod=2,data=2,model=2"):
            dag = trace_step(cfg, batch=8, seq=128, mesh=mesh, backend="tpu", kind=kind)
            ref = jax_trace_step(ref_cfg, batch=8, seq=128, mesh=mesh, backend="tpu", kind=kind)
            assert dag.meta == ref.meta and list(dag.nodes) == list(ref.nodes)
            assert [_node_fields(n) for n in dag.nodes.values()] == [_node_fields(n) for n in ref.nodes.values()]
            assert [_ir_data(n.ir) for n in dag.compute_nodes] == [_ir_data(n.ir) for n in ref.compute_nodes]
            for machine in TPUS:
                rep = step_time(cfg, machine, batch=8, seq=128, mesh=mesh, kind=kind, dag=dag)
                want = jax_step_time(ref_cfg, machine, batch=8, seq=128, mesh=mesh, kind=kind, dag=ref)
                assert_reports_equal(rep, want, nodes=False)


# --------------------------------------------------------------------------- #
# lowering a block-granular IR back to a PallasConfig
# --------------------------------------------------------------------------- #


def _matmul_cfg(te):
    return te.PallasConfig(
        name="mm",
        grid=(4, 3, 2),
        accesses=(
            te.BlockAccess("A", (128, 64), lambda i, j, k: (i, k), 16),
            te.BlockAccess("B", (64, 128), lambda i, j, k: (k, j), 16),
            te.BlockAccess("O", (128, 128), lambda i, j, k: (i, j), 16, True),
        ),
        flops_per_step=7.0,
        is_matmul=True,
        scratch_bytes=256,
        meta={"bm": 128},
    )


def _cfg_data(cfg) -> tuple:
    grid_points = [(0,) * len(cfg.grid), tuple(g - 1 for g in cfg.grid)]
    return (cfg.name, cfg.grid, cfg.flops_per_step, cfg.is_matmul, cfg.scratch_bytes, cfg.meta,
            tuple((a.name, a.block_shape, a.dtype_bits, a.is_output, tuple(a.index_map(*p) for p in grid_points))
                  for a in cfg.accesses))


def test_trace_pallas_roundtrips_with_lower_tpu():
    from repro.frontend.lower import lower_tpu as jax_lower_tpu
    from repro_torch.frontend.lower import lower_tpu

    ir = tpallas.trace_pallas(_matmul_cfg(tte))
    ref_ir = jpallas.trace_pallas(_matmul_cfg(jte))
    assert ir.granularity == "block" and ir.iter_shape == (4, 3, 2) and ir.scratch_bytes == 256
    assert tpallas.trace_pallas(lower_tpu(ir)) == ir
    assert _cfg_data(lower_tpu(ir)) == _cfg_data(jax_lower_tpu(ref_ir))
    for m, jm in ((tmach.TPU_V5E, jmach.TPU_V5E), (tmach.TPU_V6E, jmach.TPU_V6E)):
        assert _est_data(tte.estimate(lower_tpu(ir), m)) == _est_data(tte.estimate_ir(ir, m))
        assert _est_data(tte.estimate(lower_tpu(ir), m)) == _est_data(jte.estimate(jax_lower_tpu(ref_ir), jm))


@pytest.mark.parametrize("name", ["stencil25_ops", "lbm_d3q15_ops", "attention_full", "wkv"])
def test_lower_tpu_roundtrips_every_pallas_space(name):
    from repro_torch.frontend.lower import lower_tpu

    got_cfgs, _ = _spaces(name)
    for cfg in got_cfgs:
        ir = tpallas.trace_pallas(cfg)
        assert tpallas.trace_pallas(lower_tpu(ir)) == ir


def test_lower_tpu_on_the_analysis_fixture_equals_jax():
    from repro.analysis.fixtures import FIXTURES as JAX_FIXTURES
    from repro.frontend.lower import lower_tpu as jax_lower_tpu
    from repro_torch.analysis.fixtures import FIXTURES
    from repro_torch.frontend.lower import lower_gpu, lower_tpu

    ir, ref_ir = FIXTURES["block_revisit_parallel"](), JAX_FIXTURES["block_revisit_parallel"]()
    cfg = lower_tpu(ir)
    assert _cfg_data(cfg) == _cfg_data(jax_lower_tpu(ref_ir))
    # the fixture declares fields larger than its blocks reach; a traced IR
    # takes them from the blocks, in both packages
    assert _ir_data(tpallas.trace_pallas(cfg)) == _ir_data(jpallas.trace_pallas(jax_lower_tpu(ref_ir)))
    assert _est_data(tte.estimate(cfg)) == _est_data(jte.estimate(jax_lower_tpu(ref_ir)))
    # tests/test_analysis.py's use: the lint gate refuses the racy config before estimating it
    from repro_torch.analysis import LintError
    from repro_torch.explore.study import Study

    study = Study("attention", backend="tpu", configs=[cfg], machine="TPUv5e", lint="error")
    with pytest.raises(LintError, match="race.write_write"):
        study.run()
    assert len(study.cache) == 0
    with pytest.raises(ValueError, match="element-granular") as got:
        lower_tpu(FIXTURES["racy_store"]())
    with pytest.raises(ValueError) as want:
        jax_lower_tpu(JAX_FIXTURES["racy_store"]())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="block-granular") as got:
        lower_gpu(ir)
    from repro.frontend.lower import lower_gpu as jax_lower_gpu

    with pytest.raises(ValueError) as want:
        jax_lower_gpu(ref_ir)
    assert str(got.value) == str(want.value)
