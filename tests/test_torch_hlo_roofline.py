"""The port's ``core.hlo_analysis`` and ``core.roofline`` held ``==`` to the
JAX package's, and the port-side H100 roofline machine checked by hand.

* ``analyze_hlo``, ``analyze_collectives``, ``shape_bytes`` and
  ``cost_analysis_scalars`` on the synthetic text of ``tests/test_infra.py``
  and on texts with every collective kind, ``-start``/``-done`` pairs,
  nested while loops with trip counts, fusions, a dynamic-update-slice and
  both ``replica_groups`` spellings;
* ``build_report(...).to_dict()`` over both pod meshes, 16 and 32 bits,
  both TPUs and several ``CollectiveStats``; ``model_flops_lm``;
* ``core.gpu_roofline.H100_ROOFLINE``: each of ``build_report``'s three
  terms against arithmetic written out here.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.core import hlo_analysis as jh
from repro.core import machine as jm
from repro.core import roofline as jr
from repro_torch.core import hlo_analysis as th
from repro_torch.core import machine as tm
from repro_torch.core import roofline as tr
from repro_torch.core.gpu_roofline import H100_ROOFLINE, GPURooflineMachine

SYNTHETIC = """
HloModule test

%region_1.2 (a: f32[128,128]) -> f32[128,128] {
  %p = f32[128,128] parameter(0)
  %d = f32[128,128] dot(%p, %p), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[128,128] all-reduce(%d), replica_groups={{0,1,2,3}}, to_apply=%add
}

ENTRY %main.1 (x: f32[128,128]) -> f32[128,128] {
  %x = f32[128,128] parameter(0)
  %w = f32[128,128] while(%x), condition=%cond.1, body=%region_1.2, backend_config={"known_trip_count":{"n":"10"}}
  ROOT %r = f32[128,128] add(%w, %w)
}
"""

EVERY_KIND = """
HloModule kinds

%fused_computation.3 (p0: bf16[64,256], p1: bf16[256,32]) -> bf16[64,32] {
  %p0 = bf16[64,256] parameter(0)
  %p1 = bf16[256,32] parameter(1)
  ROOT %dot.9 = bf16[64,32] dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%inner_body.7 (t: (s32[], f32[16,512])) -> (s32[], f32[16,512]) {
  %t = (s32[], f32[16,512]) parameter(0)
  %g = f32[16,512] get-tuple-element(%t), index=1
  %ag = f32[256,512] all-gather(%g), replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[1,512] reduce-scatter(%g), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}, to_apply=%add
  %a2a = bf16[16,512] all-to-all(%g), replica_groups=[32,8]<=[256], dimensions={0}
  %cp = f32[16,512] collective-permute(%g), source_target_pairs={{0,1},{1,0}}
  %ags = (f32[16,512], f32[256,512]) all-gather-start(%g), replica_groups=[16,16]<=[256], dimensions={0}
  %agd = f32[256,512] all-gather-done(%ags)
  %ars = f32[16,512] all-reduce-start(%g), replica_groups={{0,1}}, to_apply=%add
  %ard = f32[16,512] all-reduce-done(%ars)
  %rag = f32[16,512] ragged-all-to-all(%g, %g, %o, %s, %o, %s), replica_groups=[64,4]<=[256]
  ROOT %out = (s32[], f32[16,512]) tuple(%i, %g)
}

%outer_body.5 (u: (s32[], f32[16,512])) -> (s32[], f32[16,512]) {
  %u = (s32[], f32[16,512]) parameter(0)
  %w2 = (s32[], f32[16,512]) while(%u), condition=%c2, body=%inner_body.7, backend_config={"known_trip_count":{"n":"3"}}
  %lhs = bf16[64,256] parameter(1)
  %rhs = bf16[256,32] constant({...})
  %f = bf16[64,32] fusion(%lhs, %rhs), kind=kOutput, calls=%fused_computation.3
  %buf = f32[1024,512] parameter(2)
  %upd = f32[16,512] parameter(3)
  %dus = f32[1024,512] dynamic-update-slice(%buf, %upd, %i0, %i1)
  ROOT %r = (s32[], f32[16,512]) tuple(%i, %g)
}

ENTRY %main.11 (x: (s32[], f32[16,512])) -> (s32[], f32[16,512]) {
  %x = (s32[], f32[16,512]) parameter(0)
  %w1 = (s32[], f32[16,512]) while(%x), condition=%c1, body=%outer_body.5, backend_config={"known_trip_count":{"n":"4"}}
  %a = f32[32,64] parameter(1)
  %b = f32[64,8] parameter(2)
  %d = f32[32,8] dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %e = f32[32,8] dot(f32[32,64] %a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %small = s4[100]{0} convert(%q)
  %pr = pred[7,3] compare(%m, %n), direction=LT
  ROOT %r = (s32[], f32[16,512]) tuple(%i, %g)
}
"""

UNTRIPPED = """
HloModule loose
ENTRY %entry.1 (x: f32[8]) -> f32[8] {
  %w = f32[8] while(%x), condition=%c, body=%body.2
  %ar = f32[8,8] all-reduce(%x), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
}
%body.2 (y: f32[8]) -> f32[8] {
  %z = f32[8,4] all-gather(%y), dimensions={0}
}
"""

TEXTS = {"synthetic": SYNTHETIC, "every_kind": EVERY_KIND, "untripped": UNTRIPPED}


def _asdict(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("name", sorted(TEXTS))
@pytest.mark.parametrize("default_group", [1, 4])
def test_analyze_hlo_equals_the_reference(name, default_group):
    ref = jh.analyze_hlo(TEXTS[name], default_group=default_group)
    got = th.analyze_hlo(TEXTS[name], default_group=default_group)
    assert _asdict(got) == _asdict(ref)
    assert got.collectives.total_wire_bytes == ref.collectives.total_wire_bytes
    assert got.collectives.by_kind() == ref.collectives.by_kind()
    assert got.collectives.counts() == ref.collectives.counts()
    assert got.collectives.wire_bytes_by_group_size() == ref.collectives.wire_bytes_by_group_size()


def test_every_text_reaches_the_parts_it_is_meant_to():
    """The texts exercise what they claim: loop multipliers nest, every kind
    and both group spellings are read (so the equality above means
    something)."""
    rep = th.analyze_hlo(EVERY_KIND)
    assert rep.multipliers["outer_body.5"] == 4 and rep.multipliers["inner_body.7"] == 12
    assert set(rep.collectives.counts()) == set(th.COLLECTIVE_OPS)
    assert {o.group_size for o in rep.collectives.ops} >= {16, 8, 4, 2}
    assert rep.n_while == 2 and rep.flops > 0 and rep.bytes > 0
    assert th.analyze_hlo(SYNTHETIC).flops == 10 * 2 * 128**3


@pytest.mark.parametrize("name", sorted(TEXTS))
@pytest.mark.parametrize("default_group", [1, 16])
def test_analyze_collectives_equals_the_reference(name, default_group):
    ref = jh.analyze_collectives(TEXTS[name], default_group=default_group)
    got = th.analyze_collectives(TEXTS[name], default_group=default_group)
    assert _asdict(got) == _asdict(ref)


@pytest.mark.parametrize("text", ["f32[128,128]", "(bf16[4,8], s4[3], u1[16], c128[2])", "pred[] f8e4m3fn[7,9]",
                                  "x[3] f32[] tuple()", EVERY_KIND])
def test_shape_bytes_equals_the_reference(text):
    assert th.shape_bytes(text) == jh.shape_bytes(text)


@pytest.mark.parametrize("cost", [None, [], [{"flops": 3, "bytes accessed": 2.5, "utilization": "x"}],
                                  {"flops": 1e12, "transcendentals": 7, "name": "m"}])
def test_cost_analysis_scalars_equals_the_reference(cost):
    assert th.cost_analysis_scalars(cost) == jh.cost_analysis_scalars(cost)


@pytest.mark.parametrize("kind", th.COLLECTIVE_OPS + ("unknown",))
@pytest.mark.parametrize("n", [1, 2, 16, 512])
def test_ring_model_equals_the_reference(kind, n):
    assert th.collective_wire_bytes(kind, 12345.0, n) == jh.collective_wire_bytes(kind, 12345.0, n)


# --------------------------------------------------------------------------- #
# roofline


def _stats(mod, ops):
    return mod.CollectiveStats(ops=[mod.CollectiveOp(kind=k, result_bytes=rb, group_size=n,
                                                     wire_bytes=mod._wire_bytes(k, rb, n)) for k, rb, n in ops])


COLLECTIVES = {
    "none": [],
    "data_and_model": [("all-gather", 4e6, 16), ("reduce-scatter", 2.5e5, 16), ("all-reduce", 1e3, 16)],
    "pod_and_world": [("all-reduce", 8e6, 2), ("all-gather", 3e7, 512), ("all-to-all", 1e6, 32)],
    "odd_groups": [("collective-permute", 5e5, 4), ("all-reduce", 7e5, 256), ("all-gather", 1e4, 3)],
}
MESHES = {"single": ("SINGLE_POD_MESH",), "multi": ("MULTI_POD_MESH",)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("coll", sorted(COLLECTIVES))
@pytest.mark.parametrize("machine", ["TPU_V5E", "TPU_V6E"])
def test_build_report_equals_the_reference(mesh, bits, coll, machine):
    (mesh_name,) = MESHES[mesh]
    cost = {"flops": 3.7e14, "bytes accessed": 1.9e12, "transcendentals": 5.0}
    kw = dict(cell=f"arch/shape/{mesh}", cost=cost, model_flops=7.3e16, dtype_bits=bits, notes="n")
    ref = jr.build_report(mesh=getattr(jm, mesh_name), collectives=_stats(jh, COLLECTIVES[coll]),
                          machine=getattr(jm, machine), **kw)
    got = tr.build_report(mesh=getattr(tm, mesh_name), collectives=_stats(th, COLLECTIVES[coll]),
                          machine=getattr(tm, machine), **kw)
    assert got.to_dict() == ref.to_dict()
    assert (got.time, got.peak_flops) == (ref.time, ref.peak_flops)


def test_build_report_defaults_to_tpu_v5e_as_the_reference():
    kw = dict(cell="c", cost={"flops": 1e12}, model_flops=1e15)
    ref = jr.build_report(mesh=jm.SINGLE_POD_MESH, collectives=_stats(jh, COLLECTIVES["data_and_model"]), **kw)
    got = tr.build_report(mesh=tm.SINGLE_POD_MESH, collectives=_stats(th, COLLECTIVES["data_and_model"]), **kw)
    assert got.to_dict() == ref.to_dict()
    assert tr.RooflineReport("c", 1, 0, 0, 0, 0).to_dict() == jr.RooflineReport("c", 1, 0, 0, 0, 0).to_dict()


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("active", [None, 3.3e10])
def test_model_flops_lm_equals_the_reference(training, active):
    args = (1.3e11, 1048576.0)
    assert tr.model_flops_lm(*args, training=training, n_active_params=active) == jr.model_flops_lm(
        *args, training=training, n_active_params=active)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_axis_attribution_equals_the_reference(mesh):
    (name,) = MESHES[mesh]
    for g in (1, 2, 3, 4, 16, 32, 256, 512):
        assert tr._axis_for_group(getattr(tm, name), g) == jr._axis_for_group(getattr(jm, name), g)


# --------------------------------------------------------------------------- #
# the port-side H100 machine, by hand


def test_h100_machine_answers_build_reports_five_questions():
    m = H100_ROOFLINE
    assert isinstance(m, GPURooflineMachine) and m.gpu is tm.H100_SXM
    assert m.peak_flops(16) == 989e12 and m.peak_flops(8) == 989e12
    assert m.peak_flops(32) == 66.9e12 == tm.H100_SXM.peak_fp32
    assert m.bw_hbm == 3.35e12
    assert m.bw_ici_link == m.bw_link == 450e9
    assert m.bw_inter_pod == m.bw_inter_node == 50e9
    assert tm.MULTI_POD_MESH.axis_bandwidth("data", m) == 450e9
    assert tm.MULTI_POD_MESH.axis_bandwidth("pod", m) == 50e9


def test_h100_terms_by_hand():
    """One term a machine question: 989 TFLOP at 16 bits is one second,
    3.35 TB one second; a 16-wide axis moves its ring bytes at 450 GB/s,
    the pod axis at 50 GB/s, a group no axis has at twice the link."""
    stats = _stats(th, [("all-gather", 9e9, 16), ("all-reduce", 1e9, 2), ("all-gather", 4e9, 4)])
    rep = tr.build_report(cell="c", mesh=tm.MULTI_POD_MESH,
                          cost={"flops": 989e12, "bytes accessed": 6.7e12}, collectives=stats,
                          model_flops=512 * 989e12 / 2, machine=H100_ROOFLINE)
    assert rep.t_compute == 1.0 and rep.t_memory == 2.0
    data_wire, pod_wire, odd_wire = 9e9 * 15 / 16, 2 * 1e9 * 1 / 2, 4e9 * 3 / 4
    assert rep.per_axis["data"]["seconds"] == pytest.approx(data_wire / 450e9)
    assert rep.per_axis["pod"]["seconds"] == pytest.approx(pod_wire / 50e9)
    assert rep.per_axis["group4"]["bandwidth"] == 900e9
    assert rep.t_collective == pytest.approx(data_wire / 450e9 + pod_wire / 50e9 + odd_wire / 900e9)
    assert rep.dominant == "memory" and rep.roofline_fraction == pytest.approx(0.25)
    r32 = tr.build_report(cell="c", mesh=tm.SINGLE_POD_MESH, cost={"flops": 66.9e12}, collectives=th.CollectiveStats(),
                          model_flops=0.0, dtype_bits=32, machine=H100_ROOFLINE)
    assert r32.t_compute == 1.0 and r32.peak_flops == 66.9e12
