"""The port's whole-model estimator (``repro_torch.graph``) against
``repro.graph``, equal with ``==``, not within a tolerance.

* **smoke configs:** every ``ARCH_IDS`` entry's ``smoke()`` config, kinds
  ``forward`` and ``train``, meshes ``None``, ``data=2,model=2`` and
  ``pod=2,data=2,model=2``, on V100, A100 and H100 (batch 8, seq 128).  Per
  (config, kind, mesh) each package traces once and prices the one DAG on
  the three machines through one shared ``EstimateCache``
  (``step_time(..., dag=, cache=)``), as a user re-pricing a trace does;
* **compared:** the DAG node by node (ids, kinds, deps, fingerprints,
  ``repeat``, collective kind, bytes and axis, ``meta``), the durations, the
  step time, ``render()``, ``render_json()`` (which carries the critical
  path, the slack table, the overlap fraction, the utilization and the
  limiter attribution, every float as ``repr``) and the Chrome events;
* **single device:** the makespan is the fold of the node durations in
  schedule order, exactly;
* **replay:** ``tests/test_replay.py``'s deterministic cases on the port's
  ``Replayer``, its seeded properties with both packages' replays held
  equal, and a hypothesis strategy over 64-bit floats.

The full-width calls of ``chip_smoke.py``'s phase ``step_time``, the CLI and
the kernel classes are in ``tests/test_torch_step_time.py`` (a file of its
own, so that the two run side by side under ``--dist loadfile``).
"""
from __future__ import annotations

import functools
import json
import random

import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.core.estimator import EstimateCache as JaxCache
from repro.core.machine import MeshSpec as JaxMeshSpec
from repro.graph import GraphNode as JaxNode
from repro.graph import KernelDAG as JaxDAG
from repro.graph import Replayer as JaxReplayer
from repro.graph import step_time as jax_step_time
from repro_torch.configs import get_arch
from repro_torch.core.estimator import EstimateCache
from repro_torch.core.machine import SINGLE_DEVICE_MESH, MeshSpec
from repro_torch.graph import GraphNode, KernelDAG, Replayer, axis_groups, step_time
from repro_torch.graph.classes import schedule_sum
from repro_torch.obs.trace import validate_chrome_trace

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

KINDS = ("forward", "train")
MESHES = (None, "data=2,model=2", "pod=2,data=2,model=2")
MACHINES = ("V100", "A100", "H100")
SMOKE_BATCH, SMOKE_SEQ = 8, 128


def _node_fields(node) -> tuple:
    return (node.id, node.kind, node.deps, node.fingerprint, node.repeat, node.comm_kind,
            node.comm_bytes, node.axis, node.time_s, node.meta)


def assert_reports_equal(port, ref, nodes: bool = True) -> None:
    """``nodes=False`` skips the node-by-node DAG check (for a DAG already
    checked under another machine)."""
    assert port.dag.mesh.axes == ref.dag.mesh.axes
    assert port.dag.meta == ref.dag.meta
    assert list(port.dag.nodes) == list(ref.dag.nodes)
    for nid, node in port.dag.nodes.items() if nodes else ():
        assert _node_fields(node) == _node_fields(ref.dag.nodes[nid]), nid
    assert port.durations == ref.durations
    assert list(port.unique) == list(ref.unique)
    assert port.step_time_s == ref.step_time_s
    assert port.render() == ref.render()
    assert port.render_json() == ref.render_json()
    assert port.replay.chrome_events() == ref.replay.chrome_events()


@functools.lru_cache(maxsize=None)
def _smoke_reports(arch: str, kind: str, mesh: str | None) -> dict:
    """machine -> (port report, JAX report): one trace per package, priced on
    every machine through one cache per package."""
    cfg, ref_cfg = get_arch(arch).smoke(), jax_get_arch(arch).smoke()
    cache, ref_cache = EstimateCache(), JaxCache()
    out, dag, ref_dag = {}, None, None
    for machine in MACHINES:
        rep = step_time(cfg, machine, mesh=mesh, batch=SMOKE_BATCH, seq=SMOKE_SEQ, kind=kind,
                        dag=dag, cache=cache)
        ref = jax_step_time(ref_cfg, machine, mesh=mesh, batch=SMOKE_BATCH, seq=SMOKE_SEQ, kind=kind,
                            dag=ref_dag, cache=ref_cache)
        dag, ref_dag = rep.dag, ref.dag
        out[machine] = (rep, ref)
    return out


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m or "single")
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_step_time_equals_jax(arch, kind, mesh, machine):
    reports = _smoke_reports(arch, kind, mesh)
    rep, ref = reports[machine]
    # the machines share one traced DAG: its nodes are checked under the first
    assert all(r.dag is rep.dag for r, _ in reports.values())
    assert_reports_equal(rep, ref, nodes=machine == MACHINES[0])
    assert rep.machine.name == ref.machine.name
    if mesh is None:
        assert not rep.dag.collective_nodes
        assert rep.step_time_s == schedule_sum(rep)
    else:
        assert rep.dag.collective_nodes


# --------------------------------------------------------------------------- #
# replay: tests/test_replay.py's cases on the port's Replayer
# --------------------------------------------------------------------------- #

MESH_1 = SINGLE_DEVICE_MESH
MESH_D2 = MeshSpec(axes=(("data", 2),))
MESH_2X2 = MeshSpec(axes=(("data", 2), ("model", 2)))


def _compute(nid, t, deps=(), node=GraphNode):
    return node(id=nid, kind="compute", time_s=t, deps=tuple(deps))


def _coll(nid, t, axis, deps=(), kind="all-reduce", node=GraphNode):
    return node(id=nid, kind="collective", comm_kind=kind, axis=axis, time_s=t, deps=tuple(deps))


def _dag(mesh, nodes, dag_cls=KernelDAG):
    dag = dag_cls(mesh=mesh)
    for n in nodes:
        dag.add(n)
    return dag


def test_chain_exact():
    dag = _dag(MESH_1, [_compute("a", 1.0), _compute("b", 2.0, ["a"]), _compute("c", 0.5, ["b"])])
    res = Replayer(dag).run()
    assert res.makespan == 1.0 + 2.0 + 0.5
    assert [s.node_id for s in res.critical_path()] == ["a", "b", "c"]
    assert res.utilization() == {0: 1.0}
    assert all(v == 0.0 for v in res.slack().values())


def test_diamond_single_device_serializes():
    dag = _dag(MESH_1, [_compute("a", 1.0), _compute("b", 2.0, ["a"]), _compute("c", 3.0, ["a"]),
                        _compute("d", 1.0, ["b", "c"])])
    res = Replayer(dag).run()
    assert res.makespan == 1.0 + 2.0 + 3.0 + 1.0
    assert [s.node_id for s in res.schedule] == ["a", "b", "c", "d"]
    d = next(s for s in res.schedule if s.node_id == "d")
    assert d.binding == "dep" and d.pred[0] == "c"


def test_fork_join_spmd_is_device_count_invariant():
    def nodes():
        return [_compute("a", 1.0), _compute("b", 2.0, ["a"]), _compute("c", 3.0, ["a"]),
                _compute("d", 1.0, ["b", "c"])]
    t1 = Replayer(_dag(MESH_1, nodes())).run().makespan
    t2 = Replayer(_dag(MESH_D2, nodes())).run().makespan
    assert t1 == t2 == 7.0


def test_comm_overlap_hidden_under_compute():
    dag = _dag(MESH_D2, [_compute("a", 4.0), _coll("g", 2.0, "data", kind="all-gather"),
                         _compute("b", 1.0, ["a", "g"])])
    res = Replayer(dag).run()
    assert res.makespan == 5.0
    assert res.overlap_fraction() == 1.0
    g = next(s for s in res.schedule if s.node_id == "g")
    assert g.devices == (0, 1) and g.start == 0.0
    b = next(s for s in res.schedule if s.node_id == "b" and s.devices == (0,))
    assert b.binding == "dep" and b.pred == ("a", 0)


def test_comm_on_dependency_chain_is_exposed():
    dag = _dag(MESH_D2, [_compute("a", 1.0), _coll("r", 2.0, "data", deps=["a"]), _compute("b", 1.0, ["r"])])
    res = Replayer(dag).run()
    assert res.makespan == 4.0
    assert res.overlap_fraction() == 0.0
    assert [s.node_id for s in res.critical_path()] == ["a", "r", "b"]


def test_collective_groups_by_axis():
    assert axis_groups(MESH_2X2, "model") == [(0, 1), (2, 3)]
    assert axis_groups(MESH_2X2, "data") == [(0, 2), (1, 3)]
    dag = _dag(MESH_2X2, [_compute("a", 1.0), _coll("r", 0.5, "model", deps=["a"]), _compute("b", 1.0, ["r"])])
    res = Replayer(dag).run()
    assert res.makespan == 2.5
    assert sorted(s.devices for s in res.schedule if s.node_id == "r") == [(0, 1), (2, 3)]


def test_repeat_is_a_duration_multiplier_via_durations_map():
    dag = KernelDAG(mesh=MESH_1)
    dag.add(GraphNode(id="k", kind="compute", time_s=1.0, repeat=4))
    assert Replayer(dag, {"k": 4 * 0.75}).run().makespan == 3.0


def test_missing_and_negative_durations_rejected():
    bare = _dag(MESH_1, [GraphNode(id="k", kind="compute")])
    with pytest.raises(ValueError, match="neither IR nor time_s"):
        Replayer(bare)
    from repro_torch.graph.kernels import elementwise_ir

    ir, _ = elementwise_ir(256, backend="gpu")
    dag = KernelDAG(mesh=MESH_1)
    dag.compute("k", ir)
    with pytest.raises(ValueError, match="no duration"):
        Replayer(dag)
    with pytest.raises(ValueError, match="negative"):
        Replayer(dag, {"k": -1.0})


def test_cycle_rejected():
    with pytest.raises(ValueError, match="cycle"):
        Replayer(_dag(MESH_1, [_compute("a", 1.0, ["b"]), _compute("b", 1.0, ["a"])]))


def test_chrome_export_validates(tmp_path):
    dag = _dag(MESH_D2, [_compute("a", 1.0), _coll("g", 2.0, "data"), _compute("b", 1.0, ["a", "g"])])
    res = Replayer(dag).run()
    doc = res.to_chrome()
    assert validate_chrome_trace(doc) == []
    assert len([e for e in doc["traceEvents"] if e.get("ph") == "X"]) == 2 * 2 + 2
    p = tmp_path / "replay.json"
    n = res.export(p)
    assert validate_chrome_trace(json.loads(p.read_text())) == []
    assert n == len(doc["traceEvents"])


def _random_nodes(rng: random.Random, mesh, node=GraphNode):
    n = rng.randint(3, 10)
    comm_axes = [a for a, s in mesh.axes if s > 1]
    nodes = []
    for i in range(n):
        nid = f"n{i:02d}"
        deps = tuple(f"n{j:02d}" for j in range(i) if rng.random() < 0.4)
        t = round(rng.uniform(0.05, 2.0), 3)
        if comm_axes and rng.random() < 0.3:
            nodes.append(_coll(nid, t, rng.choice(comm_axes), deps, node=node))
        else:
            nodes.append(_compute(nid, t, deps, node=node))
    return nodes


def _longest_path(nodes) -> float:
    t = {}
    by_id = {n.id: n for n in nodes}

    def finish(nid):
        if nid not in t:
            n = by_id[nid]
            t[nid] = n.time_s + max((finish(d) for d in n.deps), default=0.0)
        return t[nid]
    return max(finish(n.id) for n in nodes)


def _jax_twin(mesh: MeshSpec, seed: int):
    """The same random DAG built from the JAX package's classes."""
    rng = random.Random(seed)
    jmesh = JaxMeshSpec(axes=mesh.axes)
    rng.choice([MESH_1, MESH_D2, MESH_2X2])  # keep the draw sequence aligned
    return _dag(jmesh, _random_nodes(rng, jmesh, node=JaxNode), dag_cls=JaxDAG)


@pytest.mark.parametrize("seed", range(25))
def test_makespan_dominates_busy_and_longest_path(seed):
    rng = random.Random(seed)
    mesh = rng.choice([MESH_1, MESH_D2, MESH_2X2])
    nodes = _random_nodes(rng, mesh)
    res = Replayer(_dag(mesh, nodes)).run()
    eps = 1e-9
    assert res.makespan + eps >= max(res.compute_busy.values())
    assert res.makespan + eps >= max(res.comm_busy.values(), default=0.0)
    assert res.makespan + eps >= _longest_path(nodes)
    slack = res.slack()
    assert all(v >= -eps for v in slack.values())
    assert min(slack.values()) <= eps
    assert validate_chrome_trace(res.to_chrome()) == []
    ref = JaxReplayer(_jax_twin(mesh, seed)).run()
    assert res.makespan == ref.makespan
    assert [(s.node_id, s.devices, s.start, s.finish, s.binding, s.pred) for s in res.schedule] == [
        (s.node_id, s.devices, s.start, s.finish, s.binding, s.pred) for s in ref.schedule]
    assert slack == ref.slack() and res.overlap_fraction() == ref.overlap_fraction()
    assert res.to_chrome() == ref.to_chrome()


@pytest.mark.parametrize("seed", range(25))
def test_insertion_order_permutation_invariance(seed):
    rng = random.Random(1000 + seed)
    mesh = rng.choice([MESH_1, MESH_D2, MESH_2X2])
    nodes = _random_nodes(rng, mesh)
    base = Replayer(_dag(mesh, nodes)).run()
    for _ in range(3):
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        perm = Replayer(_dag(mesh, shuffled)).run()
        assert perm.makespan == base.makespan
        assert [s.node_id for s in perm.critical_path()] == [s.node_id for s in base.critical_path()]
        assert perm.compute_busy == base.compute_busy


if HAVE_HYPOTHESIS:

    @st.composite
    def dag_strategy(draw):
        mesh = draw(st.sampled_from([MESH_1, MESH_D2, MESH_2X2]))
        n = draw(st.integers(3, 10))
        comm_axes = [a for a, s in mesh.axes if s > 1]
        nodes = []
        for i in range(n):
            deps = tuple(f"n{j:02d}" for j in range(i) if draw(st.booleans()))
            # 64-bit floats: 0.05 is no 32-bit float, and hypothesis refuses it there
            t = draw(st.floats(0.05, 2.0, allow_nan=False, width=64))
            if comm_axes and draw(st.booleans()):
                nodes.append(_coll(f"n{i:02d}", t, draw(st.sampled_from(comm_axes)), deps))
            else:
                nodes.append(_compute(f"n{i:02d}", t, deps))
        return mesh, nodes

    @settings(max_examples=50, deadline=None)
    @given(dag_strategy(), st.randoms(use_true_random=False))
    def test_hypothesis_invariants(mesh_nodes, rnd):
        mesh, nodes = mesh_nodes
        res = Replayer(_dag(mesh, nodes)).run()
        eps = 1e-9
        assert res.makespan + eps >= max(res.compute_busy.values())
        assert res.makespan + eps >= _longest_path(nodes)
        shuffled = list(nodes)
        rnd.shuffle(shuffled)
        assert Replayer(_dag(mesh, shuffled)).run().makespan == res.makespan
