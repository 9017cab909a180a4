"""Discrete-event replay of a :class:`~repro_torch.graph.dag.KernelDAG`:
a copy of ``repro.graph.replay``.

The per-kernel estimators predict *durations*; this module predicts the *step
time* that emerges when those durations contend for device lanes.  Each device
has two serial lanes — ``compute`` (kernel launches) and ``comm`` (collectives,
which modern runtimes overlap with compute) — and a collective is a barrier
across its mesh-axis group: it starts when every participant is ready and
occupies every participant's comm lane until it finishes.

Scheduling is deterministic list scheduling (Kahn's algorithm with a priority
heap keyed ``(ready_time, node id, instance)``): the schedule — and therefore
the predicted step time — depends only on the graph, never on node insertion
order (``tests/test_torch_graph.py`` property-tests the invariance).  All arithmetic
is plain float addition/max, so a single-device replay's makespan is *exactly*
the left-fold sum of its durations in schedule order.

The result knows how to explain itself: critical-path extraction (walking the
binding constraint — blocking dependency or lane predecessor — back from the
last finish), per-node dependency-path slack, per-device utilization,
compute/communication overlap fraction, and a Chrome-trace export of the
*predicted* timeline (one pid per device, compute/comm tids), valid under
``repro_torch.obs.trace.validate_chrome_trace`` and mergeable into a live obs tracer
via :meth:`ReplayResult.absorb_into`.
"""
from __future__ import annotations

import heapq
import json
from dataclasses import dataclass, field

from .dag import GraphNode, KernelDAG, axis_groups

# base latency of one collective (launch + rendezvous), added to the wire time
COLLECTIVE_LATENCY_S = 1e-6

# pid namespace for predicted-timeline chrome events: one pid per device,
# offset so predicted lanes never collide with real process pids in a merged
# pipeline trace
CHROME_PID_BASE = 1_000_000


@dataclass
class Scheduled:
    """One scheduled instance: a compute node on one device, or a collective
    on one device group."""

    node_id: str
    kind: str  # "compute" | "collective"
    devices: tuple[int, ...]  # one device (compute) or the axis group
    start: float
    finish: float
    ready: float  # max dependency finish (start - ready = lane wait)
    # what bound the start time: "dep" (a dependency finished last), "lane"
    # (the lane was still busy), or "start" (t=0, nothing bound it)
    binding: str
    pred: tuple[str, int] | None  # the binding predecessor instance key

    @property
    def duration(self) -> float:
        return self.finish - self.start


@dataclass
class ReplayResult:
    dag: KernelDAG
    makespan: float
    schedule: list[Scheduled]  # in scheduling order
    compute_busy: dict[int, float]
    comm_busy: dict[int, float]
    _by_key: dict = field(default_factory=dict, repr=False)

    # ---- derived reports -------------------------------------------------- #

    def utilization(self) -> dict[int, float]:
        """Per-device compute-lane utilization over the step."""
        if self.makespan <= 0.0:
            return {d: 0.0 for d in self.compute_busy}
        return {d: b / self.makespan for d, b in self.compute_busy.items()}

    def overlap_fraction(self) -> float:
        """Fraction of total comm-lane busy time hidden under compute."""
        total_comm = sum(self.comm_busy.values())
        if total_comm <= 0.0:
            return 0.0
        comp: dict[int, list[tuple[float, float]]] = {}
        comm: dict[int, list[tuple[float, float]]] = {}
        for s in self.schedule:
            box = comp if s.kind == "compute" else comm
            for d in s.devices:
                box.setdefault(d, []).append((s.start, s.finish))
        hidden = 0.0
        for d, spans in comm.items():
            for cs, cf in spans:
                for xs, xf in comp.get(d, ()):
                    lo, hi = max(cs, xs), min(cf, xf)
                    if hi > lo:
                        hidden += hi - lo
        return hidden / total_comm

    def critical_path(self) -> list[Scheduled]:
        """The chain of binding constraints ending at the last finish."""
        if not self.schedule:
            return []
        tail = max(self.schedule, key=lambda s: (s.finish, s.node_id, s.devices))
        path = [tail]
        seen = {(tail.node_id, tail.devices)}
        cur = tail
        while cur.pred is not None:
            cur = self._by_key[cur.pred]
            key = (cur.node_id, cur.devices)
            if key in seen:  # defensive: binding preds cannot cycle, but stay finite
                break
            seen.add(key)
            path.append(cur)
        path.reverse()
        return path

    def slack(self) -> dict[str, float]:
        """Per-node dependency-path slack: how much the node could stretch
        without lengthening its longest dependency chain past the makespan
        (resource/lane contention not charged).  Min over SPMD instances."""
        succ: dict[tuple, list[tuple]] = {}
        for s in self.schedule:
            succ[(s.node_id, s.devices)] = []
        keys = {(s.node_id, s.devices): s for s in self.schedule}
        for s in self.schedule:
            node = self.dag.nodes[s.node_id]
            for dep in node.deps:
                for key in keys:
                    if key[0] == dep and (set(key[1]) & set(s.devices)):
                        succ[key].append((s.node_id, s.devices))
        down: dict[tuple, float] = {}
        for s in reversed(self.schedule):  # schedule order is dep-topological
            key = (s.node_id, s.devices)
            tail = max((down[k] for k in succ[key]), default=0.0)
            down[key] = s.duration + tail
        out: dict[str, float] = {}
        for s in self.schedule:
            sl = self.makespan - (s.start + down[(s.node_id, s.devices)])
            prev = out.get(s.node_id)
            out[s.node_id] = sl if prev is None else min(prev, sl)
        return out

    # ---- predicted-timeline export ---------------------------------------- #

    def chrome_events(self) -> list[dict]:
        """Chrome-trace X events of the predicted timeline: one pid per
        device, tid 0 = compute lane, tid 1 = comm lane."""
        events: list[dict] = []
        for s in self.schedule:
            node = self.dag.nodes[s.node_id]
            for d in s.devices:
                events.append(
                    {
                        "name": s.node_id,
                        "ph": "X",
                        "ts": s.start * 1e6,
                        "dur": s.duration * 1e6,
                        "pid": CHROME_PID_BASE + d,
                        "tid": 0 if s.kind == "compute" else 1,
                        "args": {
                            "kind": node.comm_kind or "compute",
                            "repeat": node.repeat,
                            "binding": s.binding,
                        },
                    }
                )
        return events

    def to_chrome(self) -> dict:
        devices = sorted({d for s in self.schedule for d in s.devices})
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "ts": 0.0,
                "pid": CHROME_PID_BASE + d,
                "tid": 0,
                "args": {"name": f"predicted device {d}"},
            }
            for d in devices
        ]
        return {"traceEvents": meta + self.chrome_events(), "displayTimeUnit": "ms"}

    def export(self, path) -> int:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return len(doc["traceEvents"])

    def absorb_into(self, tracer) -> None:
        """Merge the predicted timeline into a live obs tracer, so one trace
        file shows the estimation pipeline AND the prediction it produced."""
        tracer.absorb({"epoch_wall": tracer.epoch_wall, "events": self.chrome_events()})


class Replayer:
    """Deterministic discrete-event replay of one :class:`KernelDAG`.

    ``durations`` maps node id -> full instance duration in seconds (already
    including ``repeat``); nodes absent from the map fall back to their
    ``time_s`` field (hand-built test DAGs set it directly).
    """

    def __init__(self, dag: KernelDAG, durations: dict[str, float] | None = None):
        dag.validate()
        self.dag = dag
        self.durations: dict[str, float] = {}
        for nid, node in dag.nodes.items():
            t = (durations or {}).get(nid, node.time_s)
            if t is None:
                raise ValueError(f"node {nid!r} has no duration (and no time_s)")
            if t < 0:
                raise ValueError(f"node {nid!r} has negative duration {t}")
            self.durations[nid] = float(t)

    def run(self) -> ReplayResult:
        dag = self.dag
        n = dag.mesh.n_devices
        groups_of: dict[str, list[tuple[int, ...]]] = {}
        gidx_of: dict[str, dict[int, int]] = {}
        for node in dag.collective_nodes:
            if node.axis not in groups_of:
                gs = axis_groups(dag.mesh, node.axis)
                groups_of[node.axis] = gs
                gidx_of[node.axis] = {d: gi for gi, g in enumerate(gs) for d in g}

        def instances(node: GraphNode) -> list[tuple[int, tuple[int, ...]]]:
            if node.kind == "compute":
                return [(d, (d,)) for d in range(n)]
            return list(enumerate(groups_of[node.axis]))

        def dep_key(dep: GraphNode, device: int) -> tuple[str, int]:
            if dep.kind == "compute":
                return (dep.id, device)
            return (dep.id, gidx_of[dep.axis][device])

        # build the instance-level dependency graph
        indeg: dict[tuple[str, int], int] = {}
        succ: dict[tuple[str, int], list[tuple[str, int]]] = {}
        devs: dict[tuple[str, int], tuple[int, ...]] = {}
        for node in dag.nodes.values():
            for inst, group in instances(node):
                key = (node.id, inst)
                devs[key] = group
                deps = {
                    dep_key(dag.nodes[d], dev) for d in node.deps for dev in group
                }
                indeg[key] = len(deps)
                for dk in deps:
                    succ.setdefault(dk, []).append(key)

        ready_time: dict[tuple[str, int], float] = {k: 0.0 for k in indeg}
        crit_dep: dict[tuple[str, int], tuple[str, int] | None] = {
            k: None for k in indeg
        }
        heap = [(0.0, nid, inst) for (nid, inst), k in indeg.items() if k == 0]
        heapq.heapify(heap)

        compute_free = [0.0] * n
        comm_free = [0.0] * n
        compute_last: list[tuple[str, int] | None] = [None] * n
        comm_last: list[tuple[str, int] | None] = [None] * n

        schedule: list[Scheduled] = []
        by_key: dict[tuple[str, tuple[int, ...]], Scheduled] = {}
        compute_busy = {d: 0.0 for d in range(n)}
        comm_busy = {d: 0.0 for d in range(n)}
        finish_of: dict[tuple[str, int], float] = {}

        while heap:
            ready, nid, inst = heapq.heappop(heap)
            key = (nid, inst)
            node = dag.nodes[nid]
            group = devs[key]
            if node.kind == "compute":
                d = group[0]
                lane_free, lane_pred = compute_free[d], compute_last[d]
            else:
                lane_free, lane_pred = -1.0, None
                for d in group:  # deterministic max over the ordered group
                    if comm_free[d] > lane_free:
                        lane_free, lane_pred = comm_free[d], comm_last[d]
            if lane_free > ready:
                start, binding, pred = lane_free, "lane", lane_pred
            else:
                start = ready
                pred = crit_dep[key]
                binding = "dep" if pred is not None else "start"
            dur = self.durations[nid]
            finish = start + dur
            finish_of[key] = finish
            s = Scheduled(
                node_id=nid, kind=node.kind, devices=group, start=start,
                finish=finish, ready=ready, binding=binding,
                pred=pred,
            )
            schedule.append(s)
            by_key[(nid, group)] = s
            if node.kind == "compute":
                d = group[0]
                compute_free[d] = finish
                compute_last[d] = key
                compute_busy[d] += dur
            else:
                for d in group:
                    comm_free[d] = finish
                    comm_last[d] = key
                    comm_busy[d] += dur
            for sk in succ.get(key, ()):
                if finish > ready_time[sk]:
                    ready_time[sk] = finish
                    crit_dep[sk] = key
                indeg[sk] -= 1
                if indeg[sk] == 0:
                    heapq.heappush(heap, (ready_time[sk], sk[0], sk[1]))

        if len(schedule) != len(indeg):  # unreachable after dag.validate()
            raise RuntimeError("replay deadlock: not every instance was scheduled")

        makespan = max((s.finish for s in schedule), default=0.0)
        # translate instance-key preds to (node_id, devices) keys for walking
        result = ReplayResult(
            dag=dag,
            makespan=makespan,
            schedule=schedule,
            compute_busy=compute_busy,
            comm_busy=comm_busy,
        )
        result._by_key = {
            (nid, inst): by_key[(nid, devs[(nid, inst)])] for (nid, inst) in indeg
        }
        return result
