"""Kernel DAG: one traced model step as a graph of AccessIR nodes + comm edges.

Copy of ``repro.graph.dag``.  A :class:`KernelDAG` is the whole-model
analogue of a single ``AccessIR``: the SPMD program of one model step, before
any code exists.  Compute nodes carry a canonical
:class:`~repro_torch.frontend.ir.AccessIR` (the per-kernel estimators
consume it unchanged); collective nodes carry a collective kind + result bytes
+ the mesh axis they ride.  Nodes are SPMD: a compute node runs once per
device, a collective runs once per device *group* of its axis.

Design rules:

* node identity is the caller-supplied ``id`` string — replay scheduling is
  keyed on ``(ready_time, id)``, never on insertion order, so the predicted
  step time is invariant under topological-order permutation of insertion
  (``tests/test_torch_graph.py`` locks this);
* ``repeat`` counts *sequential* repetitions of the same kernel on the same
  lane (a matmul's k-panel loop, attention's per-batch-element launches): the
  node's duration is ``repeat x`` the per-kernel estimate while its IR — and
  therefore its fingerprint, store identity and estimation cost — stays that
  of the single kernel;
* dependencies may reference ids added later (builders can wire forward);
  :meth:`KernelDAG.validate` checks the closed graph once, before replay.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.machine import MeshSpec
from ..frontend.ir import AccessIR, ir_fingerprint

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter")


@dataclass(frozen=True)
class GraphNode:
    """One SPMD operation of the traced step (kernel launch or collective)."""

    id: str
    kind: str  # "compute" | "collective"
    ir: AccessIR | None = None  # compute nodes: the per-kernel IR
    repeat: int = 1  # sequential launches of the same kernel (duration multiplier)
    deps: tuple[str, ...] = ()
    comm_kind: str = ""  # collective nodes: all-reduce | all-gather | reduce-scatter
    comm_bytes: float = 0.0  # result-buffer bytes per device (ring-model input)
    axis: str = ""  # mesh axis the collective rides
    time_s: float | None = None  # explicit duration override (tests / collectives)
    meta: dict = field(default_factory=dict)

    @property
    def fingerprint(self) -> str | None:
        return ir_fingerprint(self.ir) if self.ir is not None else None


@dataclass
class KernelDAG:
    """One model step over one device mesh."""

    mesh: MeshSpec
    nodes: dict[str, GraphNode] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    # ---- construction ---------------------------------------------------- #

    def add(self, node: GraphNode) -> GraphNode:
        if node.id in self.nodes:
            raise ValueError(f"duplicate node id {node.id!r}")
        self.nodes[node.id] = node
        return node

    def compute(
        self, id: str, ir: AccessIR, *, deps=(), repeat: int = 1, **meta
    ) -> GraphNode:
        return self.add(
            GraphNode(
                id=id, kind="compute", ir=ir, repeat=int(repeat),
                deps=tuple(deps), meta=meta,
            )
        )

    def collective(
        self, id: str, comm_kind: str, comm_bytes: float, axis: str, *, deps=(), **meta
    ) -> GraphNode:
        if comm_kind not in COLLECTIVE_KINDS:
            raise ValueError(
                f"unknown collective {comm_kind!r} (expected one of {COLLECTIVE_KINDS})"
            )
        return self.add(
            GraphNode(
                id=id, kind="collective", comm_kind=comm_kind,
                comm_bytes=float(comm_bytes), axis=axis, deps=tuple(deps), meta=meta,
            )
        )

    # ---- queries ---------------------------------------------------------- #

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def compute_nodes(self) -> list[GraphNode]:
        return [n for n in self.nodes.values() if n.kind == "compute"]

    @property
    def collective_nodes(self) -> list[GraphNode]:
        return [n for n in self.nodes.values() if n.kind == "collective"]

    def unique_fingerprints(self) -> dict[str, AccessIR]:
        """fingerprint -> IR over compute nodes (the estimation dedup set)."""
        out: dict[str, AccessIR] = {}
        for n in self.compute_nodes:
            out.setdefault(n.fingerprint, n.ir)
        return out

    def lint(
        self, machine=None, threshold: str | None = None, estimate_cache=None
    ) -> dict:
        """Static analysis (:func:`repro_torch.analysis.analyze_ir`) over every
        unique compute-node IR: ``node_id -> Report`` for the first node
        carrying each fingerprint.  ``machine`` (name or instance) enables the
        machine-dependent perf lints; ``threshold`` ("error"/"warn") raises
        :class:`repro_torch.analysis.LintError` at the first report failing it —
        the DAG-level analogue of ``Study(lint=...)``.  ``estimate_cache``
        shares perf-lint sub-results with the estimation that follows."""
        from .. import analysis

        by_fp: dict[str, str] = {}
        for n in self.compute_nodes:
            if n.ir is not None:
                by_fp.setdefault(n.fingerprint, n.id)
        reports: dict[str, object] = {}
        for fp, nid in by_fp.items():
            rep = analysis.analyze_ir(
                self.nodes[nid].ir, machine, estimate_cache=estimate_cache
            )
            reports[nid] = rep
            if threshold is not None and not rep.ok(threshold):
                raise analysis.LintError(rep, threshold, context=f"node {nid}")
        return reports

    def validate(self) -> None:
        """Check the closed graph: known deps, known axes, no cycles."""
        axis_names = {a for a, _ in self.mesh.axes}
        for n in self.nodes.values():
            for d in n.deps:
                if d not in self.nodes:
                    raise ValueError(f"node {n.id!r} depends on unknown node {d!r}")
            if n.kind == "collective" and n.axis not in axis_names:
                raise ValueError(
                    f"collective {n.id!r} rides axis {n.axis!r}, not in mesh "
                    f"{tuple(a for a, _ in self.mesh.axes)}"
                )
            if n.kind == "compute" and n.ir is None and n.time_s is None:
                raise ValueError(f"compute node {n.id!r} has neither IR nor time_s")
        self.topo_order()  # raises on cycles

    def topo_order(self) -> list[str]:
        """Deterministic topological order (Kahn by id, insertion-independent)."""
        import heapq

        indeg = {nid: 0 for nid in self.nodes}
        succ: dict[str, list[str]] = {nid: [] for nid in self.nodes}
        for n in self.nodes.values():
            for d in n.deps:
                indeg[n.id] += 1
                succ[d].append(n.id)
        ready = sorted(nid for nid, k in indeg.items() if k == 0)
        heapq.heapify(ready)
        out: list[str] = []
        while ready:
            nid = heapq.heappop(ready)
            out.append(nid)
            for s in succ[nid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if len(out) != len(self.nodes):
            stuck = sorted(set(self.nodes) - set(out))
            raise ValueError(f"dependency cycle through {stuck[:5]}")
        return out


def axis_groups(mesh: MeshSpec, axis: str) -> list[tuple[int, ...]]:
    """Device-id groups a collective over ``axis`` synchronizes.

    Devices are numbered row-major over the mesh axes (first axis slowest);
    one group holds the devices that differ only in their ``axis`` coordinate.
    """
    names = [a for a, _ in mesh.axes]
    sizes = [s for _, s in mesh.axes]
    if axis not in names:
        raise KeyError(axis)
    ai = names.index(axis)
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    groups: list[tuple[int, ...]] = []
    other = [range(s) if i != ai else (0,) for i, s in enumerate(sizes)]

    def walk(i: int, base: int) -> None:
        if i == len(sizes):
            groups.append(tuple(base + k * strides[ai] for k in range(sizes[ai])))
            return
        for c in other[i]:
            walk(i + 1, base + c * strides[i])

    walk(0, 0)
    return groups
