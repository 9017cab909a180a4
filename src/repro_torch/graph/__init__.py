"""Whole-model estimation: kernel DAGs, discrete-event replay, step-time reports.

The port's copy of ``repro.graph``; its predictions equal the JAX package's
with ``==`` (``tests/test_torch_graph.py``, ``test_torch_tpu_estimator.py``).
The per-kernel estimators (`core/estimator.py`, `core/tpu_estimator.py`)
answer "how long does THIS kernel take"; this package answers "how long does the whole step take" by tracing a model
into a :class:`KernelDAG` of AccessIR nodes plus sharding-implied
collectives (:func:`trace_step`), pricing every unique kernel once through
the shared estimator protocol (:func:`estimate_dag`), and replaying the DAG
on per-device compute and collective lanes (:class:`Replayer`) — critical
path, utilization, overlap and slack fall out of the schedule
(:class:`StepTimeReport`).

:mod:`.classes` is the port's own: it sorts the kernels a profiler sees on
the card into the DAG's node classes, so that a prediction can be set beside
the card's step class by class.
"""
from .dag import COLLECTIVE_KINDS, GraphNode, KernelDAG, axis_groups
from .frontend import collective_seconds, rules_for_spec, trace_step
from .replay import Replayer, ReplayResult, Scheduled
from .study import StepTimeReport, backend_for, estimate_dag, step_time

__all__ = [
    "COLLECTIVE_KINDS",
    "GraphNode",
    "KernelDAG",
    "Replayer",
    "ReplayResult",
    "Scheduled",
    "StepTimeReport",
    "axis_groups",
    "backend_for",
    "collective_seconds",
    "estimate_dag",
    "rules_for_spec",
    "step_time",
    "trace_step",
]
