"""Observability for the port's estimation stack: the parts of
``repro.obs.trace`` (spans, Chrome-trace export) and ``repro.obs.metrics``
(process-global counters and histograms) it uses.  Stdlib only."""
from . import metrics, trace

__all__ = ["metrics", "trace"]
