"""The DAG's node classes on the card: which kernel a profiler sees belongs to
which class of :func:`~repro_torch.graph.trace_step`'s nodes.

The port's own module (``repro.graph`` has no counterpart): it sets a
whole-model prediction beside the step the card takes, class by class.

* **matmul** — cuBLAS and CUTLASS GEMM kernels (the f32 head's SGEMMs, the
  bf16 products, the small-N GEMV-like kernels, the split-K reductions);
* **mixer** — the port's flash-attention forward and backward, its WKV
  forward and backward, and every kernel launched inside a
  ``record_function`` range whose name starts with :data:`MIXER_RANGE`: the
  model's ``mixer:attention``, ``mixer:wkv`` and ``mixer:ssd_scan`` spans
  (``obs.trace``) open one around each call of a mixer, so the ATen kernels
  that pad and lay out its inputs count as the mixer's, and so do the
  Mamba2 scan's passes, which are ATen kernels alone;
* **elementwise** — everything else: casts and copies, norms, activations,
  reductions, the loss, the optimizer, memory copies and fills.

The DAG's fourth class, **collective**, has no kernel on one card.
"""
from __future__ import annotations

import re

from ..obs.trace import MIXER_RANGE  # the spans around the mixers' calls open profiler ranges of this prefix

NODE_CLASSES = ("matmul", "elementwise", "mixer", "collective")
MIXER_KERNELS = ("flash_fwd_wgmma_kernel", "flash_f32_kernel", "flash_attention_bwd_", "flash_bwd_",
                 "wkv_states_kernel", "wkv_out_kernel", "wkv_bwd_")
_GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitkreduce", re.IGNORECASE)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # torch.profiler's device events
# host-side launches: the runtime API's, and the driver API's (cuLaunchKernel,
# cuLaunchKernelEx: cuBLASLt's nvjet GEMMs launch that way)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def kernel_class(name: str, in_mixer: bool = False) -> str:
    """The node class of the kernel called ``name`` (as the profiler names
    it); ``in_mixer`` says it was launched inside a :data:`MIXER_RANGE`
    range."""
    if in_mixer or any(k in name for k in MIXER_KERNELS):
        return "mixer"
    if _GEMM.search(name):
        return "matmul"
    return "elementwise"


def predicted_by_class(report) -> dict[str, float]:
    """Predicted seconds by node class: the sum of the node durations of a
    :class:`~repro_torch.graph.StepTimeReport`, each compute node by the
    ``op`` the tracer gave it."""
    out = dict.fromkeys(NODE_CLASSES, 0.0)
    for nid, node in report.dag.nodes.items():
        cls = "collective" if node.kind == "collective" else node.meta["op"]
        out[cls] += report.durations[nid]
    return out


def measured_by_class(events: list[dict]) -> dict:
    """Device seconds by node class from the ``traceEvents`` of a
    ``torch.profiler`` Chrome trace.  A device event is a mixer's when its
    launch (the host-side runtime or driver event with the same
    ``correlation``) lies inside a :data:`MIXER_RANGE` range of the same host thread.  Returns
    ``{"seconds": {class: s}, "kernels": {class: {name: s}}}``."""
    ranges: dict[tuple, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(MIXER_RANGE):
            ts = float(e["ts"])
            ranges.setdefault((e.get("pid"), e.get("tid")), []).append((ts, ts + float(e.get("dur", 0.0))))
    in_range = set()
    for e in events:
        if e.get("cat") not in LAUNCH_CATS or "correlation" not in e.get("args", {}):
            continue
        ts = float(e["ts"])
        if any(lo <= ts <= hi for lo, hi in ranges.get((e.get("pid"), e.get("tid")), ())):
            in_range.add(e["args"]["correlation"])
    seconds = dict.fromkeys(NODE_CLASSES, 0.0)
    kernels: dict[str, dict[str, float]] = {c: {} for c in NODE_CLASSES}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        cls = kernel_class(e["name"], e.get("args", {}).get("correlation") in in_range)
        s = float(e["dur"]) * 1e-6
        seconds[cls] += s
        kernels[cls][e["name"]] = kernels[cls].get(e["name"], 0.0) + s
    return {"seconds": seconds, "kernels": kernels}


def schedule_sum(report) -> float:
    """The node durations of a :class:`~repro_torch.graph.StepTimeReport`
    folded in schedule order: on a single-device mesh the makespan equals it
    exactly (one lane, every node back to back)."""
    t = 0.0
    for s in report.replay.schedule:
        t += report.durations[s.node_id]
    return t
