"""The program's spans (``obs.trace``) in the train step, the serving engine
and the model, on the CPU at ``bench/testing.py``'s small sizes.

* Under ``torch.profiler`` a span is a ``user_annotation`` range of its
  name: a dense and an RWKV6 train step show ``train.step`` around
  ``train.forward`` (``model.embed``, ``model.mix`` around its mixer's
  ``mixer:*``, ``model.ffn``, ``model.head``, ``model.loss``),
  ``train.backward`` (where remat runs ``model.mix`` again), ``train.clip``
  and ``train.optimizer``; a prefill and a three-step decode show
  ``serve.prefill`` and ``serve.decode`` around three ``serve.decode_step``,
  one batch's prefill and decode with the same ``batch``.
* With the profiler and the tracer off, a span calls nothing of the
  profiler; losses, gradients and served tokens are equal to the bit with
  tracing on and off.
* ``model.head_rows`` grows by B x S a call of the head.
"""
from __future__ import annotations

import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.feed import Feed  # noqa: E402
from bench.harness import load_file  # noqa: E402
from bench.testing import smoke_cell  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402

TRAIN = load_file(ROOT / "bench" / "traffic" / "train.py")
SERVE = load_file(ROOT / "bench" / "traffic" / "serve.py")
CELLS = {"dense": ("olmo-1b.train_2k", "attention"), "rwkv6": ("rwkv6-1.6b-variant.train_4k", "wkv")}
SEED = 2**31 + 5


def _train(family: str):
    """A step bundle at the small sizes, its optimizer state and parameters,
    and a batch."""
    cell = smoke_cell(CELLS[family][0])
    step, state, params = TRAIN.build(cell, SEED)
    (tokens, labels), = TRAIN.batches(Feed(SEED, cell.arch["vocab"]), cell.traffic, 0, 1, cell.device)
    return step, state, params, {"tokens": tokens, "labels": labels}


def _engine():
    cell = smoke_cell("rwkv6-1.6b-variant.serve_code")
    return SERVE.build(cell, SEED), np.asarray(Feed(SEED, cell.arch["vocab"]).ids(1, 0, 2, 24))


def _profiled(fn, tmp_path):
    """``fn()`` under the profiler: its result and the trace's program
    spans, each (name, parent span's name or None) in the order opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith(("train.", "serve.", "model.",
                                                                                    "mixer:")))
    spans = []
    for i, (s, e, name) in enumerate(ranges):
        parents = [r for r in ranges[:i] if r[0] <= s and e <= r[1]]
        spans.append((name, parents[-1][2] if parents else None))
    return out, spans


@pytest.mark.parametrize("family", sorted(CELLS))
def test_train_step_spans_nest_as_the_layers(family, tmp_path):
    step, state, _, batch = _train(family)
    step(state, batch)
    _, spans = _profiled(lambda: step(state, batch), tmp_path)
    mixer = f"{trace.MIXER_RANGE}{CELLS[family][1]}"
    layers = 2  # bench/testing.py's
    assert [s for s in spans if s[1] in (None, "train.step")] == [
        ("train.step", None), ("train.forward", "train.step"), ("train.backward", "train.step"),
        ("train.clip", "train.step"), ("train.optimizer", "train.step")]
    forward = [s for s in spans if s[1] == "train.forward"]
    assert forward == [("model.embed", "train.forward")] + [("model.mix", "train.forward"),
                                                          ("model.ffn", "train.forward")] * layers + [
        ("model.head", "train.forward"), ("model.loss", "train.forward")]
    # remat: every layer's forward again inside the backward (on the CPU the engine runs on the step's thread)
    assert Counter(s for s in spans if s[1] == "train.backward") == {("model.mix", "train.backward"): layers,
                                                                    ("model.ffn", "train.backward"): layers}
    assert Counter(s for s in spans if s[0] == mixer) == {(mixer, "model.mix"): 2 * layers}
    assert {name for name, _ in spans} == {"train.step", "train.forward", "train.backward", "train.clip",
                                            "train.optimizer", "model.embed", "model.mix", "model.ffn",
                                            "model.head", "model.loss", mixer}


def test_prefill_and_decode_spans_share_a_batch(tmp_path):
    engine, prompts = _engine()
    tracer = trace.enable()
    try:
        def serve():
            tok, cache = engine.prefill(prompts)
            return engine.decode(tok, cache, 3)

        _, spans = _profiled(serve, tmp_path)
    finally:
        trace.disable()
    phases = [s for s in spans if s[0].startswith("serve.")]
    assert phases == [("serve.prefill", None), ("serve.decode", None)] + [("serve.decode_step", "serve.decode")] * 3
    assert Counter(s for s in spans if s[0] == "model.head") == {("model.head", "serve.prefill"): 1,
                                                               ("model.head", "serve.decode_step"): 3}
    args = {e["name"]: e.get("args", {}) for e in tracer.events if e["name"] in ("serve.prefill", "serve.decode")}
    assert args["serve.prefill"] == {"batch": engine.batches, "rows": 2, "prompt_len": 24}
    assert args["serve.decode"] == {"batch": engine.batches, "steps": 3}


def test_spans_off_call_nothing_of_the_profiler(monkeypatch):
    calls = []
    real = torch_profiler.record_function

    class Counted(real):
        def __init__(self, *a, **kw):
            calls.append(a[0])
            super().__init__(*a, **kw)

    monkeypatch.setattr(torch_profiler, "record_function", Counted)
    step, state, _, batch = _train("dense")
    engine, prompts = _engine()
    assert trace.active() is None and not torch_profiler._is_profiler_enabled
    step(state, batch)
    engine.generate(prompts, 3)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):  # the counter counts: a span under the profiler opens a range
        step(state, batch)
    assert calls[0] == "train.step" and "model.head" in calls


@pytest.mark.parametrize("family", sorted(CELLS))
def test_train_step_bit_equal_traced_and_not(family, tmp_path):
    runs = []
    for traced in (False, True):
        step, state, params, batch = _train(family)
        if traced:
            trace.enable()
            try:
                out, _ = _profiled(lambda: step(state, batch), tmp_path)
            finally:
                trace.disable()
        else:
            out = step(state, batch)
        runs.append((out["loss"], out["grad_norm"], {n: state["m"][n].clone() for n in params},
                     {n: p.detach().clone() for n, p in params.items()}))
    (loss0, gn0, m0, p0), (loss1, gn1, m1, p1) = runs
    assert torch.equal(loss0, loss1) and torch.equal(gn0, gn1)
    for n in m0:  # the first moment after one step is the clipped gradient times (1 - b1)
        assert torch.equal(m0[n], m1[n]) and torch.equal(p0[n], p1[n]), n


def test_served_tokens_equal_traced_and_not(tmp_path):
    engine, prompts = _engine()
    plain = engine.generate(prompts, 4)
    trace.enable()
    try:
        traced, _ = _profiled(lambda: engine.generate(prompts, 4), tmp_path)
    finally:
        trace.disable()
    np.testing.assert_array_equal(plain, traced)


def test_head_rows_count_b_times_s_a_head_call():
    engine, prompts = _engine()
    model = engine.model
    rows = metrics.counter("model.head_rows")
    before = rows.value
    with torch.no_grad():
        model(torch.as_tensor(prompts))
    assert rows.value - before == 2 * 24
    tok, cache = engine.prefill(prompts)
    assert rows.value - before == 2 * (2 * 24)
    engine.decode(tok, cache, 3)
    assert rows.value - before == 2 * (2 * 24) + 3 * 2
