"""Device and idle time by the program's spans (``bench/spans.py``) on a
synthetic ``torch.profiler`` trace, worked by hand: kernels launched in
nested spans on one thread, backward kernels launched on the autograd
engine's thread and put down to their forward op's spans through its
``Sequence number``, a kernel launched outside every span, and idle gaps
inside the backward and the optimizer; each step, prefill, decode and
decode step counted alone with the arguments the tracer gave it; then the
readings of a traced run's context, and a traced stretch and a traced
serving batch on the CPU, where they read nothing."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import profiling, spans  # noqa: E402
from bench.testing import smoke_cell  # noqa: E402

MAIN, ENGINE = 1, 2  # the host thread of the step, and the autograd engine's
EVAL = "autograd::engine::evaluate_function: "


def span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def op(name, ts, dur, seq, tid=MAIN, backward=False):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": {"Sequence number": seq, "Fwd thread id": 1 if backward else 0}}


def launch(corr, ts, tid=MAIN, cu=False):
    """A launch through the runtime API, or with ``cu`` the lower-level one
    (cuBLASLt launches its GEMMs so)."""
    return {"ph": "X", "cat": spans.LAUNCH_CATS[1 if cu else 0],
            "name": "cuLaunchKernel" if cu else "cudaLaunchKernel", "ts": ts, "dur": 1.0, "pid": 1,
            "tid": tid, "args": {"correlation": corr}}


def kernel(corr, ts, dur, name="void at::native::vectorized_elementwise_kernel<4>(int)"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


# one train step, in microseconds.  The engine's thread recomputes a
# layer's attention block (model.mix) inside the backward of its tanh,
# where its own op numbers 5 again, then runs the head's product backward
# (sequence number 5: the main thread's mm inside model.head)
EVENTS = [
    span("train.step", 0, 1000),
    span("train.forward", 10, 390),
    span("model.head", 100, 100),
    op("aten::mm", 110, 40, 5),
    launch(1, 120),
    span("model.mix", 210, 90),
    span("mixer:attention", 220, 60),
    launch(2, 230, cu=True),
    op("aten::tanh", 250, 10, 7),
    span("train.backward", 400, 400),
    op(EVAL + "TanhBackward0", 580, 60, 7, tid=ENGINE, backward=True),
    span("model.mix", 585, 50, tid=ENGINE),
    op("aten::mm", 590, 2, 5, tid=ENGINE),
    launch(7, 595, tid=ENGINE),
    launch(8, 637, tid=ENGINE),
    op(EVAL + "MmBackward0", 650, 50, 5, tid=ENGINE, backward=True),
    op("MmBackward0", 651, 48, 5, tid=ENGINE, backward=True),
    launch(3, 660, tid=ENGINE),
    span("train.optimizer", 800, 190),
    launch(4, 810),
    launch(5, 900),
    launch(6, 1100),
    kernel(1, 130, 40, "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_w"),
    kernel(2, 240, 60, "void (anonymous namespace)::flash_fwd_wgmma_kernel<128, 128>(int)"),
    kernel(7, 600, 20),
    kernel(8, 640, 10),
    kernel(3, 670, 100, "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(int)"),
    kernel(4, 820, 20),
    kernel(5, 910, 20),
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 1110, "dur": 10,
     "pid": 0, "tid": 7, "args": {"correlation": 6}},
]

S = "train.step"
BY_SPAN = {f"{S}/train.forward/model.head": 40, f"{S}/train.forward/model.mix/mixer:attention": 60,
           f"{S}/train.backward/model.mix": 20, f"{S}/train.backward/model.mix/mixer:attention": 10,
           f"{S}/train.backward/model.head": 100, f"{S}/train.optimizer": 40, spans.OUTSIDE: 10}
IDLE_BY_SPAN = {f"{S}/train.forward": 70, f"{S}/train.backward": 300 + 20 + 50,
                f"{S}/train.backward/model.mix": 20, f"{S}/train.optimizer": 70, spans.OUTSIDE: 180}


def us(table):
    return {k: pytest.approx(v * 1e-6, abs=1e-12) for k, v in table.items()}


def test_device_and_idle_time_by_span():
    got = spans.attribute(EVENTS)
    assert got.by_span == us(BY_SPAN)
    assert got.idle_by_span == us(IDLE_BY_SPAN)
    step = {k: v for k, v in BY_SPAN.items() if k != spans.OUTSIDE}
    assert got.groups[f"{S} 1"] == (us(step), us({k: v for k, v in IDLE_BY_SPAN.items() if k != spans.OUTSIDE}))
    assert got.groups[spans.STRETCH] == (us({spans.OUTSIDE: 10}), us({spans.OUTSIDE: 180}))
    assert [(pytest.approx(s * 1e6), p) for s, p in got.gaps[:3]] == [
        (300, f"{S}/train.backward"), (180, spans.OUTSIDE), (70, f"{S}/train.forward")]
    assert got.kernels[f"{S}/train.backward/model.head"] == us({"cutlass::Kernel2": 100})  # by short name
    assert got.kernels[f"{S}/train.optimizer"] == us({"at::native::vectorized_elementwise_kernel": 40})
    assert spans.under_no_span(got) == us({"Memcpy HtoD": 10})


def test_totals_seconds_in_and_coverage():
    got = spans.attribute(EVENTS)
    tot = spans.totals(got.by_span)
    assert tot[S] == pytest.approx(270e-6) and tot[f"{S}/train.backward"] == pytest.approx(130e-6)
    assert tot[f"{S}/train.backward/model.mix"] == pytest.approx(30e-6)
    assert tot[f"{S}/train.forward"] == pytest.approx(100e-6)
    assert spans.seconds_in(got.by_span, "model.head") == pytest.approx(140e-6)
    assert spans.seconds_in(got.by_span, "mixer:attention") == pytest.approx(70e-6)
    assert spans.seconds_in(got.idle_by_span, "train.optimizer") == pytest.approx(70e-6)
    assert spans.coverage(got.by_span) == (pytest.approx(270 / 280), pytest.approx(270 / 280))
    assert spans.coverage({f"{S}/train.forward": 1.0, f"{S}/train.clip": 3.0}) == (1.0, 0.75)


def test_instances_with_their_arguments():
    got = spans.attribute(EVENTS, {"train.step": [{"step": 4}]})
    assert got.instances == [{"span": S, "index": 1, "args": {"step": 4}, "host_s": pytest.approx(1000e-6),
                              "kernels": 7, "device_s": pytest.approx(270e-6)}]  # the memcpy after it is not its
    assert spans.instance_line(got.instances[0]) == f"spans, {S} 1 step=4: 7 kernels, device 0.270 ms, host 1.000 ms"
    assert spans.instance_line(got.instances[0]) in spans.lines(got)
    # the tracer's spans of a name must match the trace's one for one, else no arguments
    assert spans.attribute(EVENTS, {"train.step": [{"step": 4}, {"step": 5}]}).instances[0]["args"] == {}


def test_a_served_batch_by_decode_step():
    """A prefill, then a decode of two steps: two kernels in the first step
    and one in the second, and the argmax of the decode between them."""
    events = [span("serve.prefill", 0, 100), launch(1, 10), span("serve.decode", 200, 300),
              span("serve.decode_step", 210, 90), span("model.head", 220, 20), launch(2, 225), launch(3, 250),
              span("serve.decode_step", 320, 80), launch(4, 330), launch(5, 450),
              kernel(1, 20, 50), kernel(2, 230, 10), kernel(3, 260, 30), kernel(4, 340, 20), kernel(5, 460, 5)]
    args = {"serve.prefill": [{"batch": 2, "rows": 32, "prompt_len": 432}],
            "serve.decode": [{"batch": 2, "steps": 2}], "serve.decode_step": [{}, {}]}
    got = spans.attribute(events, args)
    assert [(i["span"], i["index"], i["args"], i["kernels"]) for i in got.instances] == [
        ("serve.prefill", 1, args["serve.prefill"][0], 1), ("serve.decode", 1, args["serve.decode"][0], 4),
        ("serve.decode_step", 1, {}, 2), ("serve.decode_step", 2, {}, 1)]
    assert got.by_span == us({"serve.prefill": 50, "serve.decode/serve.decode_step/model.head": 10,
                              "serve.decode/serve.decode_step": 30 + 20, "serve.decode": 5})
    assert spans.per_instance(got, "serve.decode_step") == {
        "count": 2, "kernels_median": 1.5, "kernels_min": 1, "kernels_max": 2,
        "device_ms_median": pytest.approx(0.030), "device_ms_min": pytest.approx(0.020),
        "device_ms_max": pytest.approx(0.040), "host_ms_median": pytest.approx(0.085),
        "host_ms_min": pytest.approx(0.080), "host_ms_max": pytest.approx(0.090)}
    assert spans.per_instance(got, "train.step") is None
    assert "spans, serve.prefill 1 batch=2 rows=32 prompt_len=432: 1 kernels, device 0.050 ms, host 0.100 ms" \
        in spans.lines(got)


def test_lines_print_a_step_at_a_time():
    out = spans.lines(spans.attribute(EVENTS))
    assert out[0] == f"spans, {S} 1: device 0.270 ms, idle 0.530 ms; under a phase 100.00 %, under a span below " \
                     "it 100.00 %"
    assert out[2].split() == ["0.270", "0.000", S]
    assert out[3].split() == ["0.130", "0.000", "train.backward"]  # the largest child first
    assert any(line.startswith(f"spans, {spans.STRETCH}: device 0.010 ms, idle 0.180 ms") for line in out)
    assert out[-2].startswith(f"spans, longest idle gaps: 0.300 ms {S}/train.backward; 0.180 ms {spans.OUTSIDE}")
    assert out[-1] == "spans, device time under no span below a phase: 0.010 ms Memcpy HtoD"
    assert spans.lines(spans.attribute([e for e in EVENTS if e["cat"] not in profiling.DEVICE_CATS])) == []


def _summary(events):
    s = profiling.reduce(events)
    s.spans = spans.attribute(events)
    return s


def test_readings():
    train = {"kind": "train", "steps": 2, "summary": _summary(EVENTS)}
    assert spans.optimizer_ms_per_step(train) == pytest.approx(0.040 / 2)
    assert spans.head_ms_per_step(train) == pytest.approx(0.140 / 2)
    prefill = [span("serve.prefill", 0, 500), span("model.head", 100, 300), launch(1, 150), launch(2, 450),
               kernel(1, 200, 250), kernel(2, 460, 30)]
    s = _summary(prefill)
    s.counters = {"model.head_rows": 3900.0}
    serve = {"kind": "serve", "mix": {"requests": 2}, "prefill_lens": [1300, 650], "prefill": s}
    assert spans.head_ms_per_cycle(serve) == pytest.approx(0.250)
    assert spans.head_rows_per_request(serve) == 975.0
    for read in spans.READINGS.values():  # each reads only its own kind of run
        assert read(serve if read in (spans.optimizer_ms_per_step, spans.head_ms_per_step) else train) is None
    s.counters = {}  # a program without the counter
    assert spans.head_rows_per_request(serve) is None
    train["summary"] = profiling.reduce(EVENTS)  # a summary without the span tables
    assert spans.optimizer_ms_per_step(train) is None and spans.head_ms_per_step(train) is None


@pytest.mark.parametrize("name", ["olmo-1b.train_2k", "rwkv6-1.6b-variant.serve_code"])
def test_a_traced_stretch_on_the_cpu_reads_nothing(name, monkeypatch, capsys):
    """A cell's traced stretch through ``spans.traced``: the program's
    counter is read, the trace has no device time, and no reading reads."""
    from bench import harness

    monkeypatch.setattr(profiling, "traced", spans.traced)
    cell = smoke_cell(name, trace=True)
    out = harness.load_file(ROOT / "bench" / "traffic" / f"{cell.traffic['kind']}.py").run(cell)
    summary = out.context["summary" if out.context["kind"] == "train" else "prefill"]
    assert summary.kernels == 0 and summary.spans.by_span == {}
    assert summary.counters["model.head_rows"] > 0
    assert all(read(out.context) is None for read in spans.READINGS.values())
    assert "bench: spans" not in capsys.readouterr().err


def test_a_traced_serving_batch_on_the_cpu():
    """``traced_batch``: the prefill, the first tokens, the decode to the
    batch's longest answer; each instance with the tracer's arguments, the
    head's rows counted, no device time, and the tracer off again after."""
    from bench.feed import SERVE, Feed
    from bench.harness import load_file
    from repro_torch.obs import trace

    cell = smoke_cell("rwkv6-1.6b-variant.serve_code", trace=True)
    serve = load_file(ROOT / "bench" / "traffic" / "serve.py")
    ids, answers = serve.Client(cell.traffic, Feed(cell.seed, cell.arch["vocab"]), SERVE).batch(0)
    R, P, n = ids.shape[0], ids.shape[1], int(answers.max())
    got = spans.traced_batch(cell)
    assert trace.active() is None
    assert got.kernels == 0 and got.spans.by_span == {} and spans.lines(got.spans) == []
    assert [(i["span"], i["index"], i["args"]) for i in got.spans.instances] == [
        ("serve.prefill", 1, {"batch": 2, "rows": R, "prompt_len": P}),  # batch 1 warmed up
        ("serve.decode", 1, {"batch": 2, "steps": n - 1})] + [("serve.decode_step", k, {}) for k in range(1, n)]
    assert got.counters["model.head_rows"] == R * P + (n - 1) * R
