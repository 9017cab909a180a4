"""The port's whole-model estimator at full width, its CLI, what it leaves
out, and the kernel classes that set its predictions beside the card.

* **full width:** the ``step_time`` calls of ``chip_smoke.py``'s phase
  ``step_time`` on ``"h100"``, equal with ``==`` to ``repro.graph``'s: the
  seven served configs at batch 4, seq 512, ``forward`` (LLaVA-NeXT-34B and
  DBRX-132B at the depth one card holds, ``launch.one_card``), and OLMo-1B
  and RWKV6-1.6B at batch 4, seq 4096, ``train``;
* **the CLI:** ``python -m repro_torch.explore graph`` prints the JAX
  package's golden report (``tests/golden/graph_rwkv6_a100.txt``, read,
  never written) byte for byte; ``--json`` and ``--trace`` too;
* **TPU machines and the audit:** ``step_time`` on ``tpuv5e`` and
  ``tpuv6e``, ``trace_step(backend="tpu")``, ``lint=`` and
  ``KernelDAG.lint`` equal the JAX package's; the CLI prints
  ``tests/golden/graph_zamba2_tpuv5e.txt`` byte for byte, and its other
  subcommands (``lint`` among them) run as the JAX CLI's do;
* **kernel classes:** ``graph.classes`` sorts kernel names the profiler
  reported on an H100 (in traced training steps and prefills, and
  ``benchmarks/torch_serve_profile.py``) into the DAG's node classes, and
  sums a trace's device time by class, the kernels launched inside a
  ``mixer:`` range (the program's spans around its mixers) as the mixer's.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from repro.configs import get_arch as jax_get_arch
from repro.explore import cli as jax_cli
from repro.graph import step_time as jax_step_time
from repro.graph import trace_step as jax_trace_step
from repro_torch.configs import get_arch
from repro_torch.explore import cli
from repro_torch.explore.registry import get_estimator
from repro_torch.explore.serve import ServeClient
from repro_torch.graph import KernelDAG, step_time, trace_step
from repro_torch.graph.classes import (
    kernel_class,
    measured_by_class,
    predicted_by_class,
    schedule_sum,
)
from repro_torch.launch.one_card import full_width_paths, one_card_config
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import validate_chrome_trace
from test_torch_graph import _node_fields, assert_reports_equal

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "graph_rwkv6_a100.txt"
GOLDEN_ARGS = ["graph", "--model", "rwkv6-1.6b", "--smoke", "--machine", "a100",
               "--mesh", "data=2,model=2", "--batch", "8", "--seq", "128"]
FULL_WIDTH = full_width_paths()  # chip_smoke.py's phase step_time: path -> (arch, batch, seq, kind)


@functools.lru_cache(maxsize=None)
def _full_width(path: str):
    arch, batch, seq, kind = FULL_WIDTH[path]
    cfg, reduced = one_card_config(arch)
    ref_cfg = jax_get_arch(arch)
    if reduced:
        ref_cfg = dataclasses.replace(ref_cfg, n_layers=cfg.n_layers)
    rep = step_time(cfg, "h100", batch=batch, seq=seq, kind=kind)
    ref = jax_step_time(ref_cfg, "h100", batch=batch, seq=seq, kind=kind)
    return rep, ref


@pytest.mark.parametrize("path", sorted(FULL_WIDTH))
def test_full_width_step_time_equals_jax(path):
    rep, ref = _full_width(path)
    assert_reports_equal(rep, ref)
    assert rep.step_time_s == schedule_sum(rep)  # one H100: no collectives
    by_class = predicted_by_class(rep)
    assert by_class["collective"] == 0.0
    assert sum(by_class.values()) == pytest.approx(rep.step_time_s, rel=1e-12)


def test_full_width_olmo_train_prediction():
    """The number the JAX package's own step_time gives for the train path."""
    rep, _ = _full_width("train_olmo")
    assert rep.step_time_s == 79.78605980390815
    assert len(rep.dag) == 538 and len(rep.unique) == 18


def test_full_width_rwkv6_train_prediction():
    """The RWKV6 training path, ``train_rwkv``: the JAX package's own
    step_time for it, and nine full-width paths in all."""
    rep, _ = _full_width("train_rwkv")
    assert rep.step_time_s == 33.04892951430303
    assert len(rep.dag) == 994 and len(rep.unique) == 23
    assert len(FULL_WIDTH) == 9 and FULL_WIDTH["train_rwkv"] == ("rwkv6-1.6b", 4, 4096, "train")


def test_cut_config_is_the_one_card_depth():
    rep, _ = _full_width("serve_dbrx")
    assert sum(1 for n in rep.dag.nodes if n.endswith(".attn")) == 4
    rep, _ = _full_width("serve_llava")
    assert sum(1 for n in rep.dag.nodes if n.endswith(".attn")) == 24


def test_step_time_counts_estimates_and_nodes():
    cfg = get_arch("rwkv6-1.6b").smoke()
    before = obs_metrics.snapshot()
    rep = step_time(cfg, "a100", batch=8, seq=128)
    d = obs_metrics.diff(before, obs_metrics.snapshot())
    assert d["counters"]["graph.estimated{backend=gpu}"] == len(rep.unique)
    assert d["counters"]["graph.nodes{backend=gpu}"] == len(rep.dag)
    assert d["histograms"]["estimate.batch_size{backend=gpu}"]["count"] >= 1


def test_step_time_accepts_the_port_lm():
    from repro_torch.models import build_model

    cfg = get_arch("olmo-1b").smoke()
    model = build_model(cfg, device="cpu", seed=0)
    assert step_time(model, "h100", batch=2, seq=64).render() == step_time(
        cfg, "h100", batch=2, seq=64).render()




# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #


def _run(main, args, capsys) -> tuple[int, str, str]:
    rc = main(args)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_prints_the_golden_report(capsys):
    rc, out, err = _run(cli.main, GOLDEN_ARGS, capsys)
    assert rc == 0, err
    assert out == GOLDEN.read_text()


def test_cli_module_prints_the_golden_report():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.explore", *GOLDEN_ARGS], env=env,
                         cwd=ROOT, capture_output=True, timeout=120, check=True)
    assert out.stdout == GOLDEN.read_bytes()


@pytest.mark.parametrize("extra", [["--json"], ["--kind", "train", "--json"],
                                   ["--kind", "train", "--top", "5"]], ids=" ".join)
def test_cli_equals_the_jax_cli(extra, capsys):
    want = _run(jax_cli.main, GOLDEN_ARGS + extra, capsys)
    got = _run(cli.main, GOLDEN_ARGS + extra, capsys)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]


def test_cli_trace_and_explain(tmp_path, capsys):
    trace, explain = tmp_path / "step.json", tmp_path / "report.json"
    rc, out, err = _run(cli.main, GOLDEN_ARGS + ["--trace", str(trace), "--explain", str(explain)],
                        capsys)
    assert rc == 0, err
    doc = json.loads(trace.read_text())
    assert validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert "estimate.batch" in names  # the estimation's own span
    predicted = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e["pid"] >= 1_000_000]
    assert {e["pid"] - 1_000_000 for e in predicted} == {0, 1, 2, 3}  # one lane pair a device
    rep = json.loads(explain.read_text())
    assert rep["n_nodes"] == 41 and rep["n_unique_kernels"] == 9


# --------------------------------------------------------------------------- #
# the TPU machines and the static audit, equal to the JAX package's
# --------------------------------------------------------------------------- #


def test_tpu_machine_raises():
    """A TPU machine, which raised before the port had its TPU backend: the
    step priced on each spelling of ``tpuv5e`` and ``tpuv6e`` equals the JAX
    package's, node for node, and ``trace_step(backend="tpu")`` gives the
    JAX package's DAG."""
    cfg, ref_cfg = get_arch("zamba2-7b").smoke(), jax_get_arch("zamba2-7b").smoke()
    for name in ("tpuv5e", "TPUv6e", "tpu-v5e"):
        rep = step_time(cfg, name, mesh="data=4,model=2", batch=8, seq=128, kind="train")
        ref = jax_step_time(ref_cfg, name, mesh="data=4,model=2", batch=8, seq=128, kind="train")
        assert_reports_equal(rep, ref)
    dag = trace_step(cfg, backend="tpu")
    ref_dag = jax_trace_step(ref_cfg, backend="tpu")
    assert list(dag.nodes) == list(ref_dag.nodes)
    assert [_node_fields(n) for n in dag.nodes.values()] == [_node_fields(n) for n in ref_dag.nodes.values()]
    assert all(n.ir.granularity == "block" for n in dag.compute_nodes if n.ir is not None)
    assert get_estimator("tpu").backend == "tpu"


def test_tpu_machine_cli_exits_2(capsys):
    """The CLI on a TPU machine, which exited 2: it now prints the JAX
    package's golden report byte for byte, exit 0."""
    rc, out, err = _run(cli.main, ["graph", "--model", "zamba2-7b", "--smoke", "--machine", "tpuv5e",
                                   "--mesh", "data=4,model=2", "--batch", "8", "--seq", "128",
                                   "--kind", "train"], capsys)
    assert rc == 0, err
    assert out == (ROOT / "tests" / "golden" / "graph_zamba2_tpuv5e.txt").read_text()


def _lint_outcome(fn, arch, lint):
    try:
        rep = fn(arch("rwkv6-1.6b").smoke(), "a100", batch=8, seq=128, lint=lint)
    except Exception as e:  # noqa: BLE001 - the refusal is the outcome compared
        return type(e).__name__, str(e)
    return rep.render_json(), {nid: r.to_json() for nid, r in rep.lint_reports.items()}


def test_lint_raises():
    """``lint=``, which raised before the port had the audit: each setting
    gives the JAX package's reports, or its refusal, and so does
    ``KernelDAG.lint``."""
    for lint in ("error", "warn", "annotate", "off"):
        got = _lint_outcome(step_time, get_arch, lint)
        assert got == _lint_outcome(jax_step_time, jax_get_arch, lint), lint
        assert bool(got[1]) == (lint != "off")
    cfg = get_arch("rwkv6-1.6b").smoke()
    assert step_time(cfg, "a100", batch=8, seq=128, lint="off").lint_reports == {}
    got = trace_step(cfg, batch=8, seq=128).lint("a100")
    want = jax_trace_step(jax_get_arch("rwkv6-1.6b").smoke(), batch=8, seq=128).lint("a100")
    assert {nid: r.to_json() for nid, r in got.items()} == {nid: r.to_json() for nid, r in want.items()}
    assert isinstance(trace_step(cfg, batch=8, seq=128), KernelDAG)


def _serve_cli(main, root: Path, capsys) -> tuple[int, str, str]:
    """``serve --port 0`` in a thread: wait for its address line, ask
    ``/health``, then ``/shutdown``, and return what the CLI returned."""
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(main(["serve", "--port", "0", "--root", str(root)])))
    t.start()
    out = ""
    for _ in range(500):
        out += capsys.readouterr().out
        if "serving on http://" in out:
            break
        time.sleep(0.01)
    host, port = out.split("serving on http://")[1].split()[0].rsplit(":", 1)
    client = ServeClient(host, int(port))
    assert client.health()["ok"] is True
    client.shutdown()
    client.close()
    t.join(timeout=30)
    rest = capsys.readouterr()
    return rcs[0], out + rest.out, rest.err


def _volatile_dropped(out: str) -> str:
    """The sweep's stdout without its wall-clock figures: the text table's
    ``swept ... in Xs`` line, the JSON summary's ``wall_s``."""
    if out.startswith("{"):
        doc = json.loads(out)
        doc.pop("wall_s", None)
        return json.dumps(doc, sort_keys=True)
    return "\n".join(ln for ln in out.splitlines() if not ln.startswith("swept "))


@pytest.mark.parametrize("argv, item", [
    (["lint", "--kernel", "stencil25"], "audit"),
    (["search", "--kernel", "stencil25", "--budget", "8", "--json"], "item 8"),
    (["store", "info", "sweep.jsonl"], "item 8"),
    (["serve"], "item 8"),
    (["--kernel", "stencil25", "--top", "5"], "item 8"),
    (["--list"], "item 8"),
    ([], "item 8"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_other_subcommands_exit_2(argv, item, tmp_path, monkeypatch, capsys):
    """The CLI's other subcommands (``lint``, the audit, and those that
    ROADMAP Queue 1 item 8 ported) run as the JAX CLI runs them, each
    package in a directory of its own (the default stores land there): the
    same exit code and the same output, less wall-clock figures.  ``search``
    takes the budget it requires and ``store info`` a store that a small
    sweep wrote; ``serve`` answers ``/health`` and stops on ``/shutdown``;
    with no arguments both CLIs exit 2 asking for ``--kernel``."""
    runs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        if argv[:1] == ["store"]:
            assert main(["--kernel", "stencil25", "--sample", "4", "--store", "sweep.jsonl"]) == 0
            capsys.readouterr()
        if argv == ["serve"]:
            runs[name] = _serve_cli(main, cwd / "stores", capsys)
        else:
            runs[name] = _run(main, argv, capsys)
    (rc, out, err), (want_rc, want_out, want_err) = runs["port"], runs["jax"]
    assert rc == want_rc == (2 if argv == [] else 0), err
    assert "ROADMAP" not in err
    if argv == ["serve"]:
        assert out.startswith("serving on http://127.0.0.1:") and "served 0 queries" in out
    else:
        assert _volatile_dropped(out) == _volatile_dropped(want_out)
        assert err == want_err


# --------------------------------------------------------------------------- #
# kernel classes
# --------------------------------------------------------------------------- #

# kernel names as torch.profiler reported them on an NVIDIA H100 80GB HBM3
# (traced training steps, and benchmarks/torch_serve_profile.py), cut at 120
# characters as the profiling scripts printed them
H100_KERNELS = {
    "matmul": [
        "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNN",
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT",
        "nvjet_tst_64x8_64x16_4x1_v_bz_splitK_NNT",
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8_stage3_warpsize4x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cub",
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cub",
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)",
        "void gemmSN_NN_kernel<float, 256, 4, 2, 8, 4, 4, false, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStr",
    ],
    "mixer": [
        "void (anonymous namespace)::flash_fwd_wgmma_kernel<128, 128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*",
        "void (anonymous namespace)::flash_bwd_dkdv_tc_kernel<128>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 cons",
        "void (anonymous namespace)::flash_bwd_dq_tc_kernel<128>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*",
        "void (anonymous namespace)::flash_attention_bwd_dkdv_kernel<__nv_bfloat16, 128>(__nv_bfloat16 const*, __nv_bfloat16 cons",
        "void (anonymous namespace)::wkv_states_kernel<16, 64>(float const*, float const*, float const*, float const*, float*, f",
        "void (anonymous namespace)::wkv_out_kernel<16, 64>(float const*, float const*, float const*, float const*, float const*,",
        "void (anonymous namespace)::wkv_bwd_kernel<16, 64>(float const*, float const*, float const*, float const*, float const*, i",
        "(anonymous namespace)::wkv_bwd_reduce_kernel(float const*, float*, int, long)",
    ],
    "elementwise": [
        "void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambd",
        "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::T",
        "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}:",
        "void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, at::native::Ge",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, float, float, float>, unsi",
        "void (anonymous namespace)::softmax_warp_forward<float, float, float, 10, false, false>(float*, float const*, int, int, ",
        "void at::native::tensor_kernel_scan_outer_dim<float, unsigned int, std::plus<float> >(float*, float const*, unsigned int",
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anonymous namespace)::OpaqueType<4u>",
        "Memcpy DtoD (Device -> Device)",
    ],
}


@pytest.mark.parametrize("cls", sorted(H100_KERNELS))
def test_h100_kernel_names_sort_into_classes(cls):
    for name in H100_KERNELS[cls]:
        assert kernel_class(name) == cls, name
        assert kernel_class(name, in_mixer=True) == "mixer"  # inside the scan's range


def test_measured_by_class_reads_mixer_ranges():
    """A synthetic torch.profiler trace: an ATen scan, and a cuBLASLt GEMM
    launched through the driver API, inside the ``mixer:`` range are the
    mixer's; the same kernels outside it are not."""
    scan = H100_KERNELS["elementwise"][6]
    nvjet = H100_KERNELS["matmul"][1]  # another GEMM than the runtime-launched one below
    events = [
        {"cat": "user_annotation", "name": "mixer:ssd_scan", "ts": 100.0, "dur": 50.0, "pid": 1, "tid": 7},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120.0, "dur": 2.0, "pid": 1, "tid": 7,
         "args": {"correlation": 11}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 160.0, "dur": 2.0, "pid": 1, "tid": 7,
         "args": {"correlation": 12}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 130.0, "dur": 2.0, "pid": 1, "tid": 8,
         "args": {"correlation": 13}},
        {"cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 140.0, "dur": 2.0, "pid": 1, "tid": 7,
         "args": {"correlation": 15}},
        {"cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 170.0, "dur": 2.0, "pid": 1, "tid": 7,
         "args": {"correlation": 16}},
        {"cat": "kernel", "name": scan, "ts": 500.0, "dur": 30.0, "args": {"correlation": 11}},
        {"cat": "kernel", "name": scan, "ts": 540.0, "dur": 10.0, "args": {"correlation": 12}},
        {"cat": "kernel", "name": H100_KERNELS["matmul"][0], "ts": 560.0, "dur": 40.0,
         "args": {"correlation": 13}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 600.0, "dur": 5.0,
         "args": {"correlation": 14}},
        {"cat": "kernel", "name": nvjet, "ts": 610.0, "dur": 20.0, "args": {"correlation": 15}},
        {"cat": "kernel", "name": nvjet, "ts": 640.0, "dur": 7.0, "args": {"correlation": 16}},
    ]
    res = measured_by_class(events)
    assert res["seconds"] == pytest.approx({"matmul": 47e-6, "elementwise": 15e-6, "mixer": 50e-6,
                                            "collective": 0.0}, abs=1e-15)
    assert res["kernels"]["mixer"] == pytest.approx({scan: 30e-6, nvjet: 20e-6})
    assert res["kernels"]["matmul"] == pytest.approx({H100_KERNELS["matmul"][0]: 40e-6, nvjet: 7e-6})
    assert set(res["kernels"]["elementwise"]) == {scan, "Memcpy DtoD (Device -> Device)"}


def test_predicted_by_class_splits_the_dag():
    rep = step_time(get_arch("zamba2-7b").smoke(), "h100", mesh="data=2,model=2", batch=8, seq=128)
    by_class = predicted_by_class(rep)
    assert set(by_class) == {"matmul", "elementwise", "mixer", "collective"}
    assert all(v > 0 for v in by_class.values())
    assert sum(by_class.values()) == pytest.approx(sum(rep.durations.values()), rel=1e-12)


# --------------------------------------------------------------------------- #
# the jax-free pieces graph reads, against their JAX originals
# --------------------------------------------------------------------------- #


def test_mesh_geometry_equals_jax():
    from repro.core import hlo_analysis as jax_hlo
    from repro.core import machine as jax_machine
    from repro.launch.mesh import mesh_spec as jax_mesh_spec
    from repro.models import params as jax_params
    from repro.models.shardctx import axes_size as jax_axes_size
    from repro_torch.core import hlo_analysis, machine
    from repro_torch.launch.mesh import mesh_spec
    from repro_torch.models import params
    from repro_torch.models.shardctx import axes_size

    for name in ("SINGLE_DEVICE_MESH", "SINGLE_POD_MESH", "MULTI_POD_MESH"):
        mesh, ref = getattr(machine, name), getattr(jax_machine, name)
        assert (mesh.axes, mesh.inter_pod_axes, mesh.n_devices) == (ref.axes, ref.inter_pod_axes, ref.n_devices)
        for m in machine.gpu_machines():
            for axis, _ in mesh.axes:
                assert mesh.bandwidth(axis, machine.get_machine(m)) == ref.bandwidth(
                    axis, jax_machine.get_machine(m))
    assert list(machine.gpu_machines()) == list(jax_machine.gpu_machines())
    for spelling in (None, "data=2,model=2", {"pod": 2, "data": 4}, (("data", 8),)):
        assert mesh_spec(spelling).axes == jax_mesh_spec(spelling).axes
    with pytest.raises(TypeError):
        mesh_spec(3.14)
    with pytest.raises(ValueError):
        mesh_spec("data:2")
    for rules in ("SINGLE_POD_RULES", "MULTI_POD_RULES"):
        got, want = getattr(params, rules), getattr(jax_params, rules)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    sizes = {"pod": 2, "data": 4, "model": 8}
    for axes in (None, "model", ("pod", "data"), ("data", "absent")):
        assert axes_size(axes, sizes) == jax_axes_size(axes, sizes)
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute", "other"):
        for n in (1, 2, 3, 16):
            assert hlo_analysis.collective_wire_bytes(kind, 12345.0, n) == jax_hlo.collective_wire_bytes(
                kind, 12345.0, n)


def test_records_and_payloads_equal_jax():
    """The unique kernels' records of one step, their store payloads and the
    payloads read back, against the JAX package's."""
    from repro.core.record import record_from_payload as jax_from_payload
    from repro.core.record import record_payload as jax_payload
    from repro_torch.core.record import Estimator, EstimateRecord, record_from_payload, record_payload

    rep = step_time(get_arch("musicgen-large").smoke(), "h100", batch=8, seq=128)
    ref = jax_step_time(jax_get_arch("musicgen-large").smoke(), "h100", batch=8, seq=128)
    assert isinstance(get_estimator("gpu"), Estimator)
    for fp, rec in rep.unique.items():
        assert isinstance(rec, EstimateRecord)
        payload = record_payload(rec)
        assert json.dumps(payload, sort_keys=True) == json.dumps(jax_payload(ref.unique[fp]), sort_keys=True)
        back = record_from_payload(json.loads(json.dumps(payload)), fingerprint=fp)
        assert record_payload(back) == record_payload(jax_from_payload(json.loads(json.dumps(payload)), fp))
        assert (back.time_s, back.limiter, back.fingerprint) == (rec.time_s, rec.limiter, fp)
