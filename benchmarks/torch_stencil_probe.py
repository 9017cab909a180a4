#!/usr/bin/env python3
"""What limits the port's star stencil at the paper's grid: latency and L1
work, or the traffic of each block's footprint.

    python3 benchmarks/torch_stencil_probe.py

Needs an NVIDIA Hopper card and the CUDA toolkit.  At the paper's grid
(nz, ny, nx) = (512, 512, 640) f64, r = 4, and the (block, fold) that the
estimator picks, it times in turns on one card (CUDA events around launches
back to back, each variant twice: forward, then in reverse order):

    direct       the direct kernel, every point a global load with clamped
                 indices (``stencil25_direct_cuda``);
    copy_only    the staged kernel with each cell's stencil replaced by a
                 store of its centre value: its copies of the footprint into
                 shared memory alone, the floor that staging reaches at
                 these volumes;
    unclamped    the direct kernel without the clamps, in blocks whose
                 footprint lies inside the grid (the others keep them),
                 bound like it to two 1024-thread blocks per SM;
    staged       the staged kernel (``stencil25_cuda``, the main path's);

and, run as a script, three more copies of the staged kernel:

    compute_only without its copies (it computes on what shared memory
                 holds): its reads of shared memory and arithmetic alone;
    one_block    bound to one 1024-thread block per SM
                 (``__launch_bounds__(1024)``: up to 64 registers);
    element_copy with every row copied element by element with cp.async,
                 never as one bulk copy.

The variants are built from ``src/repro_torch/csrc/stencil25.cu`` with text
edits, into ``build/stencil_probe/``; every edit must match the source
once.  Prints one JSON line: each variant's time, registers, spills and
blocks per SM, its error against ``stencil25_plain`` (for the variants that
compute the stencil), ``copy_ms`` of ``dst.copy_(src)`` and the bytes per
cell that copy_only implies at that copy rate; then the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _build  # noqa: E402
from repro_torch.kernels.stencil25 import kernel as st_kernel  # noqa: E402
from repro_torch.kernels.stencil25 import select_block, stencil25_plain  # noqa: E402
from repro_torch.kernels.stencil25.ref import star_weights_np  # noqa: E402

OUT = ROOT / "build" / "stencil_probe"
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "stencil25.cu"
SHAPE = (512, 512, 640)  # (nz, ny, nx) = paper grid (640, 512, 512)
R = 4
REPS = 20
COMPUTE = "  stencil_cells<T, FY, FZ>(box, f, dst, nx, ny, tx, ty, tz, wts);\n"
CENTRES = """\
  {  // probe: the centre values only
    const int64_t sy = nx, sz = static_cast<int64_t>(nx) * ny;
    const int lx = threadIdx.x, ly = threadIdx.y * FY, lz = threadIdx.z * FZ;
#pragma unroll
    for (int j = 0; j < FY * FZ; ++j)
      store(dst + (FZ * tz + j * (FZ - 1)) * sz + (FY * ty + j * (FY - 1)) * sy + tx,
            to_acc(box[Cell(f, lx, ly + j * (FY - 1), lz + j * (FZ - 1)).c]));
  }
"""
COPY_LOOP = "for (int q = tid; q < x_rows + y_rows + z_rows; q += nthreads) {"
BULK_TEST = "  if (gx0 >= 0 && gx0 + w <= nx && bytes % 16 == 0 &&"
STAGED_BOUNDS = "__launch_bounds__(1024, 2)\n    stencil25_staged_kernel("
DIRECT_BOUNDS = "__launch_bounds__(1024)\n    stencil25_direct_kernel("
CLAMPS = {
    "const int xp = min(x + d, nx - 1), xm = max(x - d, 0);": "const int xp = x + d, xm = x - d;",
    "const int yp = min(y + d, ny - 1), ym = max(y - d, 0);": "const int yp = y + d, ym = y - d;",
    "const int zp = min(z + d, nz - 1), zm = max(z - d, 0);": "const int zp = z + d, zm = z - d;",
}
INNER = """\
  const int bx0 = blockIdx.x * blockDim.x * FX, by0 = blockIdx.y * blockDim.y * FY;
  const int bz0 = blockIdx.z * blockDim.z * FZ;
  const bool inner = bx0 >= r && by0 >= r && bz0 >= r &&
                     bx0 + static_cast<int>(blockDim.x) * FX + r <= nx &&
                     by0 + static_cast<int>(blockDim.y) * FY + r <= ny &&
                     bz0 + static_cast<int>(blockDim.z) * FZ + r <= nz;
"""


def _once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"probe edit does not match stencil25.cu once: {old[:60]!r}")
    return text.replace(old, new)


def _unclamped(text: str) -> str:
    """The direct kernel's cell loop twice: without clamps where the block's
    footprint lies inside the grid, with them elsewhere."""
    start = text.index("stencil25_direct_kernel(")
    loop = text.index("#pragma unroll\n  for (int jz = 0;", start)
    depth, end = 0, loop
    for end in range(text.index("{", loop), len(text)):
        depth += {"{": 1, "}": -1}.get(text[end], 0)
        if depth == 0:
            break
    body = text[loop:end + 1]
    fast = body
    for old, new in CLAMPS.items():
        fast = _once(fast, old, new)
    return text[:loop] + INNER + "  if (inner) {\n" + fast + "\n  } else {\n" + body + "\n  }\n" + text[end + 1:]


CORE = ("direct", "copy_only", "unclamped", "staged")  # the variants chip_smoke.py times


def variant_sources() -> dict[str, str]:
    """Source of each variant that is not the repository's own kernel."""
    text = SOURCE.read_text()
    return {
        "copy_only": _once(text, COMPUTE, CENTRES),
        "unclamped": _once(_unclamped(text), DIRECT_BOUNDS,
                           "__launch_bounds__(1024, 2)\n    stencil25_direct_kernel("),
        "compute_only": _once(text, COPY_LOOP, COPY_LOOP.replace("q = tid;", "q = x_rows + y_rows + z_rows;")),
        "one_block": _once(text, STAGED_BOUNDS, "__launch_bounds__(1024)\n    stencil25_staged_kernel("),
        "element_copy": _once(text, BULK_TEST, BULK_TEST.replace("if (", "if (false && ")),
    }


def start_builds(names=CORE) -> dict[str, tuple[subprocess.Popen, Path]]:
    """One ``nvcc`` for each of the variants ``names`` that is not the
    repository's own kernel, all started together; see :func:`finish_builds`."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in variant_sources().items():
        if name not in names:
            continue
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        cmd = [_build.toolkit_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    return jobs


def finish_builds(jobs) -> dict[str, ctypes.CDLL]:
    libs = {}
    for name, (proc, so) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} probe variant:\n{out}{err}")
        lib = ctypes.CDLL(str(so))
        for fn, args in (("stencil25_launch", st_kernel._lib().stencil25_launch.argtypes),
                         ("stencil25_direct_launch", st_kernel._lib().stencil25_direct_launch.argtypes),
                         ("stencil25_allow_smem", st_kernel._lib().stencil25_allow_smem.argtypes),
                         ("stencil25_occupancy", st_kernel._lib().stencil25_occupancy.argtypes),
                         ("stencil25_attributes", st_kernel._lib().stencil25_attributes.argtypes)):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launcher(lib: ctypes.CDLL, staged: bool, src: torch.Tensor, dst: torch.Tensor, block, fold):
    nz, ny, nx = src.shape
    code = st_kernel._DTYPE_CODES[src.dtype]
    weights = (ctypes.c_double * (6 * R + 1))(*star_weights_np(R))
    n_bytes = st_kernel.smem_bytes(block, fold, R, src.dtype)
    if staged and lib.stencil25_allow_smem(code, *fold, st_kernel.MAX_SMEM_BYTES):
        raise RuntimeError("cudaFuncSetAttribute failed")

    def launch() -> None:
        stream = torch.cuda.current_stream().cuda_stream
        if staged:
            err = lib.stencil25_launch(code, src.data_ptr(), dst.data_ptr(), nx, ny, nz, R, weights,
                                       *block, *fold, n_bytes, stream)
        else:
            err = lib.stencil25_direct_launch(code, src.data_ptr(), dst.data_ptr(), nx, ny, nz, R,
                                              weights, *block, *fold, stream)
        if err:
            raise RuntimeError(f"probe launch failed: CUDA error {err}")
    return launch


def _time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _attrs(lib: ctypes.CDLL, staged: bool, fold) -> dict:
    vals = [ctypes.c_int() for _ in range(3)]
    if lib.stencil25_attributes(int(staged), 0, *fold, *(ctypes.byref(v) for v in vals)):
        raise RuntimeError("cudaFuncGetAttributes failed")
    return {"registers": vals[0].value, "local_bytes": vals[1].value}


def _blocks_per_sm(lib: ctypes.CDLL, block, fold) -> int:
    n = ctypes.c_int()
    if lib.stencil25_occupancy(0, *fold, block[0] * block[1] * block[2],
                               st_kernel.smem_bytes(block, fold, R, torch.float64), ctypes.byref(n)):
        raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor failed")
    return n.value


STAGED = ("copy_only", "staged", "compute_only", "one_block", "element_copy")


def run(libs: dict[str, ctypes.CDLL], names=CORE) -> dict:
    """Times the variants ``names`` in turns at the paper's grid; ``libs``
    holds the built ones (:func:`finish_builds`)."""
    cfg, pred = select_block(SHAPE, R, torch.float64)
    block, fold = tuple(cfg["block"]), tuple(cfg["fold"])
    main = st_kernel._lib()
    libs = {**libs, "direct": main, "staged": main}
    src = torch.randn(SHAPE, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda", dtype=torch.float64)
    plain = stencil25_plain(src, R)
    rows = {}
    for name in names:
        staged = name in STAGED
        dst = torch.empty_like(src)
        launch = _launcher(libs[name], staged, src, dst, block, fold)
        launch()
        torch.cuda.synchronize()
        row = {"launch": launch, "ms": [], **_attrs(libs[name], staged, fold)}
        if staged:
            row["blocks_per_sm"] = _blocks_per_sm(libs[name], block, fold)
        if name not in ("copy_only", "compute_only"):
            row["max_abs_err"] = float((dst - plain).abs().max())
        rows[name] = row
    del plain
    for name in list(names) + list(reversed(names)):
        rows[name]["ms"].append(_time_ms(rows[name]["launch"]))
    copy_dst = torch.empty_like(src)
    copy_ms = _time_ms(lambda: copy_dst.copy_(src))
    cells = src.numel()
    out = {"shape": SHAPE, "dtype": "float64", "r": R, "block": block, "fold": fold,
           "predicted_glups": pred.glups, "predicted_ms": cells / pred.glups / 1e6,
           "copy_ms": copy_ms, "reps": REPS}
    for name, row in rows.items():
        out[name] = {k: v for k, v in row.items() if k != "launch"}
        out[name]["mean_ms"] = sum(row["ms"]) / len(row["ms"])
    # bytes per cell that copy_only moves if it runs at the copy_ rate (16 B per cell)
    out["copy_only_bytes_per_cell_at_copy_rate"] = 16.0 * out["copy_only"]["mean_ms"] / copy_ms
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stencil_probe: needs a CUDA card", file=sys.stderr)
        return 1
    names = CORE + tuple(n for n in variant_sources() if n not in CORE)
    jobs = start_builds(names)
    _build.build(("stencil25",))
    print(json.dumps(run(finish_builds(jobs), names)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
