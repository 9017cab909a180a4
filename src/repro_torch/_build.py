"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with :mod:`ctypes`.  Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the source
and the flags, so an edited source builds again and an unchanged one loads
the library already there; the hash also covers the ``csrc/*.cuh``
headers that a source includes.  A failed build raises with the compiler's output
(including the ``-Xptxas -v`` report); nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Library:
    name: str
    path: Path
    cdll: ctypes.CDLL
    build_seconds: float  # 0.0 when an up-to-date library was loaded


def toolkit_tool(name: str) -> str:
    """A program of the CUDA toolkit that builds the kernels (``cuobjdump``,
    ``nvdisasm``), found beside its ``nvcc``."""
    tool = Path(_nvcc()).parent / name
    if not tool.exists():
        raise RuntimeError(f"{name} not found beside {_nvcc()}")
    return str(tool)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def _headers(src: Path, seen: tuple[Path, ...] = ()) -> tuple[Path, ...]:
    """The ``csrc/*.cuh`` files that ``src`` includes, directly or through
    another of them, in the order first met."""
    found = list(seen)
    for m in _INCLUDE.finditer(src.read_bytes()):
        header = CSRC / m.group(1).decode()
        if header.exists() and header not in found:
            found = list(_headers(header, (*found, header)))
    return tuple(found)


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in _headers(src):  # an edited header builds its sources again
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...]) -> dict[str, Library]:
    """Build (where needed) and load the named kernels, one ``nvcc`` per
    source, all started together."""
    return {lib.name: lib for lib in _build_all(tuple(names))}


def load(name: str) -> Library:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    return build((name,))[name]


@functools.cache
def _dlopen(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))


def _build_all(names: tuple[str, ...]) -> list[Library]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    jobs = {}
    t0 = time.perf_counter()
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        jobs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    seconds = {}
    failures = []
    for n, (tmp, proc) in jobs.items():
        out_text, err_text = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on csrc/{n}.cu (exit {proc.returncode}):\n{out_text}{err_text}")
            continue
        os.replace(tmp, targets[n])
    if failures:
        raise RuntimeError("\n".join(failures))
    return [Library(n, targets[n], _dlopen(targets[n]), seconds.get(n, 0.0)) for n in names]
