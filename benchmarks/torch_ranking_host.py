#!/usr/bin/env python3
"""Host seconds of the paper path's ranking: the batched estimator against
the per-configuration one, on the host this runs on.

    python3 benchmarks/torch_ranking_host.py

``select_block`` ranks the paper's spaces on the host CPU before its kernel
runs: the 162 stencil configurations at (512, 512, 640) and the 49 LBM ones
at (256, 256, 512), f64, on the H100 model.  This times, for each space,
``rank_configs`` (the batched ``estimate_many``, one fresh cache a call)
cold, with its cache cleared, and then the per-configuration reference
path (``estimate`` and ``predict`` for each configuration in turn) over the
same specs, and checks that the two give equal estimates and predictions.
It needs no card.  Prints one JSON line with the seconds, the CPU count and
the processor's name.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import appspec  # noqa: E402
from repro_torch.core.estimator import estimate  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.core.model import predict  # noqa: E402
from repro_torch.kernels import lbm_d3q15 as lbm  # noqa: E402
from repro_torch.kernels import stencil25  # noqa: E402

SPACES = {  # name: (entry point module, rank_configs' arguments, spec builder)
    "stencil25": (stencil25, ((512, 512, 640), 4, torch.float64, H100_SXM), appspec.star3d),
    "lbm_d3q15": (lbm, ((256, 256, 512), torch.float64, H100_SXM), appspec.lbm_d3q15),
}


def _processor() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def main() -> int:
    out = {}
    for name, (module, args, build) in SPACES.items():
        module.rank_configs.cache_clear()
        t0 = time.perf_counter()
        batched = module.rank_configs(*args)
        batched_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_config = []
        for cfg, _, _ in batched:
            spec = build(**cfg)
            est = estimate(spec, H100_SXM)
            per_config.append((est, predict(spec, est, H100_SXM)))
        per_config_s = time.perf_counter() - t0
        equal = all(dataclasses.asdict(e) == dataclasses.asdict(be)
                    and dataclasses.astuple(p) == dataclasses.astuple(bp)
                    for (e, p), (_, be, bp) in zip(per_config, batched))
        if not equal:
            raise SystemExit(f"torch_ranking_host: {name}: the two paths disagree")
        out[name] = {"configs": len(batched), "batched_s": batched_s,
                     "per_config_s": per_config_s, "ratio": per_config_s / batched_s}
    print(json.dumps({"host": _processor(), "cpus": os.cpu_count(), "spaces": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
