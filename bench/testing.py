"""Small sizes at which the tests drive a cell on the CPU: every width
cut, the paths and the arithmetic as on the card (the program's kernels run
their plain versions there)."""
from __future__ import annotations

import torch

from bench import harness

ARCH = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128, "vocab": 256,
        "rwkv_head_dim": 16, "compute_dtype": "float32"}
TRAFFIC = {"train": {"batch": 2, "seq_len": 64},
           "serve": {"requests": 2, "batches_per_cycle": 3, "prompt_median": 32, "prompt_sigma": 0.5,
                     "answer_median": 6, "answer_sigma": 0.3, "max_new_tokens": 8}}
WORKLOAD = {"serve": {"checked_requests": 4}}


def smoke_cell(name: str, arch: dict | None = None, traffic: dict | None = None, workload: dict | None = None,
               seconds: float = 0.2, trace: bool = False, seed: int = 2**31 + 11, **kw) -> harness.Cell:
    """The cell ``name`` at the small sizes (``arch``, ``traffic`` and
    ``workload`` change them further), on the CPU."""
    kind = harness.load_cell(name).traffic["kind"]
    return harness.load_cell(name, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"),
                             overrides={"config": {"arch": {**ARCH, **(arch or {})}},
                                        "traffic": {**TRAFFIC[kind], **(traffic or {})},
                                        "workload": {**WORKLOAD.get(kind, {}), **(workload or {})}}, **kw)
