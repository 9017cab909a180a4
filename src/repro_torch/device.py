"""Default device for the functions that create state."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises if CUDA is asked for (explicitly or by default) and unavailable:
    state meant for the card never lands on the CPU by accident.  Pass
    ``device="cpu"`` to run the plain versions.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
