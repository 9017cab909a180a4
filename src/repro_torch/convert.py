"""Turn the JAX package's state, given as numpy arrays, into the port's tensors.

Both packages then compute on the same inputs: the stencil's ``src`` and
star weights, the LB step's ``(f, phase, vel)``, attention's ``(q, k, v)``,
the WKV's ``(r, k, v, wlog, u)`` and a model's parameter tree.  Layouts are
the same in both packages ((nz, ny, nx), SoA pdfs, (B, H, S, D), (BH, S, K),
the blueprint's leaves), so conversion only changes the container and the
device, and for a model unstacks the per-layer leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .device import resolve_device
from .models.params import tree_map
from .models.registry import unstack


def to_tensor(a, device: str | torch.device | None = None) -> torch.Tensor:
    """A contiguous tensor of ``a``'s values and dtype on ``device``.

    bfloat16 (``ml_dtypes``) arrays, which :func:`torch.from_numpy` refuses,
    go through float32, which holds every bfloat16 value exactly.
    """
    a = np.array(a, order="C")  # a writable copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def stencil_state(src, weights, device: str | torch.device | None = None):
    """``(src, weights)`` of the stencil as tensors on ``device``."""
    return to_tensor(src, device), to_tensor(weights, device)


def lbm_state(f, phase, vel, device: str | torch.device | None = None):
    """``(f, phase, vel)`` of the LB step as tensors on ``device``."""
    return tuple(to_tensor(a, device) for a in (f, phase, vel))


def attention_state(q, k, v, device: str | torch.device | None = None):
    """``(q, k, v)`` of attention as tensors on ``device``."""
    return tuple(to_tensor(a, device) for a in (q, k, v))


def wkv_state(r, k, v, wlog, u, device: str | torch.device | None = None):
    """``(r, k, v, wlog, u)`` of the WKV as tensors on ``device``."""
    return tuple(to_tensor(a, device) for a in (r, k, v, wlog, u))


def lm_params(cfg: ArchConfig, tree, device: str | torch.device | None = None) -> dict:
    """The JAX package's parameter tree of ``cfg`` (nested dicts of numpy
    arrays, as ``jax.tree.map(np.asarray, params)`` gives them) as the
    port's ``LM`` state: flat names, the stacked ``(L, ...)`` block leaves
    unstacked into ``blocks.<l>.<name>``.  ``LM(cfg, lm_params(cfg, tree))``
    is then the JAX model with these parameters."""
    return unstack(cfg, tree_map(lambda a: to_tensor(a, device), tree))
