"""Checkpointing: async save, atomic commit, restore.

Counterpart of ``repro.checkpoint.manager``, with its layout and protocol:
``<dir>/step_<n>/arr_<i>.npy`` + ``manifest.json`` + ``COMMIT``.

* A state is a tree of nested dicts whose leaves are tensors (or numpy
  arrays); its leaves are saved as ``.npy`` in the order of sorted keys,
  the order ``jax.tree.flatten`` gives a dict tree, and the manifest names
  each leaf by its path (``['params']['embed']``).
* The snapshot is taken synchronously: every leaf is copied to host memory
  before ``save`` returns, so the next step may update the tensors in
  place.  A background thread then writes the files into
  ``step_<n>.tmp``, writes ``COMMIT`` last and renames the directory into
  place.  Only committed steps restore, so a crash mid-save is harmless.
* ``keep`` prunes all but the newest committed steps after each save.
* ``restore`` loads a step into the structure of a given state, each leaf
  on that leaf's device and in its dtype.  One device for now: the JAX
  package's resharding onto another mesh waits for distribution.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) of a nested dict, keys sorted at every level."""
    if isinstance(tree, Mapping):
        return [item for k in sorted(tree) for item in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _unflatten(like, leaves: list):
    """``like``'s dict structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf, independent of later in-place updates."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


class AsyncCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any, blocking: bool = False):
        """Snapshot ``state`` to host memory now and write it on a thread."""
        self.wait()
        flat = _flatten(state)
        host = [_to_host(leaf) for _, leaf in flat]
        meta = {"step": int(step), "n_leaves": len(host), "paths": [p for p, _ in flat]}

        def _write():
            try:
                d = _step_dir(self.directory, step)
                tmp = d + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, arr in enumerate(host):
                    np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(meta, f)
                with open(os.path.join(tmp, "COMMIT"), "w") as f:
                    f.write("ok")
                if os.path.exists(d):
                    shutil.rmtree(d)
                os.rename(tmp, d)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in committed_steps(self.directory)[: -self.keep]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)


def committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like: Any) -> Any:
    """Load ``step`` into the structure of ``like``: each leaf a new tensor
    on the device and in the dtype of ``like``'s leaf, loaded one file at a
    time."""
    d = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    flat = _flatten(like)
    if meta["n_leaves"] != len(flat):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, expected {len(flat)}")
    leaves = []
    for i, (_, leaf) in enumerate(flat):
        arr = torch.from_numpy(np.load(os.path.join(d, f"arr_{i}.npy")))
        leaves.append(arr.to(leaf.device, leaf.dtype) if isinstance(leaf, torch.Tensor) else arr.numpy())
    return _unflatten(like, leaves)
