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
* A DTensor leaf is gathered whole (``full_tensor``, a collective every
  rank joins) and one rank, rank 0, writes; :meth:`AsyncCheckpointer.wait`
  then holds every rank until the write is done, so that none reads the
  directory early.
* ``restore`` loads a step into the structure of a given state, each leaf
  on that leaf's device and in its dtype, and re-places it under the
  *current* mesh: a leaf of ``like`` that is a DTensor is laid out as that
  leaf is, or as ``placements`` says.  A checkpoint written on one mesh
  restores onto another, or onto one device (the JAX package's elastic
  restore).
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


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf, independent of later in-place updates; a
    DTensor's whole value."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _writes(distributed: bool) -> bool:
    """Whether this process writes: rank 0 of a distributed state, or any
    process of a local one."""
    import torch.distributed as dist

    return not distributed or dist.get_rank() == 0


def place_like(t: torch.Tensor, like, placements=None) -> torch.Tensor:
    """``t`` (a whole value, on the host) on ``like``'s device in its dtype;
    where ``placements`` = (mesh, placements) is given, or ``like`` is a
    DTensor, distributed onto that mesh in that layout."""
    if placements is None and _is_dtensor(like):
        placements = (like.device_mesh, like.placements)
    if placements is not None:
        from torch.distributed.tensor import distribute_tensor

        mesh, pl = placements
        return distribute_tensor(t.to(mesh.device_type, like.dtype), mesh, list(pl))
    return t.to(like.device, like.dtype)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


class AsyncCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._distributed = False

    def save(self, step: int, state: Any, blocking: bool = False):
        """Snapshot ``state`` to host memory now and write it on a thread."""
        self.wait()
        flat = _flatten(state)
        self._distributed = any(_is_dtensor(leaf) for _, leaf in flat)
        host = [_to_host(leaf) for _, leaf in flat]
        meta = {"step": int(step), "n_leaves": len(host), "paths": [p for p, _ in flat]}
        if not _writes(self._distributed):
            if blocking:
                self.wait()
            return

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
        if self._distributed:  # every rank waits for rank 0's write
            import torch.distributed as dist

            self._distributed = False
            dist.barrier()
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


def restore(directory: str, step: int, like: Any, placements: Any = None) -> Any:
    """Load ``step`` into the structure of ``like``: each leaf a new tensor
    on the device and in the dtype of ``like``'s leaf, loaded one file at a
    time, and laid out under the current mesh: as ``placements`` says (a
    tree like ``like`` whose leaves are (mesh, placements) or None), else
    as ``like``'s leaf is where that is a DTensor."""
    d = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    flat = _flatten(like)
    if meta["n_leaves"] != len(flat):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, expected {len(flat)}")
    targets = [None] * len(flat) if placements is None else [pl for _, pl in _flatten(placements)]
    leaves = []
    for i, (_, leaf) in enumerate(flat):
        arr = torch.from_numpy(np.load(os.path.join(d, f"arr_{i}.npy")))
        leaves.append(place_like(arr, leaf, targets[i]) if isinstance(leaf, torch.Tensor) else arr.numpy())
    return _unflatten(like, leaves)
