"""Deterministic synthetic data pipeline.

Counterpart of ``repro.data.pipeline``.  The dataset is a pure function of
(seed, step), made with numpy exactly as the JAX package makes it, so both
packages see the same tokens, labels and frontend embeddings at every step
and a restart resumes bit-identically from a checkpointed step.  Tokens
follow a skewed (Zipf-ish) distribution with a simple Markov overlay.

:func:`to_device` copies a batch to one device.  On a mesh every rank
builds the whole batch from the step's seed and :func:`to_mesh` lays it
out by its specs (the batch split over the dp axes, ``Shard(0)``), as
``jax.device_put`` of the global batch does in the JAX package's
``ShardedLoader``.  :class:`ShardedLoader` builds the host batches ahead on
a thread and places each with one of the two; the trainer, as the JAX
package's, builds its batches inline instead.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class SyntheticTokenDataset:
    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        n_frontend_tokens: int = 0,
        frontend_dim: int = 0,
    ):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.n_frontend_tokens = n_frontend_tokens
        self.frontend_dim = frontend_dim
        # fixed Markov successor table: token t prefers successor (a*t + b) % V
        rng = np.random.default_rng(seed)
        self._succ = rng.permutation(vocab).astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # Zipf-ish marginal via exponential transform
        u = rng.random((B, S))
        base = np.minimum((np.exp(u * 6.0) - 1.0) / (np.e**6 - 1.0) * V, V - 1).astype(
            np.int32
        )
        # Markov overlay: with p=0.5 the next token is succ(prev)
        toks = base.copy()
        follow = rng.random((B, S)) < 0.5
        toks[:, 1:] = np.where(follow[:, 1:], self._succ[toks[:, :-1]], base[:, 1:])
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        out = {"tokens": toks, "labels": labels}
        if self.n_frontend_tokens:
            out["frontend_embeds"] = rng.standard_normal(
                (B, self.n_frontend_tokens, self.frontend_dim)
            ).astype(np.float32)
        return out


def to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: token ids as int64, the index
    type of the embedding gather, and embeddings in their own dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = t.to(device, torch.int64) if v.dtype.kind in "iu" else t.to(device)
    return out


def to_mesh(batch: dict[str, np.ndarray], mesh, specs: dict) -> dict:
    """A host batch as DTensors on ``mesh``, each laid out by its entry of
    ``specs`` (``train.sharding.batch_pspecs``)."""
    from ..train.sharding import place

    return {k: place(t, mesh, specs[k]) for k, t in to_device(batch, mesh.device_type).items()}


class ShardedLoader:
    """Places host batches on ``device``, or onto ``mesh`` by ``specs``
    (``train.sharding.batch_pspecs``), prefetching ``depth`` steps ahead on
    a background thread.  ``next(loader)`` gives ``(step, batch)`` from
    ``start_step`` on; :meth:`stop` ends the thread.

    Counterpart of ``repro.data.ShardedLoader``: the thread builds the host
    batches (numpy, from the step's seed) and the caller's thread places
    each one as it takes it."""

    def __init__(self, dataset, device=None, mesh=None, specs: dict | None = None,
                 start_step: int = 0, depth: int = 2):
        from ..device import resolve_device

        if mesh is not None and specs is None:
            raise ValueError("a mesh needs the specs its batches are laid out by")
        self.dataset = dataset
        self.mesh = mesh
        self.specs = specs
        self.device = None if mesh is not None else resolve_device(device)
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, host_batch):
        if self.mesh is not None:
            return to_mesh(host_batch, self.mesh, self.specs)
        return to_device(host_batch, self.device)

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch(step)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, self._place(batch)

    def stop(self, timeout: float = 5.0) -> None:
        """Ends the prefetch thread (it stops within its 0.5 s put timeout)."""
        self._stop.set()
        self._thread.join(timeout)
