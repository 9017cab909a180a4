"""Trainer: checkpoint/restart fault tolerance and straggler counting.

Counterpart of ``repro.train.trainer``, with its behaviour:
  * an async checkpoint every ``ckpt_every`` steps and at the end; restore
    picks the newest *committed* step (a crash mid-save is harmless);
  * the data is a pure function of the step, so a resumed run sees the
    batches the first run saw;
  * a step that raises (device loss, preemption; ``fault_hook`` injects
    them) is caught, the state restored from the last checkpoint (or the
    initial state when there is none), and training goes on; after
    ``max_retries`` failures in a row it gives up;
  * each step's wall time feeds an EMA, and a step slower than
    ``straggler_factor`` times it is logged and counted.

The JAX trainer draws its initial parameters from a key in ``init_state``;
here they are the model's own at the start of :meth:`Trainer.fit` (from
``build_model`` or converted from the JAX tree), and a host copy of them is
the state a restart returns to before the first checkpoint.  The state is
``{"params": the model's named parameters, "opt_state": the optimizer's}``,
updated in place; a step's wall time ends after ``torch.cuda.synchronize``
on the card.

``mesh`` and ``shape`` are keywords (default: one device, and the dataset
gives the batch its shape).  With a ``DeviceMesh``, as the JAX trainer
does: the parameters are laid out on it by their blueprint specs (when the
step is made), the optimizer state by theirs (at the first step), each
batch is built whole and split by ``batch_pspecs`` (``data.to_mesh``), the
step runs under ``sharding_ctx``, and a restart restores the checkpoint
with the placements of the current mesh.  Checkpoints are written whole by
rank 0.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..checkpoint.manager import AsyncCheckpointer, latest_step, place_like, restore
from ..configs.base import ShapeConfig
from ..data.pipeline import SyntheticTokenDataset, to_device, to_mesh
from ..models.registry import LM
from ..models.shardctx import is_dtensor
from ..optim.optimizers import Optimizer
from .sharding import batch_pspecs, rules_for_mesh
from .step import make_train_step


def _whole(t: torch.Tensor) -> torch.Tensor:
    """``t``'s whole value: a DTensor gathered."""
    return t.full_tensor() if is_dtensor(t) else t


@dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    peak_lr: float = 3e-4
    straggler_factor: float = 3.0
    max_retries: int = 3


@dataclass
class Trainer:
    model: LM
    optimizer: Optimizer
    tcfg: TrainerConfig
    fault_hook: Optional[Callable[[int], None]] = None  # raises to inject faults
    log: list = field(default_factory=list)
    mesh: Any = None  # a DeviceMesh; None: one device
    shape: Optional[ShapeConfig] = None  # sizes the batch specs; None: the dataset's

    def __post_init__(self):
        self.step_fn = make_train_step(self.model, self.optimizer, self.mesh, self.shape,
                                       peak_lr=self.tcfg.peak_lr)
        if self.mesh is not None:
            self.rules = rules_for_mesh(self.mesh)
        self.params = dict(self.model.named_parameters())
        self.ckpt = AsyncCheckpointer(self.tcfg.ckpt_dir, keep=self.tcfg.keep)
        self.stragglers = 0
        self.restarts = 0

    # ------------------------------------------------------------------ #
    def _restore(self, state: dict, initial: Optional[dict] = None) -> tuple[int, dict]:
        """(step, state) from the newest committed checkpoint, copied into
        the model's parameters.  Where there is none: (0, ``state``), or
        with ``initial`` (host copies of the parameters at the start) the
        parameters reset to them and a fresh optimizer state."""
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None and initial is None:
            return 0, state
        if step is None:
            loaded = {"params": initial, "opt_state": None}
        else:
            loaded = restore(self.tcfg.ckpt_dir, step, state)  # laid out as the state is
        with torch.no_grad():
            for n, p in self.params.items():
                src = loaded["params"][n]
                p.copy_(place_like(src, p) if is_dtensor(p) and not is_dtensor(src) else src)
        opt_state = loaded["opt_state"] or self.optimizer.init(self.params)
        return step or 0, {"params": self.params, "opt_state": opt_state}

    def _batch(self, dataset: SyntheticTokenDataset, step: int, device) -> dict:
        """The step's batch on the device, or split over the mesh."""
        if self.mesh is None:
            return to_device(dataset.batch(step), device)
        shape = self.shape or ShapeConfig("dataset", dataset.seq_len, dataset.global_batch, "train")
        return to_mesh(dataset.batch(step), self.mesh, batch_pspecs(self.model.cfg, shape, self.mesh, self.rules))

    # ------------------------------------------------------------------ #
    def fit(self, dataset: SyntheticTokenDataset, n_steps: int, resume: bool = True) -> dict:
        device = self.model.device
        state = {"params": self.params, "opt_state": self.optimizer.init(self.params)}
        initial = {n: _whole(p).detach().to("cpu", copy=True) for n, p in self.params.items()}
        start = 0
        if resume:
            start, state = self._restore(state)
        step = start
        ema = None
        retries = 0
        while step < n_steps:
            batch = self._batch(dataset, step, device)
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                metrics = self.step_fn(state["opt_state"], batch)
                loss = float(_whole(metrics["loss"]))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                retries = 0
            except Exception as e:  # noqa: BLE001 — node failure / preemption
                self.restarts += 1
                retries += 1
                if retries > self.tcfg.max_retries:
                    raise RuntimeError(f"step {step} failed {retries} times; giving up") from e
                self.ckpt.wait()
                step, state = self._restore(state, initial)
                self.log.append({"event": "restart", "step": step, "err": repr(e)})
                continue
            dt = time.perf_counter() - t0
            if ema is not None and dt > self.tcfg.straggler_factor * ema:
                self.stragglers += 1
                self.log.append({"event": "straggler", "step": step, "dt": dt})
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            self.log.append({"event": "step", "step": step, "loss": loss,
                             "grad_norm": float(_whole(metrics["grad_norm"])), "dt": dt})
            step += 1
            if step % self.tcfg.ckpt_every == 0 or step == n_steps:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state
