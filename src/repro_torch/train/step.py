"""The train step.

Counterpart of ``repro.train.step.make_train_step`` on one device: the loss
and its gradient, global-norm clipping, the WSD learning rate at the
optimizer's count, and the optimizer's update.  The JAX step is a pure
function of (params, opt_state, batch) that XLA compiles with sharding
trees; here the step updates the model's parameters and the optimizer state
in place and returns the metrics.  Sharding waits for distribution.

With ``cfg.microbatch`` > 1 (and the batch divisible by it) the batch is
split into that many microbatches along its first axis, as the JAX step
reshapes it, each microbatch's gradient added into f32 accumulators, and
the sum divided by their number; only one microbatch's activations are
alive at a time.  Loss and metrics are the microbatches' means.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.registry import LM
from ..optim.optimizers import Optimizer, clip_by_global_norm, wsd_schedule


def make_train_step(
    model: LM,
    optimizer: Optimizer,
    peak_lr: float = 3e-4,
    grad_clip: float = 1.0,
) -> Callable[[dict, dict], dict]:
    """``train_step(opt_state, batch) -> metrics`` for ``model``, whose
    parameters it makes trainable (``requires_grad_``) and updates in place.
    ``batch``: {"tokens", "labels"} (B, S) and "frontend_embeds" where the
    config has a frontend, on the model's device.  Metrics: "ce", "aux",
    "zloss", "loss", "grad_norm" and "lr", 0-d tensors on the device (no
    step waits for the host)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    n_micro = model.cfg.microbatch or 0

    def loss_and_grads(b):
        loss, metrics = model.loss(b)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(params, grads))

    def train_step(opt_state: dict, batch: dict) -> dict:
        step_no = opt_state["count"]
        n_batch = batch["tokens"].shape[0]
        if n_micro > 1 and n_batch % n_micro == 0:
            size = n_batch // n_micro
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
            losses, ms = [], []
            for i in range(n_micro):
                loss, metrics, g = loss_and_grads({k: v[i * size:(i + 1) * size] for k, v in batch.items()})
                for n, t in g.items():
                    grads[n].add_(t)
                del g
                losses.append(loss)
                ms.append(metrics)
            for t in grads.values():
                t.div_(n_micro)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        else:
            loss, metrics, grads = loss_and_grads(batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = wsd_schedule(step_no, peak_lr=peak_lr)
        optimizer.update(grads, opt_state, params, lr)
        return dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step
