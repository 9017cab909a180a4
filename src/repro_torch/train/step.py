"""Train and serve step factories, with the placement trees of their
inputs and outputs.

Counterpart of ``repro.train.step``.  The JAX step is a pure function of
(params, opt_state, batch) that XLA compiles with sharding trees; here the
train step updates the model's parameters and the optimizer state in place
and returns the metrics: the loss and its gradient, global-norm clipping,
the WSD learning rate at the optimizer's count, and the optimizer's update.

With ``cfg.microbatch`` > 1 (and the batch divisible by it) the batch is
split into that many microbatches along its first axis, as the JAX step
reshapes it, each microbatch's gradient added into f32 accumulators, and
the sum divided by their number; only one microbatch's activations are
alive at a time.  Loss and metrics are the microbatches' means.

Every factory returns a :class:`StepBundle`.  Without a mesh it calls the
step as it is, on one device.  With a ``DeviceMesh`` the factory lays the
model's parameters out on it (``train.sharding.place_model``), the bundle
places each input by its spec tree before the call (jax's ``jit`` with
``in_shardings`` has no counterpart: DTensor ops run eagerly) and each
output after it, and the step runs under ``sharding_ctx``, so the model's
``constrain`` calls redistribute its activations.  The gradient norm is the
global one: DTensor sums every shard.

The train step opens spans (``obs.trace``): ``train.step`` with ``step``,
the count of the bundle's calls on the host, and inside it, for each
microbatch, ``train.forward`` (``model.loss``) and ``train.backward``
(``autograd.grad``), then ``train.clip`` and ``train.optimizer`` (the
learning rate and the update).  No span reads a device value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.params import P, ShardingRules, param_pspecs, tree_map
from ..models.registry import LM, _flat
from ..models.shardctx import is_dtensor, sharding_ctx
from ..obs.trace import span
from ..optim.optimizers import Optimizer, clip_by_global_norm, leaf_groups, wsd_schedule
from .sharding import (axis_size, batch_pspecs, cache_pspecs, layer_specs, mesh_spec, place_model,
                       place_tree, rules_for_mesh)


@dataclass
class StepBundle:
    """A step function plus the spec trees of its inputs and outputs, on
    ``mesh`` (None: one device, nothing placed).  Calling the bundle places
    the inputs, calls ``fn`` and places the outputs."""

    fn: Callable
    in_pspecs: tuple = ()
    out_pspecs: Any = None
    mesh: Any = None

    def __call__(self, *args):
        if self.mesh is None:
            return self.fn(*args)
        args = tuple(place_tree(a, s, self.mesh) for a, s in zip(args, self.in_pspecs))
        return place_tree(self.fn(*args), self.out_pspecs, self.mesh)


def opt_state_pspecs(optimizer: Optimizer, p_pspecs):
    """Optimizer moments inherit the parameter specs (fully sharded states),
    in the blueprint's layout as the JAX package's; :func:`port_opt_pspecs`
    gives them by parameter name, as the port keeps the state."""
    if optimizer.name == "adamw":
        return {"m": p_pspecs, "v": p_pspecs, "count": P()}
    if optimizer.name == "adafactor":

        def factored(ps):
            if isinstance(ps, P) and len(ps) >= 2:
                return {"vr": P(*ps[:-1]), "vc": P(*ps[:-2], ps[-1])}
            return {"v": ps}

        return {"v": tree_map(factored, p_pspecs), "count": P()}
    raise ValueError(optimizer.name)


def port_opt_pspecs(optimizer: Optimizer, cfg: ArchConfig, p_pspecs) -> dict:
    """:func:`opt_state_pspecs` in the layout of the port's optimizer state:
    keyed by parameter name, each stacked leaf's per-layer rows without the
    layer entry (Adafactor's ``vc`` of a stacked vector is one (d,) mean
    that every layer holds whole)."""
    if optimizer.name == "adamw":
        m = layer_specs(cfg, p_pspecs)
        return {"m": m, "v": m, "count": P()}
    flat = _flat(opt_state_pspecs(optimizer, p_pspecs)["v"])
    names = list(layer_specs(cfg, p_pspecs))
    out = {}
    for group, stacked in leaf_groups(names):
        for n in group:
            leaf = n if not stacked else "blocks." + n.split(".", 2)[2]
            keys = {k.rsplit(".", 1)[1]: v for k, v in flat.items() if k.rsplit(".", 1)[0] == leaf}
            per_layer = {"vr": stacked, "vc": stacked and len(keys.get("vr", ())) >= 2, "v": stacked}
            out[n] = {k: v[1:] if per_layer[k] else v for k, v in keys.items()}
    return {"v": out, "count": P()}


def _ep_rules(cfg: ArchConfig, mesh, rules: ShardingRules) -> ShardingRules:
    """``rules`` with experts over 'model' where the config asks for expert
    parallelism and the experts divide the axis."""
    if getattr(cfg, "moe_ep", False) and cfg.moe is not None and cfg.moe.n_experts % axis_size(mesh, "model") == 0:
        return dataclasses.replace(rules, ep="model")
    return rules


def _ctx(mesh, rules):
    return sharding_ctx(rules, dict(mesh_spec(mesh).axes), mesh)


def make_train_step(
    model: LM,
    optimizer: Optimizer,
    mesh=None,
    shape: Optional[ShapeConfig] = None,
    peak_lr: float = 3e-4,
    grad_clip: float = 1.0,
    rules: Optional[ShardingRules] = None,
) -> StepBundle:
    """``train_step(opt_state, batch) -> metrics`` for ``model``, whose
    parameters it makes trainable (``requires_grad_``) and updates in place.
    ``batch``: {"tokens", "labels"} (B, S) and "frontend_embeds" where the
    config has a frontend, on the model's device.  Metrics: "ce", "aux",
    "zloss", "loss", "grad_norm" and "lr", 0-d tensors on the device (no
    step waits for the host).

    ``mesh`` (a ``DeviceMesh``): the parameters are laid out on it first,
    the optimizer state and the batch are placed by their specs on each
    call, the metrics come back replicated.  ``shape`` sizes the batch
    specs (default: the batch's own, at the first call)."""
    cfg = model.cfg
    if mesh is not None:
        rules = _ep_rules(cfg, mesh, rules or rules_for_mesh(mesh))
        place_model(model, mesh, rules)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    n_micro = cfg.microbatch or 0
    calls = 0  # the bundle's calls, counted on the host for the spans

    def loss_and_grads(b):
        with span("train.forward"):
            loss, metrics = model.loss(b)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
            if mesh is not None:  # each gradient in its parameter's layout
                grads = [g.redistribute(mesh, p.placements) if tuple(g.placements) != tuple(p.placements) else g
                         for g, p in zip(grads, params.values())]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(params, grads))

    def step(opt_state: dict, batch: dict) -> dict:
        nonlocal calls
        calls += 1
        with span("train.step", step=calls):
            step_no = opt_state["count"]
            n_batch = batch["tokens"].shape[0]
            if n_micro > 1 and n_batch % n_micro == 0:
                size = n_batch // n_micro
                grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
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
            with span("train.clip"):
                grads, gnorm = clip_by_global_norm(grads, grad_clip)
            with span("train.optimizer"):
                lr = wsd_schedule(step_no, peak_lr=peak_lr)
                optimizer.update(grads, opt_state, params, lr)
            return dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    if mesh is None:
        return StepBundle(fn=step)
    p_pspecs = param_pspecs(model.blueprint(), rules)
    o_pspecs = port_opt_pspecs(optimizer, cfg, p_pspecs)
    b_pspecs = batch_pspecs(cfg, shape, mesh, rules) if shape is not None else None
    metrics_pspecs = {k: P() for k in ("ce", "aux", "zloss", "loss", "grad_norm", "lr")}

    def train_step(opt_state: dict, batch: dict) -> dict:
        if b_pspecs is None:  # no shape given: the batch's own
            tokens = batch["tokens"]
            own = ShapeConfig("batch", tokens.shape[1], tokens.shape[0], "train")
            batch = place_tree(batch, batch_pspecs(cfg, own, mesh, rules), mesh)
        with _ctx(mesh, rules):
            return step(opt_state, batch)

    return StepBundle(fn=train_step, in_pspecs=(o_pspecs, b_pspecs), out_pspecs=metrics_pspecs, mesh=mesh)


def make_prefill_step(model: LM, mesh=None, shape: Optional[ShapeConfig] = None) -> StepBundle:
    """``prefill(batch) -> logits`` (B, S, V) f32: the model's forward
    without gradients on {"tokens"} and "frontend_embeds" where the config
    has a frontend; on ``mesh`` the logits come back split as P(dp, None,
    "model")."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill(batch):
        logits, _ = model(batch["tokens"], batch.get("frontend_embeds"))
        return logits

    if mesh is None:
        return StepBundle(fn=prefill)
    if shape is None:
        raise ValueError("a mesh needs the shape its batch specs are sized by")
    rules = _ep_rules(cfg, mesh, rules_for_mesh(mesh))
    place_model(model, mesh, rules)
    b_pspecs = batch_pspecs(cfg, shape, mesh, rules)
    dp = b_pspecs["tokens"][0]

    def step(batch):
        with _ctx(mesh, rules):
            return prefill(batch)

    in_b = {k: v for k, v in b_pspecs.items() if k != "labels"}
    return StepBundle(fn=step, in_pspecs=(in_b,), out_pspecs=P(dp, None, "model"), mesh=mesh)


def make_decode_step(model: LM, mesh=None, shape: Optional[ShapeConfig] = None) -> StepBundle:
    """``decode(cache, tokens) -> (logits, cache)``: ``LM.decode_step``
    without gradients, the cache updated in place; on ``mesh`` the cache is
    placed by ``cache_pspecs`` (a fresh ``init_cache`` is distributed at the
    first call), the tokens as P(dp, None) and the logits come back as
    P(dp, None, "model")."""
    cfg = model.cfg

    @torch.no_grad()
    def decode(cache, tokens):
        return model.decode_step(cache, tokens)

    if mesh is None:
        return StepBundle(fn=decode)
    if shape is None:
        raise ValueError("a mesh needs the shape its cache specs are sized by")
    rules = rules_for_mesh(mesh)
    place_model(model, mesh, rules)
    c_pspecs = cache_pspecs(cfg, shape, mesh, rules)
    dp = batch_pspecs(cfg, shape, mesh, rules)["tokens"][0]

    def step(cache, tokens):
        with _ctx(mesh, rules):
            return decode(cache, tokens)

    return StepBundle(fn=step, in_pspecs=(c_pspecs, P(dp, None)),
                      out_pspecs=(P(dp, None, "model"), c_pspecs), mesh=mesh)
