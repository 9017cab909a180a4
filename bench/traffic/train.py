"""Training traffic: the program's train step (``train.step.make_train_step``
with AdamW and remat, the model ``models.registry.LM``) driven back to back
on batches of ids from the seed.

Set-up draws the weights, builds the step bundle and its optimizer state,
and drives them through the cell's ``checked_steps`` first steps, which warm
up every shape and build every kernel; each step's loss, each leaf's norm
of the first gradient as the optimizer got it (its first moment after one
step over 1 - b1) and each leaf's norm of the change after the last are
kept.  The window then dispatches steps on the same bundle, one step queued
behind the one running, until ``--seconds`` have passed, and waits for the
last: ``train_tokens_per_s`` is every token of every step over the whole
window.  A traced run then profiles ``trace_steps`` more steps.

Once the window has closed and the program's state is freed, the plain
reference draws the same weights, takes the same first steps on the same
batches, and the three numbers are compared leaf by leaf.
"""
from __future__ import annotations

import time

import torch

from bench import flops, harness, profiling
from bench.feed import TRAIN, Feed
from bench.reference.common import exact_matmul, train_readings
from bench.weights import draw

# rows of a batch that the reference takes at once, its gradient summed over
# the blocks: a step at the cell's batch then fits on the card in float32
REFERENCE_ROWS = 4

def worst_leaves(got: dict, want: dict) -> dict:
    """The leaf that sets each by-leaf number (for the calibration's notes)."""
    g = want["grad_norms"]
    median = sorted(g.values())[len(g) // 2]
    moved = [n for n in g if g[n] >= 1e-3 * median]
    return {"grad_norm_gap": harness.worst_leaf(got["grad_norms"], g),
            "change_norm_gap": harness.worst_leaf(got["change_norms"], want["change_norms"], moved)}


def batches(feed: Feed, mix: dict, first: int, count: int, device):
    """``count`` (tokens, labels) batches from batch ``first`` on."""
    out = []
    for i in range(first, first + count):
        ids = torch.from_numpy(feed.ids(TRAIN, i, mix["batch"], mix["seq_len"] + 1))
        if device.type == "cuda":
            ids = ids.pin_memory().to(device, non_blocking=True)
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def build(cell, seed: int):
    """The program's step bundle, optimizer state and parameters for
    ``seed``: the weights drawn as the reference draws them."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.registry import LM
    from repro_torch.optim import make_optimizer
    from repro_torch.train.step import make_train_step

    opt = cell.traffic["optimizer"]
    ref = cell.reference
    model = LM(ArchConfig(**cell.arch), draw(ref, ref.param_table(cell.arch), seed, cell.device))
    adamw = make_optimizer("adamw", b1=opt["b1"], b2=opt["b2"], eps=opt["eps"], weight_decay=opt["weight_decay"])
    step = make_train_step(model, adamw, peak_lr=opt["peak_lr"], grad_clip=opt["grad_clip"])
    params = dict(model.named_parameters())
    return step, adamw.init(params), params


def first_steps(cell, seed: int, step, state, params, feed: Feed) -> dict:
    """The checked first steps of the program: losses, first-gradient and
    change norms by leaf (host floats)."""
    mix = cell.traffic
    b1 = mix["optimizer"]["b1"]
    losses, grad_norms = [], None
    for tokens, labels in batches(feed, mix, 0, cell.workload["checked_steps"], cell.device):
        metrics = step(state, {"tokens": tokens, "labels": labels})
        losses.append(metrics["loss"])
        if grad_norms is None:
            grad_norms = torch.stack([state["m"][n].norm() / (1 - b1) for n in params])
    ref = cell.reference
    p0 = draw(ref, ref.param_table(cell.arch), seed, cell.device)
    change = torch.stack([(params[n].detach() - p0[n]).norm() for n in params])
    del p0
    names = list(params)
    return {"losses": [float(x) for x in losses],
            "grad_norms": dict(zip(names, grad_norms.tolist())),
            "change_norms": dict(zip(names, change.tolist()))}


def reference_readings(cell, seed: int, feed: Feed, prec: str = "f32") -> dict:
    """The plain reference's first steps from the same weights and batches."""
    exact_matmul()
    ref = cell.reference
    W = draw(ref, ref.param_table(cell.arch), seed, cell.device)
    model = ref.Model(cell.arch)
    mix = cell.traffic
    opt = dict(mix["optimizer"], z_loss=mix["z_loss"])
    return train_readings(model, W, batches(feed, mix, 0, cell.workload["checked_steps"], cell.device), opt, prec,
                          rows=REFERENCE_ROWS)


def compare(got: dict, want: dict, cell) -> dict:
    """The compared numbers, each with its limit from the cell's file:
    the worst step's loss gap (nats), and by the worst leaf the gap between
    first-gradient norms and between change norms (the latter over leaves
    whose reference gradient is at least a thousandth of the median
    leaf's)."""
    limits = cell.workload["limits"]
    g = want["grad_norms"]
    median = sorted(g.values())[len(g) // 2]
    moved = [n for n in g if g[n] >= 1e-3 * median]
    return {
        "loss_gap": (max(abs(a - b) for a, b in zip(got["losses"], want["losses"])), limits["loss_gap"]),
        "grad_norm_gap": (harness.gap_by_leaf(got["grad_norms"], g), limits["grad_norm_gap"]),
        "change_norm_gap": (harness.gap_by_leaf(got["change_norms"], want["change_norms"], moved),
                            limits["change_norm_gap"]),
    }


def run(cell) -> harness.Outcome:
    mix, dev = cell.traffic, cell.device
    clock = harness.Clock(dev)
    feed = Feed(cell.seed, cell.arch["vocab"])
    step, state, params = build(cell, cell.seed)
    got = first_steps(cell, cell.seed, step, state, params, feed)
    clock.sync()
    setup_s = time.perf_counter() - cell.t_start
    harness.log(cell, f"set-up done: {cell.workload['checked_steps']} checked steps")

    tokens_per_step = mix["batch"] * mix["seq_len"]
    index, losses = cell.workload["checked_steps"], []
    t0 = time.perf_counter()
    prev = None
    while True:
        (tokens, labels), = batches(feed, mix, index, 1, dev)
        losses.append(step(state, {"tokens": tokens, "labels": labels})["loss"])
        index += 1
        done = clock.mark()
        if prev is not None:
            clock.wait(prev)  # at most one step queued behind the one running
        prev = done
        if time.perf_counter() - t0 >= cell.seconds:
            break
    clock.sync()
    window_s = time.perf_counter() - t0
    steps = len(losses)
    failed = sum(1 for x in torch.stack(losses).tolist() if not harness.finite(x))
    peak = harness.memory_peak(dev)
    harness.log(cell, f"window done: {steps} steps in {window_s:.3f} s")

    context, summary = {}, None
    if cell.trace:
        n = mix["trace_steps"]

        def traced_steps():
            for tokens, labels in batches(feed, mix, index, n, dev):
                step(state, {"tokens": tokens, "labels": labels})

        summary = profiling.traced(traced_steps, dev)
        context = {"arch": cell.arch, "mix": mix, "kind": "train", "steps": n, "summary": summary,
                   "window_s": window_s, "window_steps": steps,
                   "step_flops": flops.train_step_flops(cell.arch, mix["batch"], mix["seq_len"])}
        harness.log(cell, f"traced {n} steps")
    del step, state, params
    harness.free_device(dev)
    want = reference_readings(cell, cell.seed, feed)
    harness.log(cell, "reference done")
    return harness.Outcome(
        end_to_end={"train_tokens_per_s": steps * tokens_per_step / window_s, "setup_s": setup_s},
        attempted=steps, failed=failed, checks=compare(got, want, cell), memory_peak_bytes=peak,
        context=context, summary=summary)
