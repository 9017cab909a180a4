"""The comparison that decides ``correct`` fails what it must, on the CPU at
small sizes: the control (the plain reference with fp8 products, one
precision below the configurations' bf16, in the program's place) reads
above a limit of its cell, and a run with a fault planted under its timed
path comes out not correct: a step that returns its state unchanged, half
of the batch left out (the loss the mean over the rest), a served token
altered where it is produced, a decode that leaves its state unchanged.
The card's readings at the cells' own sizes are in PERF.md."""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench.feed import Feed  # noqa: E402
from bench.testing import smoke_cell  # noqa: E402

TRAIN = ["olmo-1b.train_2k", "rwkv6-1.6b-variant.train_4k"]
SERVE = "rwkv6-1.6b-variant.serve_code"
# widths at which fp8's rounding shows as it does at the cells' sizes; the
# serving control over 8 requests of 16 served tokens, a widest gap needing
# some hundred positions to read as it does at the cell's some hundreds
CONTROL_ARCH = {"d_model": 256, "n_heads": 4, "n_kv_heads": 4, "d_ff": 512, "vocab": 1024, "rwkv_head_dim": 64,
                "n_layers": 4}
SERVE_ARCH = {"d_model": 512, "d_ff": 1024, "vocab": 4096, "rwkv_head_dim": 64, "n_layers": 4}
SERVE_TRAFFIC = {"requests": 4, "batches_per_cycle": 2, "prompt_median": 64, "prompt_sigma": 0.0,
                 "answer_median": 16, "answer_sigma": 0.0, "max_new_tokens": 16}


@pytest.mark.parametrize("name", TRAIN)
def test_control_fails_a_training_number(name):
    cell = smoke_cell(name, arch=CONTROL_ARCH)
    drv = harness.load_file(ROOT / "bench" / "traffic" / "train.py")
    feed = Feed(cell.seed, cell.arch["vocab"])
    want = drv.reference_readings(cell, cell.seed, feed)
    ctrl = drv.reference_readings(cell, cell.seed, feed, "fp8")
    checks = drv.compare(ctrl, want, cell)
    assert any(v > lim for v, lim in checks.values()), checks


def test_control_fails_the_serving_number():
    cell = smoke_cell(SERVE, arch=SERVE_ARCH, traffic=SERVE_TRAFFIC, workload={"checked_requests": 8})
    drv = harness.load_file(ROOT / "bench" / "traffic" / "serve.py")
    feed = Feed(cell.seed, cell.arch["vocab"])
    client = drv.Client(cell.traffic, feed)
    done = {}
    for b in range(2):
        ids, answers = client.batch(b)
        done[b] = (ids, answers, torch.zeros(len(answers), int(answers.max()), dtype=torch.long).numpy())
    picks = drv.sample(cell, cell.seed, {b: (ids.shape[1], a) for b, (ids, a, _) in done.items()})
    # the reference's own greedy tokens would read 0; the control's first picks read the gap
    gaps = drv.reference_gaps(cell, cell.seed, feed, picks, done, "fp8", control=True)
    assert max(gaps) > cell.workload["limits"]["logit_gap"], max(gaps)


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.optim import optimizers

    monkeypatch.setattr(optimizers, "adamw_update", lambda grads, state, params, lr, **kw: (params, state))
    line = harness.run_cell(smoke_cell(TRAIN[0]))
    assert line["correct"] is False and line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(monkeypatch, name):
    from repro_torch.models.registry import LM

    loss = LM.loss
    monkeypatch.setattr(LM, "loss", lambda self, b: loss(self, {k: v[:v.shape[0] // 2] for k, v in b.items()}))
    line = harness.run_cell(smoke_cell(name))
    assert line["correct"] is False, line["checks"]


def test_a_served_token_altered(monkeypatch):
    from repro_torch.serve.engine import ServeEngine

    decode = ServeEngine.decode

    def wrong(self, tok, cache, n_steps, *a, **kw):
        out = decode(self, tok, cache, n_steps, *a, **kw).clone()
        out[:, -1] = (out[:, -1] + 1) % self.model.cfg.vocab
        return out

    monkeypatch.setattr(ServeEngine, "decode", wrong)
    line = harness.run_cell(smoke_cell(SERVE))
    assert line["correct"] is False, line["checks"]


def test_a_decode_that_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.models.registry import LM

    step = LM.decode_step

    def frozen(self, cache, tokens):
        if tokens.shape[1] > 1:
            return step(self, cache, tokens)
        return step(self, copy.deepcopy(cache), tokens)[0], cache

    monkeypatch.setattr(LM, "decode_step", frozen)
    line = harness.run_cell(smoke_cell(SERVE))
    assert line["correct"] is False, line["checks"]
