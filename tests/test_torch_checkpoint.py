"""The port's checkpoints (``repro_torch.checkpoint``): the JAX package's
layout and protocol (``step_<n>/arr_<i>.npy``, ``manifest.json``, ``COMMIT``
written last, a ``.tmp`` directory renamed into place), exact round trips,
pruning, and only committed steps restoring."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import AsyncCheckpointer, committed_steps, latest_step, restore
from repro_torch.optim import make_optimizer


def _state(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn((16, 4), generator=gen), "blocks.0.attn.wq": torch.randn((4, 4), generator=gen),
              "blocks.1.attn.wq": torch.randn((4, 4), generator=gen), "final_norm.scale": torch.randn(4, generator=gen)}
    opt = make_optimizer("adafactor")
    return {"params": params, "opt_state": opt.init(params)}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def test_round_trip_restores_exactly(tmp_path):
    state = _state(0)
    state["opt_state"]["count"].fill_(7)
    ck = AsyncCheckpointer(str(tmp_path), keep=3)
    ck.save(3, state, blocking=True)
    like = _state(1)
    got = restore(str(tmp_path), 3, like)
    for a, b, c in zip(_flat(got), _flat(state), _flat(like)):
        assert a.dtype == b.dtype == c.dtype and a.device == c.device and torch.equal(a, b)
    assert int(got["opt_state"]["count"]) == 7 and got["opt_state"]["count"].dtype == torch.int64
    d = tmp_path / "step_00000003"
    meta = json.loads((d / "manifest.json").read_text())
    assert meta["step"] == 3 and meta["n_leaves"] == len(_flat(state))
    assert meta["paths"][0] == "['opt_state']['count']"
    assert sorted(os.listdir(d)) == sorted([f"arr_{i}.npy" for i in range(meta["n_leaves"])]
                                           + ["manifest.json", "COMMIT"])


def test_snapshot_is_taken_at_save_time(tmp_path):
    """The next step may update the tensors in place while the thread writes."""
    state = _state(0)
    before = state["params"]["embed"].clone()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, state)
    state["params"]["embed"].add_(1.0)
    ck.wait()
    assert torch.equal(restore(str(tmp_path), 1, state)["params"]["embed"], before)


def test_an_uncommitted_step_is_ignored(tmp_path):
    state = _state(0)
    AsyncCheckpointer(str(tmp_path)).save(2, state, blocking=True)
    # a crash mid-save leaves a step without COMMIT, and a .tmp directory
    AsyncCheckpointer(str(tmp_path)).save(5, state, blocking=True)
    (tmp_path / "step_00000005" / "COMMIT").unlink()
    (tmp_path / "step_00000009.tmp").mkdir()
    assert committed_steps(str(tmp_path)) == [2]
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "missing")) is None


def test_keep_prunes_old_steps(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, _state(step))
    ck.wait()
    assert committed_steps(str(tmp_path)) == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert np.array_equal(restore(str(tmp_path), 4, _state(0))["params"]["embed"].numpy(),
                          _state(4)["params"]["embed"].numpy())


def test_restore_refuses_another_structure(tmp_path):
    state = _state(0)
    AsyncCheckpointer(str(tmp_path)).save(1, state, blocking=True)
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path), 1, {"params": state["params"]})


def test_a_failed_write_is_raised_on_the_next_wait(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros(2)}, blocking=True)
    (tmp_path / "step_00000002.tmp").write_text("a file where the writer wants a directory")
    ck.save(2, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    assert latest_step(str(tmp_path)) == 1
