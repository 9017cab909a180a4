"""The port's training path (``repro_torch.models`` gradients, ``train``,
``launch.train``) against the JAX package, on the CPU.

Each case builds the JAX parameter tree from ``PRNGKey(0)`` on a ``smoke()``
config, carries it across with ``convert.lm_params``, and feeds both packages
the same batches of ``SyntheticTokenDataset`` (numpy, equal in both).  The
port's attention and WKV run their plain versions on the CPU, and autograd
goes through them.

Tolerance ``TOL``, as ``|a - b| <= atol + rtol |b|`` in f32, atol = rtol =
1e-4, the tolerance ``tests/test_torch_models.py`` holds the logits to: the
loss and every parameter's gradient against ``jax.value_and_grad`` of the
JAX ``LM.loss``, and the loss, its terms, the gradient norm and the rate of
each step of a 5-step trajectory against the JAX ``make_train_step`` (mesh
1 x 1).  The two packages sum in other orders; the smoke weights are large
(std 1/sqrt(2) for every stacked weight), so values differ by a few 1e-6 of
their size.

Some gradients are too ill-conditioned in f32 for ``TOL`` to decide them:
changing every parameter by one f32 ulp (a factor 1 +- 2^-23) moves the
embedding's gradient by up to 5.3 times ``TOL`` (the MoE config; 4.6 audio),
and the JAX package's own gradient computed op by op (``jax.disable_jit``)
and compiled reads up to 2.2 times ``TOL`` against itself (audio).  So each
gradient is held to ``TOL``, or, where that one-ulp change already moves it
by more than half of ``TOL``, to twice what the one-ulp change moves it
(:func:`ulp_reading`, measured on the port in the test).

Remat on and off give the same gradients to the bit: the recomputed
forward repeats the same CPU arithmetic.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data.pipeline import SyntheticTokenDataset as JaxDataset
from repro.launch.mesh import make_test_mesh
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticTokenDataset, to_device
from repro_torch.launch import train as launch_train
from repro_torch.models import LM
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainerConfig, make_train_step

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = {  # one smoke config of each family
    "dense": "olmo-1b",
    "moe": "dbrx-132b",
    "audio": "musicgen-large",
    "vlm": "llava-next-34b",
    "hybrid": "zamba2-7b",
    "ssm": "rwkv6-1.6b",
}
SEQ, BATCH = 32, 2


def _cfgs(arch: str, **changes):
    jcfg, cfg = jax_get_arch(arch).smoke(), get_arch(arch).smoke()
    return dataclasses.replace(jcfg, **changes), dataclasses.replace(cfg, **changes)


@functools.cache
def jax_pair(arch: str, **changes):
    """(JAX model, JAX params as numpy) on the smoke config."""
    jcfg, _ = _cfgs(arch, **changes)
    jm = jax_build_model(jcfg)
    return jm, jax.tree.map(np.asarray, jax_init_params(jm.blueprint(), jax.random.PRNGKey(0)))


def port_model(arch: str, **changes) -> LM:
    """A fresh port LM with the JAX parameters (each call its own copy)."""
    _, cfg = _cfgs(arch, **changes)
    return LM(cfg, convert.lm_params(cfg, jax_pair(arch)[1], device="cpu"))


def dataset(cfg, seq=SEQ, batch=BATCH, seed=7):
    return SyntheticTokenDataset(cfg.vocab, seq, batch, seed=seed, n_frontend_tokens=cfg.n_frontend_tokens,
                                 frontend_dim=cfg.frontend_dim)


def _grads(model: LM, batch) -> tuple[float, dict]:
    model.requires_grad_(True)
    loss, _ = model.loss(batch)
    names, params = zip(*model.named_parameters())
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(loss, params)))


def reading(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / (atol + rtol |b|) by ``TOL``: at most 1 where it holds."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (TOL["atol"] + TOL["rtol"] * b.abs())).max())


def ulp_reading(arch: str, batch, grads: dict) -> dict:
    """Per parameter, the ``TOL`` reading of how far the port's gradient
    moves when every parameter is multiplied by 1 +- 2^-23 (one f32 ulp,
    the sign drawn from seed 0): the gradient's own f32 conditioning."""
    model = port_model(arch)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 2.0**-23 * (2 * torch.randint(0, 2, p.shape, generator=gen) - 1))
    moved = _grads(model, batch)[1]
    return {n: reading(moved[n], grads[n]) for n in grads}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_match_jax(family):
    arch = FAMILIES[family]
    jm, params = jax_pair(arch)
    model = port_model(arch)
    host = dataset(model.cfg).batch(0)

    def loss_fn(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in host.items()})

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params))
    batch = to_device(host, "cpu")
    loss, grads = _grads(model, batch)
    np.testing.assert_allclose(loss, float(jloss), **TOL)
    want = convert.lm_params(model.cfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    assert set(grads) == set(want)
    ulp = ulp_reading(arch, batch, grads)
    for n, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == want[n].shape
        assert reading(g, want[n]) <= max(1.0, 2 * ulp[n]), (n, reading(g, want[n]), ulp[n])
    assert any(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "ssm"])
def test_remat_on_and_off_give_the_same_gradients(family):
    arch = FAMILIES[family]
    host = dataset(get_arch(arch).smoke()).batch(1)
    on = _grads(port_model(arch, remat=True), to_device(host, "cpu"))
    off = _grads(port_model(arch, remat=False), to_device(host, "cpu"))
    assert on[0] == off[0]
    for n in on[1]:
        assert torch.equal(on[1][n], off[1][n]), n


# (config, optimizer, microbatches): AdamW on the dense config, Adafactor on
# the MoE one as launch.train picks it, and the dense config accumulating 2
# microbatches as the JAX step's scan does
TRAJECTORIES = [("olmo-1b", "adamw", 0), ("dbrx-132b", "adafactor", 0), ("olmo-1b", "adamw", 2)]


@pytest.mark.parametrize("arch,opt,micro", TRAJECTORIES)
def test_five_step_trajectory_matches_jax(arch, opt, micro):
    jm, params = jax_pair(arch, microbatch=micro)
    model = port_model(arch, microbatch=micro)
    shape = JaxShapeConfig("tiny", seq_len=SEQ, global_batch=4, kind="train")
    mesh = make_test_mesh(1, 1)
    jopt = jax_make_optimizer(opt)
    step = jax_make_train_step(jm, jopt, mesh, shape, peak_lr=1e-3).jit(mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    optimizer = make_optimizer(opt)
    port_step = make_train_step(model, optimizer, peak_lr=1e-3)
    state = optimizer.init(dict(model.named_parameters()))
    jds, ds = JaxDataset(model.cfg.vocab, SEQ, 4, seed=5), dataset(model.cfg, batch=4, seed=5)
    for s in range(5):
        with mesh:
            jparams, jstate, jm_ = step(jparams, jstate, {k: jnp.asarray(v) for k, v in jds.batch(s).items()})
        m = port_step(state, to_device(ds.batch(s), "cpu"))
        for k in ("loss", "ce", "zloss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), err_msg=f"step {s} {k}", **TOL)
    assert int(state["count"]) == 5


# --------------------------------------------------------------------------- #
# The trainer: tests/test_trainer_integration.py's behaviours on the port
# --------------------------------------------------------------------------- #


def _trainer(tmp_path, fault_hook=None, ckpt_every=3):
    model = port_model("olmo-1b")
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=ckpt_every, peak_lr=1e-3)
    tr = Trainer(model, make_optimizer("adamw"), tcfg, fault_hook)
    return tr, dataset(model.cfg, seq=32, batch=4, seed=3)


def test_trainer_runs_and_checkpoints(tmp_path):
    tr, ds = _trainer(tmp_path)
    tr.fit(ds, n_steps=7)
    steps = [e for e in tr.log if e["event"] == "step"]
    assert len(steps) == 7
    assert latest_step(tr.tcfg.ckpt_dir) == 7
    assert np.isfinite(steps[-1]["loss"])


def test_trainer_fault_recovery(tmp_path):
    calls = {"n": 0}

    def fault_hook(step):
        if step == 5 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected node failure")

    tr, ds = _trainer(tmp_path, fault_hook)
    tr.fit(ds, n_steps=8)
    assert tr.restarts == 1
    assert "restart" in [e["event"] for e in tr.log]
    # resumed from the last checkpoint (step 3) and completed
    steps = [e for e in tr.log if e["event"] == "step"]
    assert steps[-1]["step"] == 7
    assert [e["step"] for e in steps].count(4) == 2  # step 4 re-ran after restore from ckpt@3
    # the re-run steps see the restored state: the same losses
    first, again = ([e["loss"] for e in steps if e["step"] == s] for s in (3, 4))
    assert first[0] == first[1] and again[0] == again[1]


def test_trainer_gives_up_after_max_retries(tmp_path):
    def always_fail(step):
        raise RuntimeError("persistent failure")

    tr, ds = _trainer(tmp_path, always_fail)
    tr.tcfg.max_retries = 2
    with pytest.raises(RuntimeError, match="giving up"):
        tr.fit(ds, n_steps=4)


def test_trainer_restarts_from_the_initial_state_before_any_checkpoint(tmp_path):
    calls = {"n": 0}

    def fault_hook(step):
        if step == 1 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected node failure")

    tr, ds = _trainer(tmp_path, fault_hook, ckpt_every=100)
    tr.fit(ds, n_steps=3)
    steps = [e for e in tr.log if e["event"] == "step"]
    assert [e["step"] for e in steps] == [0, 0, 1, 2]
    assert steps[0]["loss"] == steps[1]["loss"]


def test_launch_train_smoke_runs_on_the_cpu(tmp_path, capsys):
    tr = launch_train.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps", "2",
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "olmo-1b-smoke: 2 steps" in out
    assert tr.model.embed.device.type == "cpu" and latest_step(str(tmp_path / "ckpt")) == 2
