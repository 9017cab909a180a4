"""The port on a real (data 2, model 2) mesh: four gloo processes on the CPU.

``tests/torch_dist_worker.py`` runs each rank; the ranks meet through a
``FileStore`` in the test's temporary directory and run one thread each.
They take the JAX package's parameters (``PRNGKey(0)`` on the smoke
configs) carried across with ``convert.lm_params`` and:

* train OLMo-1B's smoke config 2 steps with ``Trainer.fit`` through the
  mesh (a fault injected before the second, restored from the first's
  checkpoint), held to the JAX trainer's sharded step on its four virtual devices
  (``tests/test_trainer_integration.py``'s setup: batch 4, sequence 32,
  data seed 5, peak rate 1e-3), losses and gradient norms, and its
  parameters afterwards to the port's own single-device ``Trainer``;
* run ``make_prefill_step`` and ``make_decode_step`` for OLMo-1B and RWKV6-1.6B
  (the prompt through the decode step, then greedy steps), held to the JAX
  package's bundles jitted on the same mesh: logits, and the greedy
  tokens equal;
* restore the (2, 2) run's checkpoint onto a (4, 1) mesh, and here onto
  one device: every leaf equal to the bit;
* train one smoke config of each other family (MoE with Adafactor, audio,
  hybrid, RWKV6) a step through the mesh from seed 0, held to the port's
  single-device ``Trainer`` from the same parameters;
* hand the flash-attention and WKV entry points local shards only, never
  a DTensor: batch over "data", heads over "model".

Tolerance ``TOL``, as in ``tests/test_torch_train.py``: |a - b| <= 1e-4 +
1e-4 |b|.  A rank that fails fails the test.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data.pipeline import SyntheticTokenDataset as JaxDataset
from repro.launch.mesh import make_test_mesh as jax_make_test_mesh
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro.train.step import make_decode_step as jax_make_decode_step
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch import convert
from repro_torch.checkpoint import restore
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticTokenDataset
from repro_torch.models import LM, build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
TOL = dict(rtol=1e-4, atol=1e-4)
WORLD = 4
ARCHS = ("olmo-1b", "rwkv6-1.6b")
CASES = {
    "archs": list(ARCHS),
    "train": {"arch": "olmo-1b", "seq": 32, "batch": 4, "seed": 5, "lr": 1e-3, "steps": 2},
    "serve": {"prompts": np.random.default_rng(0).integers(0, 256, size=(4, 16)).tolist(),
              "max_len": 32, "new_tokens": 4},
    "families": {"dbrx-132b": "adafactor", "musicgen-large": "adamw", "zamba2-7b": "adamw",
                 "rwkv6-1.6b": "adamw"},
    "family_steps": 1,
}
TIMEOUT_S = 300


def jax_params(arch: str):
    jm = jax_build_model(jax_get_arch(arch).smoke())
    return jm, jax.tree.map(np.asarray, jax_init_params(jm.blueprint(), jax.random.PRNGKey(0)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def start_ranks(inputs: Path, out: Path) -> list[subprocess.Popen]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = out / "store"
    return [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(store), str(inputs), str(out)],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]


def join_ranks(procs: list[subprocess.Popen]) -> None:
    """Waits for every rank; raises, with the first failing rank's
    errors, if any rank failed or ran past ``TIMEOUT_S``."""
    failed = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"rank {r} ran past {TIMEOUT_S} s")
        if p.returncode != 0:
            failed.append((r, p.returncode, err))
    if failed:
        for p in procs:
            if p.poll() is None:
                p.kill()
        r, code, err = failed[0]
        raise RuntimeError(f"rank {r} exited {code}:\n{err[-4000:]}")


def jax_train(jm, params, ckpt_dir: Path) -> dict:
    """The JAX trainer's sharded step, as ``Trainer.fit`` drives it: two
    steps' losses and gradient norms."""
    t = CASES["train"]
    mesh = jax_make_test_mesh(2, 2)
    shape = JaxShapeConfig("tiny4", seq_len=t["seq"], global_batch=t["batch"], kind="train")
    tr = JaxTrainer(jm, jax_make_optimizer("adamw"), mesh, shape,
                    JaxTrainerConfig(ckpt_dir=str(ckpt_dir), peak_lr=t["lr"]))
    from repro.train.sharding import batch_pspecs, to_shardings

    state = tr.init_state(jax.random.PRNGKey(0))
    assert all(np.array_equal(np.asarray(a), b) for a, b in
               zip(jax.tree.leaves(state["params"]), jax.tree.leaves(params)))
    ds = JaxDataset(jm.cfg.vocab, t["seq"], t["batch"], seed=t["seed"])
    b_sh = to_shardings(mesh, batch_pspecs(jm.cfg, shape, mesh, tr.rules))
    p, o, losses, norms = state["params"], state["opt_state"], [], []
    for step in range(t["steps"]):
        batch = {k: jax.device_put(v, b_sh[k]) for k, v in ds.batch(step).items()}
        with mesh:
            p, o, m = tr.step_fn(p, o, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": np.array(losses), "grad_norm": np.array(norms)}


def jax_serve(jm, params) -> dict:
    """The JAX prefill and decode bundles jitted on the (2, 2) mesh: the
    prefill's logits, the prompt through the decode step, greedy steps."""
    s = CASES["serve"]
    mesh = jax_make_test_mesh(2, 2)
    prompts = np.array(s["prompts"], dtype=np.int32)
    shape = JaxShapeConfig("serve", seq_len=s["max_len"], global_batch=prompts.shape[0], kind="decode")
    with mesh:  # the model's constraints need the mesh in context
        out = {"prefill": np.asarray(jax_make_prefill_step(jm, mesh, shape).jit(mesh)(params, {"tokens": prompts}))}
        decode = jax_make_decode_step(jm, mesh, shape).jit(mesh)
        logits, cache = decode(params, jm.init_cache(prompts.shape[0], s["max_len"]), prompts)
        out["decode_0"] = np.asarray(logits)
        tok, toks = np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32), []
        for i in range(s["new_tokens"]):
            toks.append(tok)
            logits, cache = decode(params, cache, tok)
            out[f"decode_{i + 1}"] = np.asarray(logits)
            tok = np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)
    out["tokens"] = np.concatenate(toks, axis=1)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' results, and the JAX package's, computed here while
    the ranks run."""
    inputs, out = tmp_path_factory.mktemp("inputs"), tmp_path_factory.mktemp("ranks")
    models = {a: jax_params(a) for a in ARCHS}
    for arch, (_, params) in models.items():
        np.savez(inputs / f"{arch}.npz", **_flat(params))
    (inputs / "cases.json").write_text(json.dumps(CASES))
    procs = start_ranks(inputs, out)
    try:
        ref = {"train": jax_train(*models["olmo-1b"], tmp_path_factory.mktemp("jax_ckpt"))}
        ref.update({f"serve_{a}": jax_serve(*models[a]) for a in ARCHS})
    finally:
        join_ranks(procs)
    got = dict(np.load(out / "results.npz"))
    return {"got": got, "ref": ref, "out": out, "params": {a: p for a, (_, p) in models.items()}}


def test_two_sharded_trainer_steps_match_the_jax_sharded_trainer(run):
    got, ref = run["got"], run["ref"]["train"]
    assert got["train_loss"].shape == (CASES["train"]["steps"],)
    assert list(got["train_restarts"]) == [1]  # the injected fault, restored from the checkpoint at 1
    np.testing.assert_allclose(got["train_loss"], ref["loss"], **TOL)
    np.testing.assert_allclose(got["train_grad_norm"], ref["grad_norm"], **TOL)


def _single_device(model: LM, opt: str, ckpt_dir: Path, steps: int) -> tuple[Trainer, dict]:
    """The port's single-device ``Trainer`` run ``steps`` steps as the
    ranks run theirs: (the trainer, its final state)."""
    t, cfg = CASES["train"], model.cfg
    tr = Trainer(model, make_optimizer(opt), TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=10**6, peak_lr=t["lr"]))
    tr.ckpt.save = lambda *a, **k: None
    ds = SyntheticTokenDataset(cfg.vocab, t["seq"], t["batch"], seed=t["seed"],
                               n_frontend_tokens=cfg.n_frontend_tokens, frontend_dim=cfg.frontend_dim)
    return tr, tr.fit(ds, steps)


def test_sharded_parameters_match_the_single_device_trainer(run, tmp_path):
    cfg = get_arch(CASES["train"]["arch"]).smoke()
    _, state = _single_device(LM(cfg, convert.lm_params(cfg, run["params"][CASES["train"]["arch"]], device="cpu")),
                              "adamw", tmp_path, CASES["train"]["steps"])
    got = run["got"]
    for n, p in state["params"].items():
        np.testing.assert_allclose(got[f"train/params/{n}"], p.detach().numpy(), err_msg=n, **TOL)
    for k in ("m", "v"):
        for n, t in state["opt_state"][k].items():
            np.testing.assert_allclose(got[f"train/opt_state/{k}/{n}"], t.numpy(), err_msg=f"{k} {n}", **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_bundles_match_jax(run, arch):
    got, ref = run["got"], run["ref"][f"serve_{arch}"]
    for key in ["prefill"] + [f"decode_{i}" for i in range(CASES["serve"]["new_tokens"] + 1)]:
        np.testing.assert_allclose(got[f"serve_{arch}/{key}"], ref[key], err_msg=key, **TOL)
    np.testing.assert_array_equal(got[f"serve_{arch}/tokens"], ref["tokens"])
    # the parameters really were split: some over both axes
    assert "(Shard(dim=0), Shard(dim=1))" in set(got[f"serve_{arch}/placements"])


@pytest.mark.parametrize("arch", sorted(CASES["families"]))
def test_every_family_trains_through_the_mesh_as_on_one_device(run, arch, tmp_path):
    got = run["got"]
    tr, state = _single_device(build_model(get_arch(arch).smoke(), device="cpu", seed=0), CASES["families"][arch],
                               tmp_path, CASES["family_steps"])
    steps = [e for e in tr.log if e["event"] == "step"]
    np.testing.assert_allclose(got[f"family_{arch}/loss"], [e["loss"] for e in steps], **TOL)
    np.testing.assert_allclose(got[f"family_{arch}/grad_norm"], [e["grad_norm"] for e in steps], **TOL)
    for n, p in state["params"].items():
        np.testing.assert_allclose(got[f"family_{arch}/params/{n}"], p.detach().numpy(), err_msg=n, **TOL)


def test_kernels_are_handed_local_shards(run):
    """Every call of the flash-attention and WKV entry points, in training,
    prefill and decode, got a plain local tensor: OLMo's (B, H, S, hd)
    = (4, 4, 32, 16) smoke attention as (2, 2, 32, 16) on each device, the
    WKV's (B H, S, K) rows likewise a quarter."""
    calls = [c.split(" ", 2) for c in run["got"]["kernel_args"]]
    assert {kind for _, kind, _ in calls} == {"local"}
    shapes = {(name, shape) for name, _, shape in calls}
    assert ("flash_attention", "[2, 2, 32, 16]") in shapes
    assert ("wkv", "[4, 16, 16]") in shapes  # RWKV6 smoke: B 4, H 4 -> 2 x 2 rows, S 16 of K 16
    assert {name for name, _, _ in calls} == {"flash_attention", "wkv"}


def test_checkpoint_from_two_by_two_restores_on_four_by_one_and_on_one_device(run):
    got = run["got"]
    assert got["restore_same"].all() and got["restore_same"].size > 0
    assert list(got["restore_mesh"]) == [4, 1]
    # embed (256, 64) is P("model", "data"): on (4, 1) its 64 columns split four ways
    assert list(got["restore_embed_local"]) == [256, 16]
    t = CASES["train"]
    cfg = get_arch(t["arch"]).smoke()
    model = LM(cfg, convert.lm_params(cfg, run["params"][t["arch"]], device="cpu"))
    params = dict(model.named_parameters())
    like = {"params": params, "opt_state": make_optimizer("adamw").init(params)}
    back = restore(str(run["out"] / "ckpt"), t["steps"], like)
    for n, p in back["params"].items():
        assert not hasattr(p, "placements")
        np.testing.assert_array_equal(p.numpy(), got[f"train/params/{n}"], err_msg=n)
    for k in ("m", "v"):
        for n, v in back["opt_state"][k].items():
            np.testing.assert_array_equal(v.numpy(), got[f"train/opt_state/{k}/{n}"], err_msg=n)
    assert int(back["opt_state"]["count"]) == t["steps"]


def test_a_rank_that_fails_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 0 exited"):
        join_ranks(start_ranks(tmp_path / "missing", tmp_path))
