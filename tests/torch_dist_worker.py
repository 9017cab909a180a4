"""One rank of ``tests/test_torch_dist.py``'s four-process gloo run.

    python tests/torch_dist_worker.py RANK WORLD STORE INPUTS OUT

The ranks meet through a ``FileStore`` at STORE (no TCP port, so parallel
test workers do not collide), each on one CPU thread.  INPUTS holds the
JAX package's parameter trees as ``.npz`` (written by the test, key
``a/b/c`` for ``tree["a"]["b"]["c"]``) and ``cases.json``; rank 0 writes
what the ranks computed into OUT, which the test compares with the JAX
package.  Imports torch and ``repro_torch`` only.

On a (data 2, model 2) mesh:
  * ``train``: ``Trainer.fit`` on OLMo-1B's smoke config, 2 steps, a
    checkpoint after each, a fault injected before step 1 (restored from
    the checkpoint at 1); the losses, gradient norms and final parameters;
  * ``restore``: that checkpoint restored onto a (4, 1) mesh by the
    placements given, every leaf compared to the bit with the (2, 2) state;
  * ``serve_<arch>``: ``make_prefill_step``'s logits, then the prompt through
    ``make_decode_step`` and greedy steps after it, the logits of each call
    and the tokens;
  * ``family_<arch>``: ``Trainer.fit`` through the mesh on one smoke config
    of each other family, its parameters drawn from seed 0: losses,
    gradient norms and final parameters;
  * ``kernel_args``: what the flash-attention and WKV entry points were
    handed in all of the above, a local shard or a DTensor, and its shape.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def tree(npz) -> dict:
    out: dict = {}
    for key in npz.files:
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = npz[key]
    return out


def whole(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu().numpy()


def model(arch: str, inputs: Path, cfgs):
    from repro_torch import convert
    from repro_torch.models import LM

    cfg = cfgs[arch]
    return LM(cfg, convert.lm_params(cfg, tree(np.load(inputs / f"{arch}.npz")), device="cpu"))


def main(rank: int, world: int, store: str, inputs: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.step import make_decode_step, make_prefill_step

    from torch.distributed.tensor import DTensor

    import repro_torch.models.layers as layers
    import repro_torch.models.rwkv6 as rwkv6

    seen = []

    def record(name, fn):
        def call(*args, **kw):
            seen.append((name, isinstance(args[0], DTensor), tuple(args[0].shape)))
            return fn(*args, **kw)
        return call

    layers.flash_attention = record("flash_attention", layers.flash_attention)
    rwkv6.wkv = record("wkv", rwkv6.wkv)

    cases = json.loads((inputs / "cases.json").read_text())
    cfgs = {a: get_arch(a).smoke() for a in cases["archs"]}
    results: dict[str, np.ndarray] = {}
    mesh = make_test_mesh(2, 2, device="cpu")

    # train: the JAX trainer's sharded test setup
    t = cases["train"]
    lm = model(t["arch"], inputs, cfgs)
    shape = ShapeConfig("tiny4", seq_len=t["seq"], global_batch=t["batch"], kind="train")
    faults = []

    def fault_hook(step):  # every rank fails before step 1 once: restored from the checkpoint at 1
        if step == 1 and not faults:
            faults.append(step)
            raise RuntimeError("injected fault")

    tr = Trainer(lm, make_optimizer("adamw"),
                 TrainerConfig(ckpt_dir=str(out / "ckpt"), ckpt_every=1, keep=1, peak_lr=t["lr"]),
                 fault_hook, mesh=mesh, shape=shape)
    state = tr.fit(SyntheticTokenDataset(lm.cfg.vocab, t["seq"], t["batch"], seed=t["seed"]), t["steps"])
    steps = [e for e in tr.log if e["event"] == "step"]
    results["train_restarts"] = np.array([e["step"] for e in tr.log if e["event"] == "restart"])
    results["train_loss"] = np.array([e["loss"] for e in steps])
    results["train_grad_norm"] = np.array([e["grad_norm"] for e in steps])
    flat = {f"params/{n}": whole(p) for n, p in state["params"].items()}
    flat.update({f"opt_state/{k}/{n}": whole(v) for k in ("m", "v") for n, v in state["opt_state"][k].items()})
    flat["opt_state/count"] = whole(state["opt_state"]["count"])
    results.update({f"train/{k}": v for k, v in flat.items()})

    # restore: the (2, 2) checkpoint onto a (4, 1) mesh, laid out by the
    # placements given (the structure from a one-device state)
    from repro_torch.models.params import param_pspecs
    from repro_torch.train.sharding import layer_specs, rules_for_mesh, to_placements
    from repro_torch.train.step import port_opt_pspecs

    mesh41 = make_test_mesh(4, 1, device="cpu")
    lm41 = model(t["arch"], inputs, cfgs)
    params41 = dict(lm41.named_parameters())
    like = {"params": params41, "opt_state": make_optimizer("adamw").init(params41)}
    p_specs = param_pspecs(lm41.blueprint(), rules_for_mesh(mesh41))
    specs = {"params": layer_specs(lm41.cfg, p_specs), "opt_state": port_opt_pspecs(make_optimizer("adamw"), lm41.cfg, p_specs)}

    def on41(tree, spec):
        if isinstance(tree, dict):
            return {k: on41(v, spec[k]) for k, v in tree.items()}
        return (mesh41, to_placements(mesh41, spec))

    back = restore(str(out / "ckpt"), t["steps"], like, on41(like, specs))
    same = [bool(np.array_equal(whole(back["params"][n]), flat[f"params/{n}"])) for n in back["params"]]
    same += [bool(np.array_equal(whole(back["opt_state"][k][n]), flat[f"opt_state/{k}/{n}"]))
             for k in ("m", "v") for n in back["opt_state"][k]]
    layouts = sorted({str(tuple(p.placements)) for p in back["params"].values()})
    results["restore_same"] = np.array(same)
    results["restore_mesh"] = np.array(list(back["params"]["embed"].device_mesh.shape))
    results["restore_layouts"] = np.array(layouts)
    results["restore_embed_local"] = np.array(back["params"]["embed"].to_local().shape)

    # serve: the prefill and decode bundles, then greedy steps
    s = cases["serve"]
    prompts = torch.from_numpy(np.array(s["prompts"], dtype=np.int64))
    for arch in cases["archs"]:
        lm = model(arch, inputs, cfgs)
        sshape = ShapeConfig("serve", seq_len=s["max_len"], global_batch=prompts.shape[0], kind="decode")
        prefill = make_prefill_step(lm, mesh, sshape)
        decode = make_decode_step(lm, mesh, sshape)
        results[f"serve_{arch}/prefill"] = whole(prefill({"tokens": prompts}))
        cache = lm.init_cache(prompts.shape[0], s["max_len"])
        logits, cache = decode(cache, prompts)
        results[f"serve_{arch}/decode_0"] = whole(logits)
        tok, toks = whole(logits)[:, -1].argmax(-1)[:, None], []
        for i in range(s["new_tokens"]):
            toks.append(tok)
            logits, cache = decode(cache, torch.from_numpy(tok))
            results[f"serve_{arch}/decode_{i + 1}"] = whole(logits)
            tok = whole(logits)[:, -1].argmax(-1)[:, None]
        results[f"serve_{arch}/tokens"] = np.concatenate(toks, axis=1)
        results[f"serve_{arch}/placements"] = np.array(sorted({str(tuple(p.placements)) for p in lm.parameters()}))

    # the other families: the trainer through the mesh from seed 0
    from repro_torch.models import build_model

    for arch, opt in cases["families"].items():
        cfg = get_arch(arch).smoke()
        tr = Trainer(build_model(cfg, device="cpu", seed=0), make_optimizer(opt),
                     TrainerConfig(ckpt_dir=str(out / f"ckpt_{arch}"), ckpt_every=10**6, peak_lr=t["lr"]),
                     mesh=mesh)
        tr.ckpt.save = lambda *a, **k: None
        ds = SyntheticTokenDataset(cfg.vocab, t["seq"], t["batch"], seed=t["seed"],
                                   n_frontend_tokens=cfg.n_frontend_tokens, frontend_dim=cfg.frontend_dim)
        state = tr.fit(ds, cases["family_steps"])
        steps = [e for e in tr.log if e["event"] == "step"]
        results[f"family_{arch}/loss"] = np.array([e["loss"] for e in steps])
        results[f"family_{arch}/grad_norm"] = np.array([e["grad_norm"] for e in steps])
        results.update({f"family_{arch}/params/{n}": whole(p) for n, p in state["params"].items()})

    results["kernel_args"] = np.array([f"{n} {'dtensor' if d else 'local'} {list(sh)}" for n, d, sh in seen])
    if rank == 0:
        np.savez(out / "results.npz", **results)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    rank, world, store, inputs, out = sys.argv[1:6]
    main(int(rank), int(world), store, Path(inputs), Path(out))
