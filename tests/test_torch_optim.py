"""The port's optimizers (``repro_torch.optim``) against ``repro.optim``.

The same parameters, gradients and state, made with numpy from a seed, go
through one update of each package.  The JAX trees hold stacked ``(L, ...)``
block leaves; the port gets each layer as its own tensor (``unstack``'s
names), so Adafactor's stacking of the layers and its per-parameter state
are held to the JAX leaf's.  Tolerance: f32, ``|a - b| <= 1e-6 + 1e-6 |b|``
(the two packages may contract a product and a sum into one rounding
differently and sum means in other orders).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt

TOL = dict(rtol=1e-6, atol=1e-6)
L = 3
# a JAX tree with stacked block leaves of every rank the models have
SHAPES = {
    "embed": (32, 8),
    "final_norm": {"scale": (8,)},
    "blocks": {"attn": {"wq": (L, 8, 12)}, "ln1": {"scale": (L, 8)},
               "moe": {"w_up": (L, 2, 8, 6)}, "gain": (L,)},
}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _flat(tree, prefix=""):
    """The port's names for a JAX tree: ``blocks.<l>.<path>`` per layer."""
    out = {}
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        elif name.startswith("blocks."):
            for layer in range(v.shape[0]):
                out[f"blocks.{layer}.{name[len('blocks.'):]}"] = torch.from_numpy(np.array(v[layer]))
        else:
            out[name] = torch.from_numpy(np.array(v))
    return out


def _close(port: dict, jax_tree):
    want = _flat(_np(jax_tree))
    assert set(port) == set(want)
    for n in want:
        np.testing.assert_allclose(port[n].numpy(), want[n].numpy(), err_msg=n, **TOL)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _case(seed):
    rng = np.random.default_rng(seed)
    params = _tree(rng, SHAPES)
    grads = _tree(rng, SHAPES, 0.3)
    return params, grads


def test_clip_by_global_norm_matches_jax():
    _, grads = _case(0)
    jg, jnorm = jopt.clip_by_global_norm(jax_tree(grads), 1.0)
    tg, tnorm = topt.clip_by_global_norm(_flat(grads), 1.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), **TOL)
    assert float(tnorm) > 1.0  # the case scales
    _close(tg, jg)
    # under the limit, nothing moves
    tg2, _ = topt.clip_by_global_norm(_flat(grads), 1e6)
    for n, t in _flat(grads).items():
        assert torch.equal(tg2[n], t)


@pytest.mark.parametrize("step", [0, 50, 99, 100, 5000, 10100, 15000, 20100, 40000])
def test_wsd_schedule_matches_jax(step):
    for s in (step, torch.tensor(step, dtype=torch.int64)):
        got = topt.wsd_schedule(s, peak_lr=3e-4)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jopt.wsd_schedule(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=0)


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_two_updates_match_jax(name):
    """Two updates from the initial state, the second with its own grads,
    parameters and state after each against the JAX package's."""
    params, grads = _case(1)
    grads2 = _tree(np.random.default_rng(2), SHAPES, 0.3)
    jo, to = jopt.make_optimizer(name), topt.make_optimizer(name)
    jp = jax_tree(params)
    jstate = jo.init(jp)
    tp = _flat(params)
    tstate = to.init(tp)
    for g, lr in ((grads, 1e-2), (grads2, 3e-3)):
        jp, jstate = jo.update(jax_tree(g), jstate, jp, jnp.float32(lr))
        to.update(_flat(g), tstate, tp, torch.tensor(lr, dtype=torch.float32))
        _close(tp, jp)
        assert int(tstate["count"]) == int(jstate["count"])
        assert tstate["count"].dtype == torch.int64
        if name == "adamw":
            _close(tstate["m"], jstate["m"])
            _close(tstate["v"], jstate["v"])
        else:
            _check_adafactor_state(tstate["v"], jstate["v"])


def _check_adafactor_state(port: dict, jax_state: dict):
    """The port's per-parameter moments restacked equal the JAX leaf's."""
    js = _np(jax_state)
    np.testing.assert_allclose(port["embed"]["vr"].numpy(), js["embed"]["vr"], **TOL)
    np.testing.assert_allclose(port["embed"]["vc"].numpy(), js["embed"]["vc"], **TOL)
    np.testing.assert_allclose(port["final_norm.scale"]["v"].numpy(), js["final_norm"]["scale"]["v"], **TOL)
    for path, leaf in (("attn.wq", js["blocks"]["attn"]["wq"]), ("moe.w_up", js["blocks"]["moe"]["w_up"])):
        for key in ("vr", "vc"):
            stacked = torch.stack([port[f"blocks.{i}.{path}"][key] for i in range(L)]).numpy()
            np.testing.assert_allclose(stacked, leaf[key], **TOL)
    # a stacked vector (L, d): vr one scalar a layer, vc the mean over the layers in every entry
    ln = js["blocks"]["ln1"]["scale"]
    np.testing.assert_allclose(torch.stack([port[f"blocks.{i}.ln1.scale"]["vr"] for i in range(L)]).numpy(),
                               ln["vr"], **TOL)
    for i in range(L):
        np.testing.assert_allclose(port[f"blocks.{i}.ln1.scale"]["vc"].numpy(), ln["vc"], **TOL)
    # a stacked scalar (L,): unfactored
    np.testing.assert_allclose(torch.stack([port[f"blocks.{i}.gain"]["v"] for i in range(L)]).numpy(),
                               js["blocks"]["gain"]["v"], **TOL)


def test_leaf_groups_stack_layers_in_order():
    names = ["embed", "blocks.10.attn.wq", "blocks.2.attn.wq", "blocks.0.attn.wq", "shared_attn.attn.wq",
             "blocks.0.ln1"]
    groups = topt.leaf_groups(names)
    assert (["blocks.0.attn.wq", "blocks.2.attn.wq", "blocks.10.attn.wq"], True) in groups
    assert (["embed"], False) in groups and (["shared_attn.attn.wq"], False) in groups
    assert (["blocks.0.ln1"], True) in groups


def test_make_optimizer_refuses_unknown_names():
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd")
