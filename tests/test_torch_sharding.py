"""The port's placements, as data, against the JAX package's sharding trees.

No process group is needed for the specs: both packages' functions take a
stand-in mesh, a name -> size mapping (the JAX functions read only
``.shape`` and ``.axis_names``; the port's read anything ``mesh_spec``
does).  Every spec the port builds is held ``==`` to the JAX package's,
entry by entry (the port's ``PartitionSpec`` is a tuple):

* ``param_pspecs`` of all ten configs' blueprints under ``SINGLE_POD_RULES``,
  ``MULTI_POD_RULES`` and the ``ep="model"`` variant;
* ``opt_state_pspecs`` for AdamW and Adafactor;
* ``batch_pspecs`` and ``cache_pspecs`` for every applicable (arch x shape)
  of ``SHAPES`` on (16, 16) and (2, 16, 16), the port's cache classes in
  place of the JAX dict keys;
* ``constrain``'s entries (``shardctx.logical_spec``) against the specs the
  JAX ``constrain`` hands ``with_sharding_constraint``.

The per-device shapes of ``to_placements`` come from DTensors on the fake
process group (world 256 and 512, meta tensors: nothing is allocated) and
are held to jax's ``NamedSharding(...).shard_shape`` of the same spec.
``make_production_mesh`` is built on that group too.
"""
from __future__ import annotations

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import repro.models.shardctx as jax_shardctx
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro.models.params import MULTI_POD_RULES as JAX_MULTI
from repro.models.params import SINGLE_POD_RULES as JAX_SINGLE
from repro.models.params import ShardingRules as JaxRules
from repro.models.params import param_pspecs as jax_param_pspecs
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro.train import sharding as jax_sharding
from repro.train.step import opt_state_pspecs as jax_opt_state_pspecs
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core.machine import MeshSpec
from repro_torch.graph.frontend import rules_for_spec
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh, mesh_spec
from repro_torch.models import build_model
from repro_torch.models.params import MULTI_POD_RULES, SINGLE_POD_RULES, P, ShardingRules, param_pspecs, param_structs
from repro_torch.models.registry import HybridCache, KVCache, RWKVState, blueprint
from repro_torch.models.shardctx import constrain, kernel_placements, logical_spec, sharding_ctx
from repro_torch.optim import make_optimizer
from repro_torch.train import sharding
from repro_torch.train.step import opt_state_pspecs, port_opt_pspecs

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
RULES = {  # (port, JAX)
    "single": (SINGLE_POD_RULES, JAX_SINGLE),
    "multi": (MULTI_POD_RULES, JAX_MULTI),
    "ep": (ShardingRules(ep="model"), JaxRules(ep="model")),
}


def jax_mesh(name: str):
    """The stand-in the JAX sharding functions read: ``.shape`` and ``.axis_names``."""
    sizes = MESHES[name]
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def as_tuples(tree):
    """A JAX tree of ``PartitionSpec`` (nested dicts, tuples) with every spec a tuple."""
    if isinstance(tree, JP):
        return tuple(tuple(e) if isinstance(e, list) else e for e in tree)
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(as_tuples(v) for v in tree)
    return tree


def jax_blueprint(arch: str):
    return jax_build_model(jax_get_arch(arch)).blueprint()


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# --------------------------------------------------------------------------- #
# PartitionSpec, translate, the blueprint's specs
# --------------------------------------------------------------------------- #


def test_partition_spec_is_a_tuple_equal_to_jax_p():
    spec = P("data", ("pod", "data"), None)
    assert spec == tuple(JP("data", ("pod", "data"), None)) and isinstance(spec, tuple)
    assert pickle.loads(pickle.dumps(spec)) == spec and type(pickle.loads(pickle.dumps(spec))) is P
    assert spec[:-1] == P("data", ("pod", "data")) and isinstance(spec[:-1], P)
    assert P() == () and repr(P("model")) == "P('model',)"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("rules", sorted(RULES))
def test_param_pspecs_equal_jax(arch, rules):
    port_rules, jax_rules = RULES[rules]
    got = param_pspecs(blueprint(get_arch(arch)), port_rules)
    want = as_tuples(jax_param_pspecs(jax_blueprint(arch), jax_rules))
    assert flat(got) == flat(want)
    assert all(type(s) is P for s in flat(got).values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_structs_are_meta_tensors_of_the_blueprint(arch):
    bp = blueprint(get_arch(arch))
    structs = flat(param_structs(bp, torch.bfloat16))
    assert {k: tuple(t.shape) for k, t in structs.items()} == {k: d.shape for k, d in flat(bp).items()}
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in structs.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("rules", ["single", "multi"])
def test_opt_state_pspecs_equal_jax(arch, opt, rules):
    port_rules, jax_rules = RULES[rules]
    got = opt_state_pspecs(make_optimizer(opt), param_pspecs(blueprint(get_arch(arch)), port_rules))
    want = jax_opt_state_pspecs(jax_make_optimizer(opt), jax_param_pspecs(jax_blueprint(arch), jax_rules))
    assert flat(got) == flat(as_tuples(want))


def _state_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_state_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b", "dbrx-132b", "zamba2-7b"])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_port_opt_pspecs_lay_out_the_port_state(arch, opt):
    """The specs by parameter name cover the port's own optimizer state,
    one entry a dim of each tensor."""
    cfg = get_arch(arch).smoke()
    params = dict(build_model(cfg, device="cpu").named_parameters())
    state = _state_shapes(make_optimizer(opt).init(params))
    specs = flat(port_opt_pspecs(make_optimizer(opt), cfg, param_pspecs(blueprint(cfg), SINGLE_POD_RULES)))
    assert set(specs) == set(state)
    assert {k: len(s) for k, s in specs.items()} == {k: len(s) for k, s in state.items()}


# --------------------------------------------------------------------------- #
# batches, caches, rules
# --------------------------------------------------------------------------- #

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES if shape_applicable(get_arch(a), SHAPES[s])[0]]


def cache_as_dict(cache):
    if isinstance(cache, HybridCache):
        return ({"h": cache.h, "conv": cache.conv}, cache_as_dict(cache.attn))
    if isinstance(cache, KVCache):
        return {"k": cache.k, "v": cache.v}
    assert isinstance(cache, RWKVState)
    return {"shift_tm": cache.shift_tm, "shift_cm": cache.shift_cm, "s": cache.s}


def drop_len(tree):
    if isinstance(tree, tuple):
        return tuple(drop_len(t) for t in tree)
    return {k: v for k, v in tree.items() if k != "len"}


@pytest.mark.parametrize("arch,shape", CELLS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_pspecs_equal_jax(arch, shape, mesh):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    jm = jax_mesh(mesh)
    rules, jrules = sharding.rules_for_mesh(MESHES[mesh]), jax_sharding.rules_for_mesh(jm)
    assert rules == ShardingRules(**{f: getattr(jrules, f) for f in ("fsdp", "tp", "dp", "sp", "ep")})
    got = sharding.batch_pspecs(cfg, SHAPES[shape], MESHES[mesh], rules)
    assert got == as_tuples(jax_sharding.batch_pspecs(jcfg, JAX_SHAPES[shape], jm, jrules))
    want = as_tuples(jax_sharding.cache_pspecs(jcfg, JAX_SHAPES[shape], jm, jrules))
    assert cache_as_dict(sharding.cache_pspecs(cfg, SHAPES[shape], MESHES[mesh], rules)) == drop_len(want)


@pytest.mark.parametrize("spelling", [{"data": 16, "model": 16}, "pod=2,data=16,model=16",
                                      MeshSpec(axes=(("data", 2), ("model", 2))), None])
def test_rules_for_mesh_agree_with_the_graph_frontends(spelling):
    assert sharding.rules_for_mesh(spelling) == rules_for_spec(mesh_spec(spelling))


# --------------------------------------------------------------------------- #
# constrain
# --------------------------------------------------------------------------- #

CONSTRAINTS = [((8, 4096, 5120), ("dp", None, None)), ((1, 4096, 5120), ("dp", None, None)),
               ((8, 4096, 40, 128), ("dp", None, "tp", None)), ((8, 4096, 8, 128), ("dp", None, "tp", None)),
               ((8, 512, 13824), ("dp", None, "tp")), ((32, 16, 40, 6144), ("dp", "ep", None, None)),
               ((8, 16, 3), (None, None, None))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", ["plain", "ep"])
def test_constrain_entries_equal_jax(monkeypatch, mesh, rules):
    """The spec the port's ``constrain`` lays a DTensor out by is the one
    the JAX ``constrain`` hands ``with_sharding_constraint``."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: seen.append(s) or x)
    port_rules = sharding.rules_for_mesh(MESHES[mesh])
    jrules = jax_sharding.rules_for_mesh(jax_mesh(mesh))
    if rules == "ep":
        port_rules, jrules = (ShardingRules(**{**vars(port_rules), "ep": "model"}),
                              JaxRules(**{**vars(jrules), "ep": "model"}))
    for shape, logical in CONSTRAINTS:
        seen.clear()
        with jax_shardctx.sharding_ctx(jrules, MESHES[mesh]):
            jax_shardctx.constrain(jnp.zeros(shape, jnp.int8), logical)
        got = logical_spec(shape, logical, port_rules, MESHES[mesh])
        assert (got if any(e is not None for e in got) else None) == (as_tuples(seen[0]) if seen else None)


def test_constrain_leaves_plain_tensors_and_calls_outside_the_context_alone():
    x = torch.randn(4, 8, 2)
    assert constrain(x, ("dp", None, None)) is x
    with sharding_ctx(SINGLE_POD_RULES, {"data": 2, "model": 2}):
        assert constrain(x, ("dp", None, None)) is x


# --------------------------------------------------------------------------- #
# placements on a DeviceMesh (the fake process group)
# --------------------------------------------------------------------------- #


@pytest.fixture
def fake_group():
    """A fake process group of the given world size; destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_on_the_fake_group(fake_group, multi):
    fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi else ("data", "model"))
    assert tuple(mesh.shape) == ((2, 16, 16) if multi else (16, 16))
    assert mesh_spec(mesh) == mesh_spec(MESHES["multi" if multi else "single"])


def test_meshes_refuse_a_world_too_small(fake_group):
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh(2, 2, device="cpu")
    fake_group(256)
    with pytest.raises(RuntimeError, match=r"needs 512 devices but the process group has only 256"):
        make_production_mesh(multi_pod=True, device="cpu")
    assert tuple(make_test_mesh(4, 2, device="cpu").shape) == (4, 2)


def test_to_placements_order_and_uniqueness():
    from torch.distributed.tensor import Replicate, Shard

    assert sharding.to_placements(MESHES["multi"], P(("pod", "data"), "model")) == [Shard(0), Shard(0), Shard(1)]
    assert sharding.to_placements(MESHES["single"], P(None, None)) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(MESHES["multi"], P(("data", "pod")))
    with pytest.raises(ValueError, match="two dims"):
        sharding.to_placements(MESHES["single"], P("data", "data"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_per_device_shapes_equal_jax_shard_shapes(fake_group, mesh):
    """Every parameter leaf of the ten configs and every batch and cache
    tensor of their applicable shapes: the first device's shard of a meta
    DTensor laid out by ``to_placements`` has jax's shard shape."""
    from torch.distributed.tensor import distribute_tensor

    sizes = MESHES[mesh]
    fake_group(int(np.prod(list(sizes.values()))))
    dmesh = make_production_mesh(multi_pod=mesh == "multi", device="cpu")
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    cases = []
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        rules = sharding.rules_for_mesh(sizes)
        bp = blueprint(cfg)
        specs = flat(param_pspecs(bp, rules))
        cases += [(d.shape, specs[k]) for k, d in flat(bp).items()]
        for s in SHAPES.values():
            if not shape_applicable(cfg, s)[0]:
                continue
            cases += [((s.global_batch, s.seq_len), spec) for spec in sharding.batch_pspecs(cfg, s, sizes, rules).values()]
            cases += _cache_cases(cfg, s, sharding.cache_pspecs(cfg, s, sizes, rules))
    checked = 0
    for shape, spec in cases:
        try:
            want = NamedSharding(amesh, JP(*spec)).shard_shape(tuple(shape))
        except ValueError:  # jax refuses an uneven split; the rules never make one
            raise AssertionError(f"{shape} {spec}: not an even split")
        t = distribute_tensor(torch.empty(shape, device="meta"), dmesh, sharding.to_placements(dmesh, spec))
        assert tuple(t.to_local().shape) == tuple(want), (shape, spec)
        checked += 1
    assert checked > 250  # 299 tensors on either mesh


def _cache_cases(cfg, shape, cache) -> list:
    """(global shape, spec) of every tensor of ``init_cache`` at ``shape``."""
    B, T, L = shape.global_batch, shape.seq_len, cfg.n_layers
    if isinstance(cache, RWKVState):
        d, K = cfg.d_model, cfg.rwkv_head_dim
        return [((L, B, 1, d), cache.shift_tm), ((L, B, 1, d), cache.shift_cm), ((L, B, d // K, K, K), cache.s)]
    n_attn = L // cfg.shared_attn_period if isinstance(cache, HybridCache) else L
    kv = cache.attn if isinstance(cache, HybridCache) else cache
    out = [((n_attn, B, T, cfg.n_kv_heads, cfg.hd), kv.k), ((n_attn, B, T, cfg.n_kv_heads, cfg.hd), kv.v)]
    if isinstance(cache, HybridCache):
        d_in, N = 2 * cfg.d_model, cfg.ssm_state
        out += [((L, B, d_in // cfg.ssm_head_dim, N, cfg.ssm_head_dim), cache.h), ((L, B, 3, d_in + 2 * N), cache.conv)]
    return out


@pytest.mark.parametrize("heads,want", [((40, 8), "replicated"), ((16, 16), "split"), ((32,), "split")])
def test_kernel_placements_keep_query_groups_whole(heads, want):
    """Attention's local call splits heads over tp only where every head
    count divides: Qwen2.5-14B's 40/8 heads on a 16-wide axis stay whole."""
    from torch.distributed.tensor import Replicate, Shard

    pl = kernel_placements(MESHES["single"], 4, (0, 256), heads, 2)
    assert pl[0] == Shard(0)
    assert pl[1] == (Replicate() if want == "replicated" else Shard(2))
