"""The port's packages export the JAX package's names, and the port's
``data.ShardedLoader`` hands out the reference loader's batches.

* Every public name of each ``repro`` package and subpackage that has a
  counterpart in the port is a name of the counterpart, except the names
  listed in ``RENAMED`` (the kernels' plain versions are ``*_plain`` where
  the JAX package's oracles are ``*_ref``) and ``JAX_ONLY`` (none: no
  exported name of these packages needs jax to mean something).
* ``ShardedLoader``'s first steps, on the CPU and on a (1, 1) mesh over a
  one-rank gloo group, equal the reference ``ShardedLoader``'s host batches
  and the port trainer's ``_batch`` for the same dataset and steps.
"""
from __future__ import annotations

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro
from repro.data import ShardedLoader as JaxShardedLoader
from repro.data import SyntheticTokenDataset as JaxDataset
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import ShardedLoader, SyntheticTokenDataset
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.sharding import batch_pspecs, rules_for_mesh

RENAMED = {
    "repro.kernels.attention": {"mha_ref": "mha_plain"},
    "repro.kernels.lbm_d3q15": {"lbm_step_ref": "lbm_step_plain"},
    "repro.kernels.stencil25": {"stencil25_ref": "stencil25_plain"},
    "repro.kernels.wkv": {"wkv_ref": "wkv_plain"},
}
JAX_ONLY: dict[str, set] = {}


def _public(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_") and not inspect.ismodule(v) and n != "annotations"}


PACKAGES = sorted(m.name for m in pkgutil.walk_packages(repro.__path__, "repro.") if m.ispkg)


@pytest.mark.parametrize("name", PACKAGES)
def test_port_packages_export_the_reference_names(name):
    ref = importlib.import_module(name)
    port = importlib.import_module(name.replace("repro.", "repro_torch.", 1))
    renamed = RENAMED.get(name, {})
    missing = sorted(n for n in _public(ref) - JAX_ONLY.get(name, set())
                     if not hasattr(port, renamed.get(n, n)))
    assert missing == []
    assert all(hasattr(port, n) for n in renamed.values())


def test_the_packages_the_port_was_missing_export_their_names():
    from repro_torch import configs, core, data, frontend, serve

    for mod, names in ((frontend, ("lower_gpu", "lower_tpu", "trace_pallas", "AccessIR", "ir_fingerprint")),
                       (core, ("get_machine", "estimate", "rank_configs", "build_report", "RooflineReport")),
                       (serve, ("ServeEngine",)), (configs, ("input_specs",)),
                       (data, ("ShardedLoader", "SyntheticTokenDataset"))):
        assert all(callable(getattr(mod, n)) for n in names)


def _datasets():
    kw = dict(vocab=256, seq_len=32, global_batch=4, seed=3, n_frontend_tokens=8, frontend_dim=16)
    return SyntheticTokenDataset(**kw), JaxDataset(**kw)


def _take(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.stop()


def _assert_batch(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        t = got[k].full_tensor() if hasattr(got[k], "full_tensor") else got[k]
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(v))
        assert t.dtype == (torch.int64 if np.asarray(v).dtype.kind in "iu" else torch.float32)


def test_sharded_loader_gives_the_reference_batches_on_the_cpu(tmp_path):
    ds, jds = _datasets()
    got = _take(ShardedLoader(ds, device="cpu", start_step=5, depth=3), 4)
    want = _take(JaxShardedLoader(jds, shardings={}, start_step=5, depth=3), 4)
    assert [s for s, _ in got] == [s for s, _ in want] == [5, 6, 7, 8]
    cfg = get_arch("musicgen-large").smoke()
    trainer = Trainer(build_model(cfg, device="cpu"), make_optimizer("adamw"), TrainerConfig(str(tmp_path)))
    for (step, batch), (_, ref) in zip(got, want):
        _assert_batch(batch, ref)
        _assert_batch(trainer._batch(ds, step, torch.device("cpu")), ref)


def test_sharded_loader_stops_its_thread():
    loader = ShardedLoader(_datasets()[0], device="cpu")
    next(loader)
    loader.stop()
    assert not loader._thread.is_alive()
    with pytest.raises(ValueError, match="specs"):
        ShardedLoader(_datasets()[0], mesh=object())


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_sharded_loader_places_the_reference_batches_on_a_mesh(one_rank_group, tmp_path):
    ds, jds = _datasets()
    cfg = get_arch("musicgen-large").smoke()
    mesh = make_test_mesh(1, 1, device="cpu")
    shape = ShapeConfig("loader", ds.seq_len, ds.global_batch, "train")
    specs = batch_pspecs(cfg, shape, mesh, rules_for_mesh(mesh))
    got = _take(ShardedLoader(ds, mesh=mesh, specs=specs), 2)
    want = _take(JaxShardedLoader(jds, shardings={}), 2)
    trainer = Trainer(build_model(cfg, device="cpu"), make_optimizer("adamw"), TrainerConfig(str(tmp_path)),
                      mesh=mesh, shape=shape)
    for (step, batch), (_, ref) in zip(got, want):
        assert all(hasattr(t, "placements") for t in batch.values())
        _assert_batch(batch, ref)
        _assert_batch(trainer._batch(ds, step, None), ref)
