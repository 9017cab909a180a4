"""The port's data pipeline (``repro_torch.data``) against ``repro.data``: the
same batches, ``==``, at every step, and their copy to a device."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokenDataset as JaxDataset
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticTokenDataset, to_device


@pytest.mark.parametrize("arch,seq,batch,seed", [("olmo-1b", 128, 4, 0), ("musicgen-large", 64, 3, 11),
                                                 ("llava-next-34b", 32, 2, 5)])
def test_batches_equal_the_jax_packages(arch, seq, batch, seed):
    cfg = get_arch(arch).smoke()
    kw = dict(seed=seed, n_frontend_tokens=cfg.n_frontend_tokens, frontend_dim=cfg.frontend_dim)
    port, ref = SyntheticTokenDataset(cfg.vocab, seq, batch, **kw), JaxDataset(cfg.vocab, seq, batch, **kw)
    for step in (0, 1, 7, 1000):
        a, b = port.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        assert ("frontend_embeds" in a) == (cfg.frontend != "none")
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


def test_batches_are_a_function_of_seed_and_step():
    ds = SyntheticTokenDataset(256, 32, 2, seed=3)
    assert np.array_equal(ds.batch(4)["tokens"], SyntheticTokenDataset(256, 32, 2, seed=3).batch(4)["tokens"])
    assert not np.array_equal(ds.batch(4)["tokens"], ds.batch(5)["tokens"])
    b = ds.batch(0)
    assert np.array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 256


def test_to_device_gives_int64_ids_and_keeps_embeddings():
    cfg = get_arch("musicgen-large").smoke()
    host = SyntheticTokenDataset(cfg.vocab, 16, 2, n_frontend_tokens=cfg.n_frontend_tokens,
                                 frontend_dim=cfg.frontend_dim).batch(0)
    dev = to_device(host, "cpu")
    assert dev["tokens"].dtype == dev["labels"].dtype == torch.int64
    assert dev["frontend_embeds"].dtype == torch.float32
    for k in host:
        assert np.array_equal(dev[k].numpy(), host[k])
