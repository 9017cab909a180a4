"""Training launcher CLI.

Counterpart of ``repro.launch.train``, with its flags and ``--device``
(default ``cuda``), as ``launch.serve`` has it:

  python -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu
  python -m repro_torch.launch.train --arch olmo-1b --steps 6
  python -m repro_torch.launch.train --arch rwkv6-1.6b --steps 4

``--smoke`` trains the config's ``smoke()`` reduction at sequence 128 and
batch 4; otherwise the config at full width on ``--shape`` with its global
batch cut to what one card holds (``launch.one_card``).  Parameters are
drawn on the device from seed 0 (``build_model``), the data from seed 0
(``SyntheticTokenDataset``).  AdamW, or Adafactor for the MoE configs, as
the JAX launcher picks.  It prints the JAX launcher's summary line and one
JSON line with every step's loss and seconds.
"""
from __future__ import annotations

import argparse
import json

from ..configs import get_arch
from ..configs.base import SHAPES, ShapeConfig
from ..data.pipeline import SyntheticTokenDataset
from ..device import resolve_device
from ..models.registry import build_model
from ..optim.optimizers import make_optimizer
from ..train.trainer import Trainer, TrainerConfig
from .one_card import one_card_train_shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=[k for k, v in SHAPES.items() if v.is_train])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="reduced config, sequence 128, batch 4")
    ap.add_argument("--ckpt-dir", default="results/train_run")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        shape, reduced = ShapeConfig("smoke", seq_len=128, global_batch=4, kind="train"), {}
    else:
        shape, reduced = one_card_train_shape(SHAPES[args.shape])
    model = build_model(cfg, device=dev, seed=0)
    opt = make_optimizer("adafactor" if cfg.moe is not None else "adamw")
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50, peak_lr=args.lr)
    trainer = Trainer(model, opt, tcfg)
    ds = SyntheticTokenDataset(
        cfg.vocab,
        shape.seq_len,
        shape.global_batch,
        seed=0,
        n_frontend_tokens=cfg.n_frontend_tokens,
        frontend_dim=cfg.frontend_dim,
    )
    trainer.fit(ds, n_steps=args.steps)
    steps = [e for e in trainer.log if e["event"] == "step"]
    print(
        f"{cfg.name}: {len(steps)} steps, final loss {steps[-1]['loss']:.3f}, "
        f"restarts={trainer.restarts} stragglers={trainer.stragglers}"
    )
    print(json.dumps({"arch": cfg.name, "device": str(dev), "shape": [shape.seq_len, shape.global_batch],
                      "reduced": reduced, "optimizer": opt.name,
                      "losses": [e["loss"] for e in steps], "seconds": [e["dt"] for e in steps]}))
    return trainer


if __name__ == "__main__":
    main()
