"""``train_mfu``: model FLOPs of the window's steps over its wall time, as a
share of the card's bf16 peak (``bench/flops.py``)."""
from bench import flops


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["window_s"]:
        return None
    return 100.0 * ctx["step_flops"] * ctx["window_steps"] / ctx["window_s"] / flops.PEAK_BF16
