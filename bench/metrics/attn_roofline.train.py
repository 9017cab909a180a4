"""``attn_roofline.train``: the least time of one causal attention forward
and one backward a layer at the step's shape (``bench/flops.py``), over the
device time of every flash kernel in a traced step."""
from bench import flops


def read(ctx):
    if ctx.get("kind") != "train" or ctx["arch"]["family"] != "dense":
        return None
    busy = ctx["summary"].kernel_s(flops.MIXER_KERNELS["dense"])
    if not busy:
        return None
    bound = flops.mixer_bound_s(ctx["arch"], ctx["mix"]["batch"], ctx["mix"]["seq_len"], backward=True)
    return 100.0 * bound * ctx["steps"] / busy
