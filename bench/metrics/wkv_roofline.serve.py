"""``wkv_roofline.serve``: the least time of one WKV forward a layer over
each traced prefill's batch of prompts (``bench/flops.py``), over the device
time of every WKV kernel in the traced prefills."""
from bench import flops


def read(ctx):
    if ctx.get("kind") != "serve" or ctx["arch"]["family"] != "ssm":
        return None
    busy = ctx["prefill"].kernel_s(flops.MIXER_KERNELS["ssm"])
    if not busy:
        return None
    R = ctx["mix"]["requests"]
    return 100.0 * sum(flops.mixer_bound_s(ctx["arch"], R, P, backward=False) for P in ctx["prefill_lens"]) / busy
