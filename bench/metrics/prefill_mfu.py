"""``prefill_mfu``: the traced prefills' FLOPs (``bench/flops.py``: the
block matrices over every prompt token, the mixer, the head at each
prompt's last position) over the trace's span, first device interval to
last, as a share of the card's bf16 peak."""
from bench import flops


def read(ctx):
    s = ctx.get("prefill")
    if ctx.get("kind") != "serve" or s is None or not s.span_s:
        return None
    return 100.0 * ctx["prefill_flops"] / s.span_s / flops.PEAK_BF16
