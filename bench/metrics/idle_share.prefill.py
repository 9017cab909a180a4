"""``idle_share.prefill``: the traced prefill's span, first device interval
to last, less the union of the device's intervals, as a share of the span."""


def read(ctx):
    s = ctx.get("prefill")
    if ctx.get("kind") != "serve" or s is None or not s.span_s:
        return None
    return 100.0 * (s.span_s - s.busy_s) / s.span_s
