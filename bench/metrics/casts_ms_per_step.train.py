"""``casts_ms_per_step.train``: device time of the dtype casts and copies
(``aten::copy_``, ``aten::_to_copy``) in the traced steps, a step."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["summary"].kernels:
        return None
    return 1e3 * ctx["summary"].casts_s / ctx["steps"]
