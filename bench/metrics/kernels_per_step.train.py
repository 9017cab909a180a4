"""``kernels_per_step.train``: device kernels in the traced steps, a step."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["summary"].kernels:
        return None
    return ctx["summary"].kernels / ctx["steps"]
