"""Local rescore (``ops/cuda_rescore``, ``csrc/rescore.cu``): device time of
the ``rescore_local*`` kernels (with genome tables and without) in the
traced window, per batch; None where no such kernel ran."""


def read(ctx):
    if ctx.trace is None or not ctx.window_batches:
        return None
    s = ctx.trace.device_s(lambda n: "rescore_local" in n)
    return s * 1e3 / len(ctx.window_batches) if s > 0 else None
