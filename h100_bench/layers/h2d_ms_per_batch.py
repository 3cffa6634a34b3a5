"""Upload (``pipeline.stage_batch`` through ``parallel.sharded.shard_batch``):
device time of the host-to-device copies in the traced window, per batch."""


def read(ctx):
    if ctx.trace is None or not ctx.window_batches:
        return None
    s = ctx.trace.device_s(lambda n: "HtoD" in n)
    return s * 1e3 / len(ctx.window_batches) if s > 0 else None
