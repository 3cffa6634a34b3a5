"""Batching (``pipeline.assemble_batch``): milliseconds per pool batch of the
assembly in set-up, by the harness's clock."""


def read(ctx):
    n = ctx.setup.get("assemble_batches")
    return ctx.setup["assemble_s"] * 1e3 / n if n else None
