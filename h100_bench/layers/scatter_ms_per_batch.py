"""Scatter (``call.accumulate_batch``): device time of the ``index_add_``
kernels in the traced window, per batch. In the SNP step only the scatter
into the genome accumulators launches them."""


def _index_add(name: str) -> bool:
    return "indexFunc" in name or "index_add" in name


def read(ctx):
    if ctx.trace is None or not ctx.window_batches:
        return None
    s = ctx.trace.device_s(_index_add)
    return s * 1e3 / len(ctx.window_batches) if s > 0 else None
