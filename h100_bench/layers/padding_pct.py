"""Batching (``cli._stream_groups``, ``pipeline.assemble_batch``): the share of
the signal axis that is padding, over the true reads of the batches the
window ran (the arithmetic of ``cli._padding_waste``, summed over batches)."""


def read(ctx):
    live = padded = 0
    for pb in ctx.window_batches:
        n = max(pb.batch.n_reads, 1)
        live += int(pb.batch.t_len[:n].sum())
        padded += n * pb.T
    return 100.0 * (1.0 - live / padded) if padded else None
