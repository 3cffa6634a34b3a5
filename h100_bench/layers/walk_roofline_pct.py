"""Alignment kernels (``csrc/backtrack.cu``): the walks' bound over their
device time in the traced window, in %.

The bound of a batch (the arithmetic of ``chip_smoke.check_backtrack``):
4 operations (shift, mask, add, subtract) per sample and plane against
67 TFLOP/s, and the bytes of the decision words the walk must read, the
band tables, the final slots and the path written once, against 3.35 TB/s.
The words are counted as one per 32 samples of each row, the least any walk
reads: the walked path, which sets the exact count, is not an output of the
SNP step."""

from h100_bench import roofline

PLANES = 1


def batch_bound_s(pb) -> float:
    R, T = pb.R, pb.T
    n_chunks = T // pb.cfg.signal_chunk
    words = R * (T // 32)
    nbytes = PLANES * words * 4 + 2 * R * n_chunks * 4 + R * 4 + R * T * 4
    return roofline.bound_s(nbytes, 4 * PLANES * R * T)


def read(ctx):
    if ctx.trace is None:
        return None
    dev = ctx.trace.device_s(lambda n: "backtrack" in n)
    return roofline.share_pct(sum(batch_bound_s(pb) for pb in ctx.window_batches), dev)
