"""Alignment kernels (``ops/cuda_dp``, ``csrc/viterbi_fill.cu``): the fills'
bound over their device time in the traced window, in %.

The bound of a batch counts what the banded fill needs, whatever implements
it (the arithmetic of ``chip_smoke.check_fill``): 8 float operations per
live cell (every slot of the band at every live sample, ``t_len`` summed
over the rows) against 67 TFLOP/s, and the bytes of the signal, the two
level rows, the band tables, the lengths, one decision bit per (sample,
slot) and plane, and the final row, each once, against 3.35 TB/s; the larger
of the two."""

from h100_bench import roofline

OPS_PER_CELL = 8
PLANES = 1


def batch_bound_s(pb) -> float:
    R, T, N, B = pb.R, pb.T, pb.N, pb.band
    n_chunks = T // pb.cfg.signal_chunk
    live_steps = int(pb.batch.t_len.astype("int64").sum())
    nbytes = (R * T * 4 + 2 * R * N * 4 + 2 * R * n_chunks * 4 + 2 * R * 4
              + PLANES * (T // 32) * R * B * 4 + R * B * 4 + R * 4)
    return roofline.bound_s(nbytes, OPS_PER_CELL * live_steps * B)


def read(ctx):
    if ctx.trace is None:
        return None
    dev = ctx.trace.device_s(lambda n: "viterbi_fill" in n)
    return roofline.share_pct(sum(batch_bound_s(pb) for pb in ctx.window_batches), dev)
