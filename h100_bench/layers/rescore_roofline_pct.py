"""Local rescore (``ops/cuda_rescore``, ``csrc/rescore.cu``): the tables
rescore's bound over its device time in the traced window, in %.

The bound of a batch (the arithmetic of ``chip_smoke.check_rescore_kernels``):
8 operations per DP cell and sample (4 bases times k slots) over the samples
of every kept window position, against 67 TFLOP/s; and the bytes of the
signal, the segment counts, the lengths, the window bases, the offsets, the
table columns the windows touch (3 planes of 4k floats and a validity byte
each) and the (R, L, 4) output, each once, against 3.35 TB/s. The kept
positions and their samples are counted on each read's true alignment (the
inputs' own path), which the Viterbi path of the step follows closely."""

import numpy as np

from h100_bench import reference, roofline


def _union_len(starts, length: int) -> int:
    s = np.sort(np.asarray(starts, np.int64))
    if len(s) == 0:
        return 0
    # equal lengths: each interval adds what lies beyond the one before it
    return int(length + np.minimum(np.diff(s), length).sum())


def batch_bound_s(pb, inputs, align) -> float:
    R, T, L, N = pb.R, pb.T, pb.L, pb.N
    k, t_w = align["k"], align["snp_local_window"]
    w_sum = 0
    fwd, rev = [], []
    for m in pb.members:
        codes = inputs.window(m)
        _, W, keep = reference.window_bounds(inputs.path[m], len(codes), codes < 4,
                                             T, L, k, t_w)
        w_sum += int(W[keep].sum())
        s, b = int(inputs.start[m]), int(inputs.bases[m])
        (fwd if inputs.strand[m] > 0 else rev).append(s if inputs.strand[m] > 0
                                                      else s + b - L)
    n_cols = _union_len(fwd, L) + _union_len(rev, L)
    lanes = -(-(N + 1) // 128) * 128
    nbytes = (R * T * 4 + R * lanes * 4 + 2 * R * 4 + R * L * 4 + R * 4
              + n_cols * (3 * 4 * k * 4 + 1) + R * L * 4 * 4)
    return roofline.bound_s(nbytes, 8 * 4 * k * w_sum)


def read(ctx):
    if ctx.trace is None:
        return None
    dev = ctx.trace.device_s(lambda n: "rescore_local" in n)
    if dev <= 0:
        return None
    align = ctx.cell.config["align"]
    per_pool = {id(pb): batch_bound_s(pb, ctx.inputs, align) for pb in ctx.pool}
    return roofline.share_pct(sum(per_pool[id(pb)] for pb in ctx.window_batches), dev)
