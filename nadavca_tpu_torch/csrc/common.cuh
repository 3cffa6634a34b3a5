// Shared constants of the banded-Viterbi kernels.
//
// NEG_INF is a large finite number, not -inf: NEG_INF + finite stays
// <= NEG_INF / 2 and never produces NaN, which is what every "has this cell a
// predecessor" guard in the fill relies on (nadavca_tpu/ops/banded_dp.py:41).
//
// All sources are built with -fmad=false and without --use_fast_math: the
// fill's near-tie decisions must be the ones eager PyTorch takes for the same
// expression, and a fused multiply-add rounds once where PyTorch rounds twice.
#pragma once

#include <cuda_runtime.h>

#define NADAVCA_NEG_INF (-1e30f)
#define NADAVCA_NEG_INF_HALF (-5e29f)
#define NADAVCA_HALF_LOG_2PI (0.91893853320467274178f)

#define NADAVCA_EXPORT extern "C" __attribute__((visibility("default")))

// Maximum of v over the block's B = 32 * n_warps threads (thread j), through
// n_warps floats of shared memory. Ends in no barrier: the caller places one
// before red[] is written again.
__device__ __forceinline__ float block_max(float v, float* red, int j, int n_warps) {
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((j & 31) == 0) red[j >> 5] = v;
    __syncthreads();
    float m = red[0];
    for (int w = 1; w < n_warps; ++w) m = fmaxf(m, red[w]);
    return m;
}
