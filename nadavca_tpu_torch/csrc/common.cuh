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
