// shear_gather: the sample window of every window position.
//
//   xs[s, r, i] = x[r, S[r, i] + s]          s in [0, t_w)
//
// Replaces the TPU kernel nadavca_tpu/ops/pallas_rescore.py:627 (kernel_wrap,
// launched by shear_gather_pallas :568). The TPU gathers through the matrix
// unit: a one-hot product over a slab of `span` samples per (read, tile of
// 128 positions), the f32 values split three ways into bf16, and a log-shift
// for the residual offset. On this card the whole function is one
// bounds-checked load per output element.
//
// Two modes, chosen by the wrapper:
//   slab rule on  (base != nullptr): base[r, i / 128] is the aligned slab base
//     of the tile; an element whose d = S[r, i] - base lies outside [0, span)
//     comes out 0.0, as the TPU kernel's does (its caller masks such
//     positions). Everything else is x[r, S + s] exactly.
//   slab rule off (base == nullptr): the index S + s is clamped to [0, T - 1].
//
// Layout: one thread per (r, i), i fastest, times a grid axis over blocks of
// SHEAR_S_CHUNK values of s. At a fixed s a warp stores 32 neighbouring floats
// (one line) and loads 32 samples a dwell apart, which stay in L1 for the
// thread's next values of s.
//
// Bound: bytes. t_w * R * L floats are written (201 MB at R=256, L=1024,
// t_w=192) and x is read once; there is no arithmetic.

#include "common.cuh"

#define SHEAR_S_CHUNK 32

__global__ void shear_gather_kernel(const float* __restrict__ x,
                                    const int* __restrict__ S,
                                    const int* __restrict__ base,
                                    float* __restrict__ xs,
                                    int R, int T, int L, int t_w, int span,
                                    int tile) {
    const size_t rl = (size_t)R * L;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= rl) return;
    const int i = (int)(idx % L);
    const int r = (int)(idx / L);
    const int s0 = blockIdx.y * SHEAR_S_CHUNK;
    const int s1 = min(s0 + SHEAR_S_CHUNK, t_w);
    const int start = S[idx];
    const float* __restrict__ row = x + (size_t)r * T;
    if (base != nullptr) {
        const int d = start - base[(size_t)r * (L / tile) + i / tile];
        const bool ok = d >= 0 && d < span;
#pragma unroll 8
        for (int s = s0; s < s1; ++s) {
            const int p = start + s;
            xs[(size_t)s * rl + idx] = (ok && p < T) ? row[p] : 0.0f;
        }
    } else {
#pragma unroll 8
        for (int s = s0; s < s1; ++s) {
            const int p = min(max(start + s, 0), T - 1);
            xs[(size_t)s * rl + idx] = row[p];
        }
    }
}

NADAVCA_EXPORT int nadavca_shear_gather(const float* x, const int* S,
                                        const int* base, float* xs,
                                        int R, int T, int L, int t_w, int span,
                                        int tile, void* stream) {
    const size_t rl = (size_t)R * L;
    if (rl == 0 || t_w == 0) return 0;
    if (T <= 0 || tile <= 0 || (base != nullptr && L % tile))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    dim3 grid((unsigned)((rl + threads - 1) / threads),
              (unsigned)((t_w + SHEAR_S_CHUNK - 1) / SHEAR_S_CHUNK));
    shear_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        x, S, base, xs, R, T, L, t_w, span, tile);
    return (int)cudaGetLastError();
}
