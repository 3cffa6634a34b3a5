// rescore: the restricted local re-DP of the SNP rescore, two entry points.
//
// For every (read r, window position i) and candidate base b, a small Viterbi
// over the K k-mer slots that contain base i, run on the samples
// xs[0 .. W[r, i]) the global path gave to those slots:
//
//   v0[j][b]  = em - d0 * d0 * iv   for j == 0, NEG_INF otherwise   (step 0 is
//                                    taken whatever W is)
//   s = 1 .. W-1:  emit = em - d * d * iv,  d = xs[s] - mu
//                  v[j][b] = emit + max(v[j][b] + log_p_stay,
//                                       v[j-1][b] + log_p_move)   (v[-1] = NEG_INF)
//   out[b] = v[kk-1][b] - v[kk-1][codes]       (0 where kk-1 is outside [0, K))
//
// Replaces the TPU kernels nadavca_tpu/ops/pallas_rescore.py:218
// (_rescore_tab_kernel, launched by rescore_fill_tab_pallas :326) and :191
// (_rescore_kernel, launched by rescore_fill_pallas :280), which share
// _rescore_dp_body :136 as the two entry points here share rescore_body:
//   rescore_tab_kernel  the constants em/mu/iv come from the genome table
//                       tab[plane][j*4 + b][woff[r] + i]; the TPU copies two
//                       128-blocks per read by DMA and realigns them with a
//                       roll, here a thread reads its column directly;
//   rescore_kernel      the constants come per batch as (K*4, R, L) arrays.
//
// Layout: one thread per (r, i), i fastest, so the loads of xs[s, r, i], of the
// table columns and of the per-batch constants are coalesced across a warp.
// The 3 * K * 4 constants and the K * 4 state values live in registers (K is a
// template parameter so every loop unrolls). Each thread loops to its own
// W[r, i]; the TPU stops a tile at the tile's maximum and masks, which is the
// same thing.
//
// Bound: operations for long windows, bytes for short ones: 8 * K * 4
// operations per live sample of each position, against xs read up to W, 3*K*4
// constants per position and 4 outputs. NEG_INF is the finite -1e30: dead
// slots sink by another -1e30 per step and never reach an infinity.
//
// Built with -fmad=false: the expression order above is that of the plain
// PyTorch version, so both round alike (see common.cuh).

#include "common.cuh"

template <int K>
__device__ __forceinline__ void rescore_body(
        const float* __restrict__ xs, size_t rl, size_t idx,
        const float (&em)[K][4], const float (&mu)[K][4], const float (&iv)[K][4],
        int w, int kk1, int cod, float log_p_stay, float log_p_move,
        float* __restrict__ out) {
    float v[K][4];
    const float x0 = xs[idx];
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const float d0 = x0 - mu[j][b];
            const float emit0 = em[j][b] - d0 * d0 * iv[j][b];
            v[j][b] = (j == 0) ? emit0 : NADAVCA_NEG_INF;
        }
    }
    for (int s = 1; s < w; ++s) {
        const float x = xs[(size_t)s * rl + idx];
        // slots from the top down, so v[j-1] is still the previous step's
#pragma unroll
        for (int j = K - 1; j >= 0; --j) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const float d = x - mu[j][b];
                const float emit = em[j][b] - d * d * iv[j][b];
                const float stay = v[j][b] + log_p_stay;
                const float below = (j > 0) ? v[j > 0 ? j - 1 : 0][b] : NADAVCA_NEG_INF;
                const float move = below + log_p_move;
                v[j][b] = emit + fmaxf(stay, move);
            }
        }
    }
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (kk1 == j) {
#pragma unroll
            for (int b = 0; b < 4; ++b) o[b] = v[j][b];
        }
    }
    float ref = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        if (cod == b) ref = o[b];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) out[(size_t)b * rl + idx] = o[b] - ref;
}

template <int K>
__global__ void rescore_tab_kernel(const float* __restrict__ xs,
                                   const int* __restrict__ w,
                                   const int* __restrict__ kk,
                                   const int* __restrict__ codes,
                                   const int* __restrict__ woff,
                                   const float* __restrict__ tab,
                                   float* __restrict__ out,
                                   int R, int L, int t_w, int rows_p,
                                   float log_p_stay, float log_p_move) {
    const size_t rl = (size_t)R * L;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= rl) return;
    const int i = (int)(idx % L);
    const int r = (int)(idx / L);
    const size_t col = (size_t)woff[r] + i;
    const size_t plane = (size_t)K * 4 * rows_p;
    float em[K][4], mu[K][4], iv[K][4];
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const size_t at = (size_t)(j * 4 + b) * rows_p + col;
            em[j][b] = tab[at];
            mu[j][b] = tab[plane + at];
            iv[j][b] = tab[2 * plane + at];
        }
    }
    rescore_body<K>(xs, rl, idx, em, mu, iv, min(w[idx], t_w), kk[idx] - 1,
                    codes[idx], log_p_stay, log_p_move, out);
}

template <int K>
__global__ void rescore_kernel(const float* __restrict__ xs,
                               const float* __restrict__ em_a,
                               const float* __restrict__ mu_a,
                               const float* __restrict__ iv_a,
                               const int* __restrict__ w,
                               const int* __restrict__ kk,
                               const int* __restrict__ codes,
                               float* __restrict__ out,
                               int R, int L, int t_w,
                               float log_p_stay, float log_p_move) {
    const size_t rl = (size_t)R * L;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= rl) return;
    float em[K][4], mu[K][4], iv[K][4];
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const size_t at = (size_t)(j * 4 + b) * rl + idx;
            em[j][b] = em_a[at];
            mu[j][b] = mu_a[at];
            iv[j][b] = iv_a[at];
        }
    }
    rescore_body<K>(xs, rl, idx, em, mu, iv, min(w[idx], t_w), kk[idx] - 1,
                    codes[idx], log_p_stay, log_p_move, out);
}

#define RESCORE_THREADS 128

// one instantiation per supported k-mer length
#define RESCORE_DISPATCH(LAUNCH)                    \
    switch (k) {                                    \
        case 1: LAUNCH(1); break;                   \
        case 2: LAUNCH(2); break;                   \
        case 3: LAUNCH(3); break;                   \
        case 4: LAUNCH(4); break;                   \
        case 5: LAUNCH(5); break;                   \
        case 6: LAUNCH(6); break;                   \
        case 7: LAUNCH(7); break;                   \
        case 8: LAUNCH(8); break;                   \
        default: return (int)cudaErrorInvalidValue; \
    }

NADAVCA_EXPORT int nadavca_rescore_tab(const float* xs, const int* w,
                                       const int* kk, const int* codes,
                                       const int* woff, const float* tab,
                                       float* out, int R, int L, int t_w, int k,
                                       int rows_p, float log_p_stay,
                                       float log_p_move, void* stream) {
    const size_t rl = (size_t)R * L;
    if (rl == 0) return 0;
    if (t_w < 1) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((rl + RESCORE_THREADS - 1) / RESCORE_THREADS);
#define LAUNCH_TAB(KV)                                                          \
    rescore_tab_kernel<KV><<<blocks, RESCORE_THREADS, 0, (cudaStream_t)stream>>>( \
        xs, w, kk, codes, woff, tab, out, R, L, t_w, rows_p, log_p_stay, log_p_move)
    RESCORE_DISPATCH(LAUNCH_TAB)
#undef LAUNCH_TAB
    return (int)cudaGetLastError();
}

NADAVCA_EXPORT int nadavca_rescore(const float* xs, const float* em,
                                   const float* mu, const float* iv,
                                   const int* w, const int* kk, const int* codes,
                                   float* out, int R, int L, int t_w, int k,
                                   float log_p_stay, float log_p_move,
                                   void* stream) {
    const size_t rl = (size_t)R * L;
    if (rl == 0) return 0;
    if (t_w < 1) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((rl + RESCORE_THREADS - 1) / RESCORE_THREADS);
#define LAUNCH_ARR(KV)                                                      \
    rescore_kernel<KV><<<blocks, RESCORE_THREADS, 0, (cudaStream_t)stream>>>( \
        xs, em, mu, iv, w, kk, codes, out, R, L, t_w, log_p_stay, log_p_move)
    RESCORE_DISPATCH(LAUNCH_ARR)
#undef LAUNCH_ARR
    return (int)cudaGetLastError();
}
