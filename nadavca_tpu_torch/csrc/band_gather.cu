// band_gather: per (chunk, read) slice of the expected-level rows.
//
//   mu_b[c, r, j] = mu[r, lo[r, c] + j]   (0 where lo + j leaves [0, N))
//   sg_b[c, r, j] = sigma[r, lo[r, c] + j] (1 there)
//
// Replaces the TPU kernel nadavca_tpu/ops/pallas_dp.py:520 (_band_gather_kernel,
// launched by band_gather_pallas :558). The TPU version slices with coarse
// 128-blocks plus a roll because gathers serialize there; on this card a
// bounds-checked load per output element is the whole function. The
// single-step fills gather their band levels themselves (csrc/viterbi_fill.cu,
// the producer warps); this launch serves the two-sample fill.
//
// Bound: bytes. 2 * n_chunks * R * B floats are written and 2 * R * N read;
// there is no arithmetic. One warp per ROWS output rows (c, r), rows in
// output order: lanes 0 .. ROWS-1 load the rows' lo and hand them round by a
// shuffle; lane l writes slots 4l .. 4l + 3 (and every 128th after) of each
// row as one 16-byte store, so a warp's stores are contiguous runs; its loads
// are contiguous runs of the level rows, at arbitrary offsets (scalar). The
// loads of all ROWS rows are issued before their stores, so a warp keeps
// 8 * ROWS loads in flight. All index arithmetic but the output row's offset
// is 32-bit: the first version computed a 64-bit division and modulo per
// element, one thread per element, and lost to two torch.gather calls.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;               // warps of a block
constexpr int ROWS = 4;                // output rows of a warp

__device__ __forceinline__ float4 gather4(const float* __restrict__ row, int p, int N,
                                          float pad) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        v[e] = (unsigned)(p + e) < (unsigned)N ? row[p + e] : pad;
    return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(32 * WARPS)
band_gather_kernel(const float* __restrict__ mu, const float* __restrict__ sigma,
                   const int* __restrict__ lo, float* __restrict__ mu_b,
                   float* __restrict__ sg_b, int R, int N, int n_chunks, int B) {
    const int lane = threadIdx.x & 31;
    const int rows = n_chunks * R;
    const int q0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;   // c * R + r
    if (q0 >= rows) return;
    // lane u < ROWS: the band start of row q0 + u
    int my_p0 = 0;
    if (lane < ROWS && q0 + lane < rows) {
        const int c = (q0 + lane) / R;
        my_p0 = lo[(q0 + lane - c * R) * n_chunks + c];
    }
    int p0[ROWS], rr[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
        p0[u] = __shfl_sync(0xffffffffu, my_p0, u);
        rr[u] = (q0 + u) % R;
    }
    if ((B & 3) == 0) {
        for (int j = 4 * lane; j < B; j += 128) {
            float4 m[ROWS], g[ROWS];
#pragma unroll
            for (int u = 0; u < ROWS; ++u) {
                if (q0 + u < rows) {
                    m[u] = gather4(mu + (size_t)rr[u] * N, p0[u] + j, N, 0.0f);
                    g[u] = gather4(sigma + (size_t)rr[u] * N, p0[u] + j, N, 1.0f);
                }
            }
#pragma unroll
            for (int u = 0; u < ROWS; ++u) {
                if (q0 + u < rows) {
                    *reinterpret_cast<float4*>(mu_b + (size_t)(q0 + u) * B + j) = m[u];
                    *reinterpret_cast<float4*>(sg_b + (size_t)(q0 + u) * B + j) = g[u];
                }
            }
        }
    } else {
        for (int u = 0; u < ROWS && q0 + u < rows; ++u) {
            const float* __restrict__ mr = mu + (size_t)rr[u] * N;
            const float* __restrict__ sr = sigma + (size_t)rr[u] * N;
            for (int j = lane; j < B; j += 32) {
                const int p = p0[u] + j;
                const bool in = (unsigned)p < (unsigned)N;
                mu_b[(size_t)(q0 + u) * B + j] = in ? mr[p] : 0.0f;
                sg_b[(size_t)(q0 + u) * B + j] = in ? sr[p] : 1.0f;
            }
        }
    }
}

}  // namespace

NADAVCA_EXPORT int nadavca_band_gather(const float* mu, const float* sigma,
                                       const int* lo, float* mu_b, float* sg_b,
                                       int R, int N, int n_chunks, int B,
                                       void* stream) {
    const long long rows = (long long)n_chunks * R;
    if (rows == 0 || B == 0) return 0;
    if (rows > 0x7fffffffLL - WARPS * ROWS || B < 0 || N < 0)
        return (int)cudaErrorInvalidValue;
    const long long per_block = (long long)WARPS * ROWS;
    const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
    band_gather_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        mu, sigma, lo, mu_b, sg_b, R, N, n_chunks, B);
    return (int)cudaGetLastError();
}

NADAVCA_EXPORT const char* nadavca_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
