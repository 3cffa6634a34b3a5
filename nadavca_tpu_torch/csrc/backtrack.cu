// backtrack: walk the packed decision bits from the final band slot down to
// t = 0 and write the reference position of every sample.
//
//   j[T-1] = j_end,   j[t-1] = j[t] + delta[t / C] * [t % C == 0] - adv[t],
//   adv[t] = bit t of dec at slot j[t],   path[r, t] = lo[r, t / C] + j[t].
//
// Replaces the TPU kernel nadavca_tpu/ops/pallas_dp.py:676 (_advbits_kernel,
// launched by backtrack_pallas :746) together with its epilogue (:784-798).
// The TPU carries a one-hot pointer plane, emits packed advance words and
// rebuilds the path with a reverse cumulative sum outside the kernel; here the
// walk knows j as an integer, so the path is written directly. A pointer that
// leaves the band [0, B) reads advance 0 from then on, as the one-hot plane
// does once its bit has been shifted out.
//
// The two-plane variant (backtrack_skip_kernel) replaces the use_skip branch
// of the same TPU kernel (pallas_dp.py:717-723, 738-739, 788-789): with the
// skip transition the fill writes a second plane and the advance at the
// pointer is adv[t] = bit0 + 2 * bit1. Both variants are one body, specialised
// at compile time, so the one-plane walk loads and tests nothing more than it
// did before the second plane existed.
//
// Layout: one warp per read. Every lane runs the same serial walk over the 32
// steps of one decision word (the loads are one address for the whole warp,
// reloaded only when the word or the slot changes), lane s keeps the position
// of step s, and the warp stores the 32 positions as one coalesced line.
//
// Bound: latency of the serial chain. The walk needs T dependent steps for
// each read and touches one 4-byte word per (word row, visited slot); the
// bytes it must move (T/32 words per read at the least, R*T*4 bytes of path
// out) are small beside the chain's length times a load's latency.

#include "common.cuh"

template <bool TWO_PLANES>
__device__ __forceinline__ void backtrack_body(const int* __restrict__ dec,
                                               const int* __restrict__ dec2,
                                               const int* __restrict__ lo,
                                               const int* __restrict__ delta,
                                               const int* __restrict__ j_end,
                                               int* __restrict__ path,
                                               int R, int T, int C, int B) {
    const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    if (warp >= R) return;
    const int r = warp;
    const int n_chunks = T / C;
    const int n_words = T >> 5;
    const size_t word_stride = (size_t)R * B;

    int j = j_end[r];
    bool alive = (j >= 0 && j < B);
    int cached_w = -1, cached_j = -1;
    unsigned word = 0u, word2 = 0u;

    for (int w = n_words - 1; w >= 0; --w) {
        const int t_base = w << 5;
        const int c = t_base / C;
        const int lo_c = lo[(size_t)r * n_chunks + c];
        const int d_c = (t_base % C == 0) ? delta[(size_t)r * n_chunks + c] : 0;
        int mine = 0;
        for (int s = 31; s >= 0; --s) {
            if (lane == s) mine = lo_c + j;
            unsigned adv = 0u;
            if (alive) {
                if (cached_w != w || cached_j != j) {
                    const size_t at = (size_t)w * word_stride + (size_t)r * B + j;
                    word = (unsigned)dec[at];
                    if (TWO_PLANES) word2 = (unsigned)dec2[at];
                    cached_w = w;
                    cached_j = j;
                }
                adv = (word >> s) & 1u;
                if (TWO_PLANES) adv += ((word2 >> s) & 1u) << 1;
            }
            j = j + ((s == 0) ? d_c : 0) - (int)adv;
            alive = alive && (j >= 0 && j < B);
        }
        path[(size_t)r * T + t_base + lane] = mine;
    }
}

__global__ void backtrack_kernel(const int* __restrict__ dec,
                                 const int* __restrict__ lo,
                                 const int* __restrict__ delta,
                                 const int* __restrict__ j_end,
                                 int* __restrict__ path,
                                 int R, int T, int C, int B) {
    backtrack_body<false>(dec, nullptr, lo, delta, j_end, path, R, T, C, B);
}

__global__ void backtrack_skip_kernel(const int* __restrict__ dec,
                                      const int* __restrict__ dec2,
                                      const int* __restrict__ lo,
                                      const int* __restrict__ delta,
                                      const int* __restrict__ j_end,
                                      int* __restrict__ path,
                                      int R, int T, int C, int B) {
    backtrack_body<true>(dec, dec2, lo, delta, j_end, path, R, T, C, B);
}

NADAVCA_EXPORT int nadavca_backtrack(const int* dec, const int* lo,
                                     const int* delta, const int* j_end,
                                     int* path, int R, int T, int C, int B,
                                     void* stream) {
    if (R == 0) return 0;
    if ((C & 31) || C <= 0 || T % C) return (int)cudaErrorInvalidValue;
    const int warps_per_block = 4;
    const unsigned blocks = (unsigned)((R + warps_per_block - 1) / warps_per_block);
    backtrack_kernel<<<blocks, warps_per_block * 32, 0, (cudaStream_t)stream>>>(
        dec, lo, delta, j_end, path, R, T, C, B);
    return (int)cudaGetLastError();
}

NADAVCA_EXPORT int nadavca_backtrack_skip(const int* dec, const int* dec2,
                                          const int* lo, const int* delta,
                                          const int* j_end, int* path,
                                          int R, int T, int C, int B,
                                          void* stream) {
    if (R == 0) return 0;
    if ((C & 31) || C <= 0 || T % C) return (int)cudaErrorInvalidValue;
    const int warps_per_block = 4;
    const unsigned blocks = (unsigned)((R + warps_per_block - 1) / warps_per_block);
    backtrack_skip_kernel<<<blocks, warps_per_block * 32, 0, (cudaStream_t)stream>>>(
        dec, dec2, lo, delta, j_end, path, R, T, C, B);
    return (int)cudaGetLastError();
}
