// scatter: the locus scatter of call.accumulate_batch_ in one launch.
//
// For every read r and window position i of a batch's (R, L, 4) base
// log-likelihoods, added into the genome accumulators acc (G, 4) f32,
// cov (G,) i32 and votes (G, 4) i32:
//
//   pos   = ws[r] + i, or ws[r] + wl[r] - 1 - i on the reverse strand
//   valid = i < wl[r] and 0 <= pos < G        (an invalid position adds nothing)
//   v     = ll[r, i, :], reversed on the reverse strand (A C G T -> T G C A)
//   acc[pos]  += clamp(v, -clip, clip)         (NaN stays NaN, as torch.clamp)
//   cov[pos]  += 1
//   votes[pos, best] += 1  where best_v - second >= margin, on the UNclipped
//                          v: best the first maximum (argmax), second the
//                          second largest counting ties (sort(v)[2]); a row
//                          holding a NaN never votes
//
// index_add_windows_kernel replaces no TPU kernel: the JAX package leaves the
// scatter to XLA (nadavca_tpu/call.py, scatter_values + .at[].add). Its plain
// version is ops/cuda_scatter.index_add_windows_plain, the composition it
// replaces: call.scatter_values (positions, complement, clip, mask, and a
// full sort of every 4-value row to find the runner-up) and three
// index_add_, whose padded and out-of-genome positions all went to one
// overflow row.
//
// Bound: bytes. The batch's (R, L, 4) floats are read once (16 B a
// position, one float4 a thread, neighbouring threads on neighbouring
// positions), and each valid position adds 24 B into the genome rows (one
// float4 atomic, one or two int atomics). A read's positions are
// consecutive genome rows, so a warp's atomics land on 512 contiguous bytes
// of acc; nothing contends but reads that overlap. Sums are float32 in an
// order that changes from run to run, as index_add_'s on the card; cov and
// votes are exact integer sums.
//
// One thread per (read, position), 256 a block, over the flat R * L range.
// The three per-read vectors come as int32 or int64 (a flag each), as the
// callers hold them.

#include "common.cuh"

namespace {

constexpr int SCATTER_THREADS = 256;

__device__ __forceinline__ long long load_index(const void* p, int is64, int r) {
    return is64 ? static_cast<const long long*>(p)[r]
                : static_cast<long long>(static_cast<const int*>(p)[r]);
}

// torch.clamp(v, -c, c) by compare and select: a NaN compares false and stays
__device__ __forceinline__ float clip_to(float v, float c) {
    return v < -c ? -c : (v > c ? c : v);
}

__device__ __forceinline__ void add4(float4* __restrict__ dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(dst, v);   // one 16-byte vector atomic (sm_90, global memory)
#else
    float* d = reinterpret_cast<float*>(dst);
    atomicAdd(d, v.x);
    atomicAdd(d + 1, v.y);
    atomicAdd(d + 2, v.z);
    atomicAdd(d + 3, v.w);
#endif
}

}  // namespace

__global__ void __launch_bounds__(SCATTER_THREADS)
index_add_windows_kernel(const float4* __restrict__ ll, const void* __restrict__ ws,
                         const void* __restrict__ wl, const void* __restrict__ strand,
                         int ws64, int wl64, int st64, float4* __restrict__ acc,
                         int* __restrict__ cov, int* __restrict__ votes, long long n_all,
                         int L, long long G, float clip, float margin) {
    const long long n = (long long)blockIdx.x * SCATTER_THREADS + threadIdx.x;
    if (n >= n_all) return;
    const int r = (int)(n / L);
    const long long i = n - (long long)r * L;
    const long long w0 = load_index(ws, ws64, r);
    const long long wn = load_index(wl, wl64, r);
    if (i >= wn) return;
    const bool rev = load_index(strand, st64, r) < 0;
    const long long pos = rev ? w0 + (wn - 1 - i) : w0 + i;
    if (pos < 0 || pos >= G) return;

    float4 v = ll[n];
    if (rev) v = make_float4(v.w, v.z, v.y, v.x);
    add4(acc + pos, make_float4(clip_to(v.x, clip), clip_to(v.y, clip),
                                clip_to(v.z, clip), clip_to(v.w, clip)));
    atomicAdd(cov + pos, 1);
    if (votes == nullptr) return;

    if (v.x != v.x || v.y != v.y || v.z != v.z || v.w != v.w) return;
    // one pass: the first maximum and the largest of the others (ties count)
    int best = 0;
    float best_v = v.x, second = __int_as_float(0xff800000);   // -inf
    const float rest[3] = {v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        if (rest[b] > best_v) {
            second = best_v;
            best_v = rest[b];
            best = b + 1;
        } else if (rest[b] > second) {
            second = rest[b];
        }
    }
    if (best_v - second >= margin) atomicAdd(votes + pos * 4 + best, 1);
}

// ll (R, L, 4) f32, 16-byte aligned; ws, wl, strand (R,) int32 or int64 (the
// flags); acc (G, 4) f32, 16-byte aligned; cov (G,) i32; votes (G, 4) i32 or
// null. Adds in place on the given stream.
NADAVCA_EXPORT int nadavca_index_add_windows(const float* ll, const void* ws, const void* wl,
                                             const void* strand, int ws64, int wl64,
                                             int st64, float* acc, int* cov, int* votes,
                                             int R, int L, long long G, float clip,
                                             float margin, void* stream) {
    const long long n_all = (long long)R * L;
    if (n_all == 0) return 0;
    if (R < 0 || L < 0 || G < 0) return (int)cudaErrorInvalidValue;
    const long long blocks = (n_all + SCATTER_THREADS - 1) / SCATTER_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    index_add_windows_kernel<<<(unsigned)blocks, SCATTER_THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(ll), ws, wl, strand, ws64, wl64, st64,
        reinterpret_cast<float4*>(acc), cov, votes, n_all, L, G, clip, margin);
    return (int)cudaGetLastError();
}
