// path_counts: segment bounds of a monotone path by bisection.
//
//   C[r, i] = #{ t < t_len[r] : path[r, t] < i }     for i in [0, n_lanes)
//
// The path of a read is nondecreasing over its live samples (the first
// t_len[r] of the row), so the count is the lower bound of i in that prefix:
// position i's samples are [C[r, i], C[r, i + 1]). Samples at or past t_len[r]
// are never read, whatever they hold.
//
// Replaces the TPU kernel nadavca_tpu/ops/pallas_rescore.py:35 (_count_kernel,
// launched by path_counts_pallas :88). The TPU cannot index a lane
// dynamically, so it counts with a dense compare window per chunk, whole-row
// adds right of it and a full-width fallback; here a thread simply bisects.
//
// Layout: one thread per (r, i), i fastest. The <= log2(T) + 1 probes of
// neighbouring lanes start at the same addresses and spread over a few cache
// lines in the last steps; the stores are coalesced.
//
// Bound: bytes (path read once, counts written once; integer compares only).
// The kernel touches far fewer bytes than that, (log2 T) probes per lane, and
// what it waits for is the latency of that dependent chain.

#include "common.cuh"

__global__ void path_counts_kernel(const int* __restrict__ path,
                                   const int* __restrict__ t_len,
                                   int* __restrict__ cnt,
                                   int R, int T, int n_lanes) {
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (size_t)R * n_lanes) return;
    const int i = (int)(idx % n_lanes);
    const int r = (int)(idx / n_lanes);
    const int* __restrict__ row = path + (size_t)r * T;
    int lo = 0;
    int hi = min(max(t_len[r], 0), T);      // answer lies in [lo, hi]
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] < i) lo = mid + 1; else hi = mid;
    }
    cnt[idx] = lo;
}

NADAVCA_EXPORT int nadavca_path_counts(const int* path, const int* t_len,
                                       int* cnt, int R, int T, int n_lanes,
                                       void* stream) {
    const size_t total = (size_t)R * n_lanes;
    if (total == 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    path_counts_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        path, t_len, cnt, R, T, n_lanes);
    return (int)cudaGetLastError();
}
