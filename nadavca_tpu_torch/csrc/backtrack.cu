// backtrack: walk the packed decision bits from the final band slot down to
// t = 0, write the reference position of every sample and, on request, the
// segment counts of the path.
//
//   j[T-1] = j_end,   j[t-1] = j[t] + delta[t / C] * [t % C == 0] - adv[t],
//   adv[t] = bit t of dec at slot j[t] (+ 2 * the same bit of dec2),
//   path[r, t] = lo[r, t / C] + j[t].
//
// A pointer that leaves the band [0, B) reads advance 0 from then on, as the
// TPU's one-hot pointer plane does once its bit has been shifted out.
// With counts (cnt != nullptr), also
//
//   cnt[r, i] = #{ t < t_len[r] : path[r, t] < i }     for i in [0, n_lanes),
//
// which for a nondecreasing live path (lo[c] = lo[c-1] + delta[c], as the
// band schedule builds it) is: cnt[i] = t for path[t-1] < i <= path[t] with
// 0 < t < t_len, 0 for i <= path[0], t_len above path[t_len - 1], and all
// zeros for t_len <= 0. Each i is written once.
//
// Replaces the TPU kernel nadavca_tpu/ops/pallas_dp.py:676 (_advbits_kernel,
// launched by backtrack_pallas :746) with its epilogue (:784-798), its
// use_skip branch (:717-723, 738-739, 788-789), and, as the counts epilogue,
// nadavca_tpu/ops/pallas_rescore.py:35 (_count_kernel, launched by
// path_counts_pallas :88). The TPU carries a one-hot pointer plane over all
// slots at once and rebuilds the path by a reverse cumulative sum outside the
// kernel; the counts are a second kernel over the finished path.
//
// Bound on this card. The function's own bytes (the words along the path,
// the path and counts written once) take microseconds; what bounds a walk
// of one dependent step per sample is its chain: T steps, and with the word
// loaded from device memory at each pointer move, a DRAM latency each (0.71
// ms for T = 11,136 in the port's first walk). This design takes device
// memory off the chain and shortens it from T steps to T/32 shared-memory
// lookups; it pays for that by reading every word once (R * T * B / 8 bytes
// per plane, 45.6 MB at the main shape: 14 us at 3.35 TB/s) and by composing
// all B entries of every row (T * B steps per read, 5 instructions for a
// 32-bit register of 4 or 2 codes).
//
//   Segments. A block of 512 threads (256 above B = 256, where a lane's
//   words, codes and shuffled neighbours of pass 1 need up to 112 registers
//   with two planes) walks one read, S word rows at a time
//   from the top; the S rows' words (B int32 per row and plane, one coalesced
//   line each) and their lo / delta are staged into shared memory by
//   cp.async, the next segment's copies in flight while this one is worked
//   on (two buffers). S is sized to ~96 KB of shared memory per block, so
//   two blocks share an SM (at B = 1024 with two planes a row takes 18.6 KB:
//   S = 5).
//   1. Row maps, in parallel. One warp per word row composes the row's 32
//      steps for every entry slot at once: after step s, h_s(e) = h_{s-1}(e)
//      if the bit at (s, e) is 0, else h_{s-1}(e - adv), where e - adv < 0
//      is "dead there" (s >= 1) or the raw value (s = 0, which a delta may
//      bring back). Lane l holds entries l + 32m packed as 8-bit codes, or
//      16-bit ones from B = 256 on (value + 4: 0, 1 dead at -2, -1; 2, 3 raw
//      -2, -1; 4 + j), B / 32 codes in B / 128 or B / 64 registers. The row's
//      bits are transposed once (prmt) so that a step's select mask is one
//      shift and one sign-replicating prmt, off the chain; the chain of a
//      step is one register shuffle, a funnel shift (lane 0 takes lane 31's
//      code one lower) and a bitwise select. No load depends on a pointer.
//   2. Stitch, one thread: the entry state (j, alive) of each row from the
//      row above's map and the chunk's delta: S dependent shared-memory
//      lookups per segment, T/32 per read.
//   3. Re-walk, in parallel, one thread per row from its known entry, over
//      the row's words in shared memory (32 branch-free steps, a load each);
//      the positions go to a shared tile that is stored as one contiguous run
//      of the path. With counts, the threads then go over the segment's
//      samples in parallel: a sample t writes the count entries between
//      path[t - 1] and path[t] (a move of 1 or 2 writes 1 or 2), and the
//      entries below path[0] and above path[t_len - 1] are filled after the
//      last segment.
// The serial chain of a read is thus T/32 stitch lookups plus, per segment,
// 32 pass-1 steps and 32 re-walk steps. Tracebacks from different entries
// merge without skips and may cross with them; the maps make no use of
// either. The one-plane program loads and tests no second plane. The two
// planes are disjoint (advance 1 or 2, never both), as the skip fill writes
// them.

#include "common.cuh"

#include <stdint.h>
#include <type_traits>

namespace {

constexpr size_t WALK_SMEM_TARGET = 96 * 1024;
constexpr int CODE_OFFSET = 4;
// most band slots the walk takes: 32 word columns of a lane (the fill's limit)
constexpr int MAX_NM = 32;

// threads of a read's block: 16 warps up to B = 256, 8 above, so that the
// compiler may give pass 1 up to 255 registers a thread (one block per SM
// is all the launch bound asks for)
template <int NM>
constexpr int walk_threads() { return NM <= 8 ? 512 : 256; }

template <int NM, bool TWO>
struct Walk {
    static_assert(NM >= 1 && NM <= MAX_NM, "B is 32 .. 1024 in steps of 32");
    static constexpr int B = NM * 32;
    static constexpr int P = TWO ? 2 : 1;
    static constexpr int EB = (B + CODE_OFFSET <= 256) ? 8 : 16;   // bits per code
    static constexpr int PK = 32 / EB;                            // codes per register
    static constexpr int NR = (NM + PK - 1) / PK;                 // registers per lane
    static constexpr unsigned EMASK = (1u << EB) - 1u;
    using code_t = typename std::conditional<EB == 8, uint8_t, uint16_t>::type;

    // shared memory of a segment of S rows: words and lo / delta (two
    // buffers each), the path tile, the entry state per row and one below,
    // path[0] and path[t_len - 1], the maps
    static size_t smem_bytes(int S) {
        return (size_t)S * (2 * P * B * 4 + 33 * 4 + 6 * 4 + B * sizeof(code_t)) + 6 * 4 + 2 * 4;
    }
    static int seg_rows(int n_words) {
        const size_t per_row = smem_bytes(1) - smem_bytes(0);
        int S = (int)((WALK_SMEM_TARGET - smem_bytes(0)) / per_row);
        return S < 1 ? 1 : (S > n_words ? (n_words > 0 ? n_words : 1) : S);
    }
};

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned sel) {
    unsigned d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
    return d;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the most recent group have landed
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// The decision bits of one register's codes, transposed: for EB = 8, code k
// of group g holds byte g of the word of code k (steps 8g .. 8g + 7); for
// EB = 16, half g. Codes beyond the band hold 0.
template <int EB, int PK, int NM>
__device__ __forceinline__ void transpose_bits(const unsigned (&w)[NM], int q,
                                               unsigned (&grp)[PK]) {
    unsigned x[PK];
#pragma unroll
    for (int k = 0; k < PK; ++k) x[k] = (q * PK + k < NM) ? w[q * PK + k] : 0u;
#pragma unroll
    for (int g = 0; g < PK; ++g) {
        if constexpr (EB == 8) {
            const unsigned sel = (unsigned)g | ((4u + g) << 4);
            grp[g] = prmt(prmt(x[0], x[1], sel), prmt(x[2], x[3], sel), 0x5410u);
        } else {
            grp[g] = prmt(x[0], x[1], (2u * g) | ((2u * g + 1) << 4) | ((4u + 2 * g) << 8)
                                          | ((5u + 2 * g) << 12));
        }
    }
}

// All ones in the codes whose decision bit of step s is set: the bit is moved
// to the top of its code and replicated over the code (prmt's sign mode).
template <int EB>
__device__ __forceinline__ unsigned step_mask(unsigned grp_g, int i) {
    if constexpr (EB == 8) return prmt(grp_g << (7 - i), 0u, 0xBA98u);
    else return prmt(grp_g << (15 - i), 0u, 0xBB99u);
}

// Pass 1: the exit code of every entry slot of one word row, by one warp.
template <int NM, bool TWO>
__device__ __forceinline__ void row_map(const unsigned* __restrict__ words,
                                        typename Walk<NM, TWO>::code_t* __restrict__ map,
                                        int lane) {
    using W = Walk<NM, TWO>;
    constexpr int EB = W::EB, PK = W::PK, NR = W::NR;
    unsigned w1[NM], w2[TWO ? NM : 1];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
        w1[m] = words[lane + 32 * m];
        if constexpr (TWO) w2[m] = words[W::B + lane + 32 * m];
    }
    unsigned g1[NR][PK], g2[TWO ? NR : 1][PK];
    unsigned h[NR];                     // identity: entry e holds e
#pragma unroll
    for (int q = 0; q < NR; ++q) {
        transpose_bits<EB, PK, NM>(w1, q, g1[q]);
        if constexpr (TWO) transpose_bits<EB, PK, NM>(w2, q, g2[q]);
        unsigned v = 0u;
#pragma unroll
        for (int k = 0; k < PK; ++k)
            if (q * PK + k < NM)
                v |= (unsigned)(lane + 32 * (q * PK + k) + CODE_OFFSET) << (EB * k);
        h[q] = v;
    }
    // lane 0 (and lane 1 for the skip) takes its neighbour from lane 31 (30)
    // one code lower: a funnel shift by one code, the boundary entering at 0
    const int sh1 = (lane == 0) ? EB : 0;
    const int sh2 = (lane < 2) ? EB : 0;
    const int src1 = (lane + 31) & 31, src2 = (lane + 30) & 31;
    const unsigned lane0 = (lane == 0) ? 1u : 0u;
#pragma unroll
    for (int s = 0; s < 32; ++s) {
        // below slot 0: the raw value after step 0, dead after any later step
        const unsigned c1 = (s == 0) ? 3u : 1u;            // -1 (-2 is one less)
        const unsigned b1 = c1 << (32 - EB);
        const unsigned b2 = (c1 - lane0) << (32 - EB);     // lane 0: -2, lane 1: -1
        unsigned rot1[NR], rot2[TWO ? NR : 1];
#pragma unroll
        for (int q = 0; q < NR; ++q) {
            rot1[q] = __shfl_sync(0xffffffffu, h[q], src1);
            if constexpr (TWO) rot2[q] = __shfl_sync(0xffffffffu, h[q], src2);
        }
#pragma unroll
        for (int q = 0; q < NR; ++q) {
            const unsigned m1 = step_mask<EB>(g1[q][s / EB], s % EB);
            const unsigned nb1 = __funnelshift_l(q ? rot1[q - 1] : b1, rot1[q], sh1);
            unsigned v = (nb1 & m1) | (h[q] & ~m1);
            if constexpr (TWO) {
                const unsigned m2 = step_mask<EB>(g2[q][s / EB], s % EB);
                const unsigned nb2 = __funnelshift_l(q ? rot2[q - 1] : b2, rot2[q], sh2);
                v = (nb2 & m2) | (v & ~m2);
            }
            h[q] = v;
        }
    }
#pragma unroll
    for (int m = 0; m < NM; ++m)
        map[lane + 32 * m] = (typename W::code_t)((h[m / PK] >> (EB * (m % PK))) & W::EMASK);
}

// cnt_row[i] = tp for lower < i <= upper, inside [0, n_lanes), if tp < tl
__device__ __forceinline__ void emit_counts(int* __restrict__ cnt_row, int tp, int lower,
                                            int upper, int tl, int n_lanes) {
    if (tp >= tl) return;
    const int hi = min(upper, n_lanes - 1);
    for (int i = max(lower + 1, 0); i <= hi; ++i) cnt_row[i] = tp;
}

template <int NM, bool TWO>
__device__ __forceinline__ void walk_body(const int* __restrict__ dec,
                                          const int* __restrict__ dec2,
                                          const int* __restrict__ lo,
                                          const int* __restrict__ delta,
                                          const int* __restrict__ j_end,
                                          const int* __restrict__ t_len,
                                          int* __restrict__ path, int* __restrict__ cnt,
                                          int R, int T, int C, int n_lanes, int S) {
    using W = Walk<NM, TWO>;
    using code_t = typename W::code_t;
    constexpr int B = W::B, P = W::P;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned* words = reinterpret_cast<unsigned*>(smem);      // [2][S][P][B]
    int* pbuf = reinterpret_cast<int*>(words + (size_t)2 * S * P * B);   // [S][33]
    int* lo_buf = pbuf + S * 33;        // [2][S + 1] lo and [2][S + 1] delta of
    int* d_buf = lo_buf + 2 * (S + 1);  // each row's chunk: index i + 1 is row
    int* ent_j = d_buf + 2 * (S + 1);   // w_lo + i, index 0 the row below
    int* ent_a = ent_j + S + 1;
    int* ends = ent_a + S + 1;          // path[0], path[t_len - 1]
    code_t* maps = reinterpret_cast<code_t*>(ends + 2);      // [S][B]

    const int r = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = tid >> 5, n_warps = blockDim.x >> 5;
    const int n_words = T >> 5, n_chunks = T / C;
    const int n_seg = (n_words + S - 1) / S;
    const int tl = cnt ? min(max(t_len[r], 0), T) : 0;
    int* cnt_row = cnt ? cnt + (size_t)r * n_lanes : nullptr;

    auto load_seg = [&](int k) {
        const int w_hi = n_words - k * S;
        const int w_lo = max(w_hi - S, 0);
        constexpr int V = B / 4;                 // 16-byte pieces per row and plane
        unsigned* buf = words + (size_t)(k & 1) * S * P * B;
        for (int q = tid; q < (w_hi - w_lo) * P * V; q += blockDim.x) {
            const int rp = q / V, v = q - rp * V;
            const int* src = (TWO && (rp % P)) ? dec2 : dec;
            cp_async16(buf + (size_t)rp * B + 4 * v,
                       src + ((size_t)(w_lo + rp / P) * R + r) * B + 4 * v);
        }
        int* lo_k = lo_buf + (k & 1) * (S + 1);
        int* d_k = d_buf + (k & 1) * (S + 1);
        for (int q = tid; q <= w_hi - w_lo; q += blockDim.x) {
            const int w = w_lo - 1 + q;
            const size_t at = (size_t)r * n_chunks + (max(w, 0) << 5) / C;
            if (w >= 0) cp_async4(lo_k + q, lo + at);
            else lo_k[q] = 0;
            // the delta of a chunk's first row, 0 for the others
            if (w >= 0 && (w << 5) % C == 0) cp_async4(d_k + q, delta + at);
            else d_k[q] = 0;
        }
    };

    int j = j_end[r];                    // the stitch's state (thread 0)
    bool alive = (j >= 0 && j < B);
    load_seg(0);
    cp_async_commit();
    for (int k = 0; k < n_seg; ++k) {
        const int w_hi = n_words - k * S;
        const int w_lo = max(w_hi - S, 0);
        const int n = w_hi - w_lo;
        if (k + 1 < n_seg) load_seg(k + 1);
        cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();
        const unsigned* buf = words + (size_t)(k & 1) * S * P * B;
        const int* seg_lo = lo_buf + (k & 1) * (S + 1);
        const int* seg_d = d_buf + (k & 1) * (S + 1);

        // 1. row maps
        for (int i = warp; i < n; i += n_warps)
            row_map<NM, TWO>(buf + (size_t)i * P * B, maps + (size_t)i * B, lane);
        __syncthreads();

        // 2. stitch: the entry state of every row, top down
        if (tid == 0) {
            for (int i = n - 1; i >= 0; --i) {
                ent_j[i + 1] = j;
                ent_a[i + 1] = alive;
                if (alive) {
                    const int v = (int)maps[(size_t)i * B + j] - CODE_OFFSET;
                    if (v < -2) {            // died inside the row
                        j = v + 2;
                        alive = false;
                    } else {
                        j = v;
                    }
                }
                j += seg_d[i + 1];
                alive = alive && j >= 0 && j < B;
            }
            ent_j[0] = j;
            ent_a[0] = alive;
        }
        __syncthreads();

        // 3. re-walk every row from its entry, one thread per row; a step
        // reloads the word at the pointer, moved or not, so it has no branch
        for (int i = tid; i < n; i += blockDim.x) {
            int jj = ent_j[i + 1];
            unsigned al = ent_a[i + 1] ? ~0u : 0u;
            const int lo_c = seg_lo[i + 1];
            const unsigned* wr = buf + (size_t)i * P * B;
            // a dead pointer's j may lie anywhere: its loads are clamped into
            // the row and their bits masked off
            int js = min(max(jj, 0), B - 1);
            unsigned wd = wr[js], wd2 = 0u;
            if (TWO) wd2 = wr[B + js];
            int* pr = pbuf + i * 33;
#pragma unroll
            for (int s = 31; s >= 0; --s) {
                pr[s] = lo_c + jj;
                if (s > 0) {
                    unsigned adv = (wd >> s) & 1u;
                    if (TWO) adv += ((wd2 >> s) & 1u) << 1;
                    jj -= (int)(adv & al);
                    al &= (jj >= 0) ? ~0u : 0u;
                    js = min(max(jj, 0), B - 1);
                    wd = wr[js];
                    if (TWO) wd2 = wr[B + js];
                }
            }
        }
        __syncthreads();
        // the path out as one contiguous run, and the counts its samples cross
        const int t_lo = w_lo << 5;
        int* out = path + (size_t)r * T + t_lo;
        for (int q = tid; q < (n << 5); q += blockDim.x) {
            const int p = pbuf[(q >> 5) * 33 + (q & 31)];
            out[q] = p;
            if (cnt) {
                const int t = t_lo + q;
                if (t == 0) ends[0] = p;
                else emit_counts(cnt_row, t, q ? pbuf[((q - 1) >> 5) * 33 + ((q - 1) & 31)]
                                                : seg_lo[0] + ent_j[0], p, tl, n_lanes);
                if (t == tl - 1) ends[1] = p;
            }
        }
    }
    if (cnt) {
        __syncthreads();
        const int first = ends[0], last = ends[1];
        for (int i = tid; i < n_lanes; i += blockDim.x) {
            if (tl <= 0 || i <= first) cnt_row[i] = 0;
            else if (i > last) cnt_row[i] = tl;
        }
    }
}

template <int NM>
__global__ void __launch_bounds__(walk_threads<NM>(), 1)
backtrack_kernel(const int* __restrict__ dec, const int* __restrict__ lo,
                 const int* __restrict__ delta, const int* __restrict__ j_end,
                 const int* __restrict__ t_len, int* __restrict__ path,
                 int* __restrict__ cnt, int R, int T, int C, int n_lanes, int S) {
    walk_body<NM, false>(dec, nullptr, lo, delta, j_end, t_len, path, cnt, R, T, C,
                         n_lanes, S);
}

template <int NM>
__global__ void __launch_bounds__(walk_threads<NM>(), 1)
backtrack_skip_kernel(const int* __restrict__ dec, const int* __restrict__ dec2,
                      const int* __restrict__ lo, const int* __restrict__ delta,
                      const int* __restrict__ j_end, const int* __restrict__ t_len,
                      int* __restrict__ path, int* __restrict__ cnt, int R, int T, int C,
                      int n_lanes, int S) {
    walk_body<NM, true>(dec, dec2, lo, delta, j_end, t_len, path, cnt, R, T, C, n_lanes, S);
}

template <int NM, bool TWO>
int launch_walk(const int* dec, const int* dec2, const int* lo, const int* delta,
                const int* j_end, const int* t_len, int* path, int* cnt, int R, int T,
                int C, int n_lanes, cudaStream_t stream) {
    using W = Walk<NM, TWO>;
    const int S = W::seg_rows(T >> 5);
    const size_t bytes = W::smem_bytes(S);
    static bool attr_set = false;         // once per instantiation: the largest S
    if (!attr_set) {
        const int most = (int)W::smem_bytes(W::seg_rows(1 << 30));
        cudaError_t e = TWO
            ? cudaFuncSetAttribute(backtrack_skip_kernel<NM>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, most)
            : cudaFuncSetAttribute(backtrack_kernel<NM>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    if (TWO)
        backtrack_skip_kernel<NM><<<R, walk_threads<NM>(), bytes, stream>>>(
            dec, dec2, lo, delta, j_end, t_len, path, cnt, R, T, C, n_lanes, S);
    else
        backtrack_kernel<NM><<<R, walk_threads<NM>(), bytes, stream>>>(
            dec, lo, delta, j_end, t_len, path, cnt, R, T, C, n_lanes, S);
    return (int)cudaGetLastError();
}

template <bool TWO>
int dispatch_walk(const int* dec, const int* dec2, const int* lo, const int* delta,
                  const int* j_end, const int* t_len, int* path, int* cnt, int R, int T,
                  int C, int B, int n_lanes, void* stream) {
    if (R == 0) return 0;
    if ((C & 31) || C <= 0 || T % C || (B & 31) || B < 32 || B > 32 * MAX_NM)
        return (int)cudaErrorInvalidValue;
    if (cnt && (n_lanes < 1 || !t_len)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define NADAVCA_WALK_CASE(nm) \
    case nm: return launch_walk<nm, TWO>(dec, dec2, lo, delta, j_end, t_len, path, cnt, \
                                         R, T, C, n_lanes, st);
    switch (B >> 5) {
        NADAVCA_WALK_CASE(1) NADAVCA_WALK_CASE(2) NADAVCA_WALK_CASE(3) NADAVCA_WALK_CASE(4)
        NADAVCA_WALK_CASE(5) NADAVCA_WALK_CASE(6) NADAVCA_WALK_CASE(7) NADAVCA_WALK_CASE(8)
        NADAVCA_WALK_CASE(9) NADAVCA_WALK_CASE(10) NADAVCA_WALK_CASE(11) NADAVCA_WALK_CASE(12)
        NADAVCA_WALK_CASE(13) NADAVCA_WALK_CASE(14) NADAVCA_WALK_CASE(15) NADAVCA_WALK_CASE(16)
        NADAVCA_WALK_CASE(17) NADAVCA_WALK_CASE(18) NADAVCA_WALK_CASE(19) NADAVCA_WALK_CASE(20)
        NADAVCA_WALK_CASE(21) NADAVCA_WALK_CASE(22) NADAVCA_WALK_CASE(23) NADAVCA_WALK_CASE(24)
        NADAVCA_WALK_CASE(25) NADAVCA_WALK_CASE(26) NADAVCA_WALK_CASE(27) NADAVCA_WALK_CASE(28)
        NADAVCA_WALK_CASE(29) NADAVCA_WALK_CASE(30) NADAVCA_WALK_CASE(31) NADAVCA_WALK_CASE(32)
    }
#undef NADAVCA_WALK_CASE
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// t_len and cnt may be null: the walk without counts.
NADAVCA_EXPORT int nadavca_backtrack(const int* dec, const int* lo, const int* delta,
                                     const int* j_end, const int* t_len, int* path,
                                     int* cnt, int R, int T, int C, int B, int n_lanes,
                                     void* stream) {
    return dispatch_walk<false>(dec, nullptr, lo, delta, j_end, t_len, path, cnt, R, T, C,
                                B, n_lanes, stream);
}

NADAVCA_EXPORT int nadavca_backtrack_skip(const int* dec, const int* dec2, const int* lo,
                                          const int* delta, const int* j_end,
                                          const int* t_len, int* path, int* cnt, int R,
                                          int T, int C, int B, int n_lanes, void* stream) {
    return dispatch_walk<true>(dec, dec2, lo, delta, j_end, t_len, path, cnt, R, T, C, B,
                               n_lanes, stream);
}
