// rescore: the restricted local re-DP of the SNP rescore, two entry points.
//
// For every (read r, window position i) and candidate base b, a small Viterbi
// over the K k-mer slots that contain base i, run on the W[r, i] samples the
// global path gave to those slots, from sample S[r, i] on:
//
//   v0[j][b]  = em - d0 * d0 * iv   for j == 0, NEG_INF otherwise   (step 0 is
//                                    taken whatever W is)
//   s = 1 .. W-1:  emit = em - d * d * iv,  d = x[S + s] - mu
//                  v[j][b] = emit + max(v[j][b] + log_p_stay,
//                                       v[j-1][b] + log_p_move)   (v[-1] = NEG_INF)
//   out[b] = v[kk-1][b] - v[kk-1][codes]       (0 where kk-1 is outside [0, K))
//
// Both entry points are one tile kernel (rescore_tile), and differ only in
// where a position's constants come from and which masks apply:
//
//   rescore_local_tab_kernel  replaces nadavca_tpu/ops/pallas_rescore.py:218
//     (_rescore_tab_kernel, launched by rescore_fill_tab_pallas :326) together
//     with the shear gather before it (:627, shear_gather_pallas :568) and the
//     tensor code of the tables branch of base_loglik_local_pallas around
//     them (:425-480): the constants come from the genome table.
//   rescore_local_kernel  replaces :191 (_rescore_kernel, launched by
//     rescore_fill_pallas :280) together with the same shear gather and the
//     tensor code of the no-tables branch (:483-517, 530-541): the constants
//     of slot j and base b are the substituted k-mer's, gathered from three
//     per-k-mer vectors the wrapper makes once per call; a window clipped by
//     the read's ends (kk < K) is scored on its kk live slots, and every live
//     slot must hold a real k-mer (ids >= 0). The port's first design took
//     one thread per (read, position) and read the shear gather's
//     (t_w, R, L) samples at stride R * L (201 MB at the main shape) and
//     (K*4, R, L) constants built in tensor code.
//
// Either kernel: one block of four warps per (read r, tile of 128 positions).
// In order:
//   prologue  one thread per position: its window from the walk's segment
//             counts cnt and the path's two ends, as the TPU's tensor code
//             writes it:
//             S = cnt[clip(i-k+1, 0, N-1)], E = cnt[clip(i, 0, N-1) + 1],
//             W = clip(E - S, 0, t_w), S_c = clip(S, 0, T-1),
//             p_lo = max(clip(i-k+1, 0, N-1), path[0]),
//             p_hi = min(clip(i, 0, N-1), path[t_len-1]), kk = p_hi - p_lo + 1;
//   slab      from T = 2304 on (the slab rule): the tile's base is the block
//             minimum of S_c, clipped to [0, T - 2304] and floored to 128
//             (shear_slab_base, :560), and one thread copies x[r, base :
//             base + 2304) into shared memory with one TMA bulk copy
//             (cp.async.bulk, completion on an mbarrier; 9.2 KB) while the
//             others mask and order the positions. A position whose S_c - base
//             leaves [0, 2048) is masked (the span mask, :452-460). Below
//             T = 2304 there is no slab rule: the whole row is staged, its
//             last sample repeated t_w times beyond its end, which is the
//             clamp of sample indices to T - 1.
//   masks     a real base, W > 0 after the span mask, and with tables kk == k
//             and the table's validity, without them a real k-mer at each
//             live slot; a masked position's window counts as empty;
//   order     the positions ranked by falling window length (ties by
//             position, in shared memory), so that the masked ones come last;
//   DP        four threads per position, one per candidate base (a thread
//             holds 3 * K constants and K states; without tables it makes
//             them from K ids and three per-k-mer vectors: 48 KB at K = 6, in
//             L1; 3 MB at K = 9, in L2): each warp takes groups of
//             8 positions of consecutive rank in snake order (warp w: groups
//             w, 7 - w, 8 + w, 15 - w), so a warp's 8 windows are alike and
//             the four warps' work is balanced; rescore_body on slab +
//             (S_c - base), for the positions not masked;
//   epilogue  the reference base's value by a shuffle among the four
//             threads, and the (R, L, 4) result stored in place: four
//             threads write a position's 16 bytes, 0 where masked.
// Four warps share a tile's work, and not sixteen warps of 8 positions each,
// because an SM frees a block's slots only when its last warp is done: a
// block whose one warp ran a 192-sample window and fifteen ran 60 held the
// slots of sixteen warps for the longest window.
// The TPU's shear gather made the samples of every position a row of a
// (t_w, R, L) array (201 MB at the main shape) for the DP to read back; here
// the samples a tile needs come in once, as the slab rule has them, and no
// tensor code runs between the walk and this kernel.
//
// Bound: operations for long windows, bytes for short ones: 8 operations per
// cell (K * 4 cells) and live sample of each position, against x read once
// per slab, the counts, codes, table columns and validity (or the ids and
// the per-k-mer vectors) read once, and the output written once. NEG_INF is the finite -1e30: dead slots sink by
// another -1e30 per step and never reach an infinity.
//
// Built with -fmad=false: the expression order above is that of the plain
// PyTorch version, so both round alike (see common.cuh).

#include "common.cuh"

#include <type_traits>

// The DP of one position for one candidate base (a thread's): the samples
// are xp[0], xp[1], ...; returns the value of slot kk1 (0 where kk1 is
// outside [0, K)).
template <int K>
__device__ __forceinline__ float rescore_body(const float* __restrict__ xp,
                                              const float (&em)[K], const float (&mu)[K],
                                              const float (&iv)[K], int w, int kk1,
                                              float log_p_stay, float log_p_move) {
    float v[K];
    const float x0 = xp[0];
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const float d0 = x0 - mu[j];
        const float emit0 = em[j] - d0 * d0 * iv[j];
        v[j] = (j == 0) ? emit0 : NADAVCA_NEG_INF;
    }
    for (int s = 1; s < w; ++s) {
        const float x = xp[s];
        // slots from the top down, so v[j-1] is still the previous step's
#pragma unroll
        for (int j = K - 1; j >= 0; --j) {
            const float d = x - mu[j];
            const float emit = em[j] - d * d * iv[j];
            const float stay = v[j] + log_p_stay;
            const float below = (j > 0) ? v[j > 0 ? j - 1 : 0] : NADAVCA_NEG_INF;
            const float move = below + log_p_move;
            v[j] = emit + fmaxf(stay, move);
        }
    }
    float o = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (kk1 == j) o = v[j];
    }
    return o;
}

namespace {

constexpr int LT = 128;                 // positions per tile (the slab rule)
constexpr int SPAN = 2048;              // window starts a tile's slab holds
constexpr int SLAB = SPAN + 256;        // samples of a slab; the rule needs T >= SLAB
constexpr int MAX_TW = 256;             // longest window: a slab holds SPAN + t_w
constexpr int LOCAL_THREADS = LT;       // the prologue: one thread per position
constexpr int LOCAL_WARPS = LOCAL_THREADS / 32;
constexpr int GROUP = 8;                // positions of a warp in the DP, 4 threads each
constexpr int GROUPS = LT / GROUP;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

}  // namespace

// Where a position's constants come from. Tables: the genome's substitution
// table (3, K*4, rows_p), row j*4 + b, column woff[r] + i, with its validity.
struct TableSource {
    const int* __restrict__ woff;
    const float* __restrict__ tab;
    const unsigned char* __restrict__ valid;
    int rows_p;
};

// Without tables: the window's k-mer ids (R, N), and per k-mer id the
// emission constant -log(sigma) - log(2 pi) / 2, the mean and 0.5 / sigma^2
// (n_kmers each), made once per call by the wrapper with the plain version's
// own tensor expressions: the kernel only gathers them, so its floats are
// the plain version's.
struct KmerSource {
    const int* __restrict__ ids;
    const float* __restrict__ em;
    const float* __restrict__ mu;
    const float* __restrict__ iv;
    int n_kmers;
};

// The K constants of slot j, base b of the position i (p_lo, kk, reference
// code) without tables, as batch_constants writes them: p = p_lo + j,
// ids_p = ids[clip(p, 0, N-1)], nid = clip(ids_p + (b - code) * 4^(K-1-(i-p)),
// 0, n_kmers - 1) with the weight 0 where i - p leaves [0, K); em is NEG_INF
// at a dead slot (j >= kk or ids_p < 0).
template <int K>
__device__ __forceinline__ void kmer_constants(const KmerSource& src, const int* ids_r,
                                               int N, int i, int p_lo, int kk, int code,
                                               int b, float (&em)[K], float (&mu)[K],
                                               float (&iv)[K]) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const int p = p_lo + j;
        const int ids_p = ids_r[min(max(p, 0), N - 1)];
        const int off = i - p;
        const int w4 = (off >= 0 && off < K) ? 1 << (2 * (K - 1 - off)) : 0;
        const int nid = min(max(ids_p + (b - code) * w4, 0), src.n_kmers - 1);
        mu[j] = src.mu[nid];
        iv[j] = src.iv[nid];
        em[j] = (j < kk && ids_p >= 0) ? src.em[nid] : NADAVCA_NEG_INF;
    }
}

// One (read, tile of 128 positions) of the local rescore, from the walk's
// counts to the masked (R, L, 4) result (see the top of this file); SRC says
// where the constants come from and which masks apply.
template <int K, typename SRC>
__device__ __forceinline__ void rescore_tile(const float* __restrict__ x,
                                             const int* __restrict__ cnt,
                                             const int* __restrict__ path,
                                             const int* __restrict__ t_len,
                                             const int* __restrict__ codes, const SRC& src,
                                             float* __restrict__ out, int T, int L, int N,
                                             int n_lanes, int t_w, float log_p_stay,
                                             float log_p_move) {
    constexpr bool TAB = std::is_same<SRC, TableSource>::value;
    // the staged samples: a slab, or the whole row and its repeated last sample
    __shared__ __align__(128) float slab[SLAB + MAX_TW];
    __shared__ __align__(8) unsigned long long bar;
    __shared__ int red[LOCAL_WARPS];
    __shared__ int base_s;
    // per position of the tile: slab offset, window length (0: masked), base
    // code, table column (without tables: the first k-mer position p_lo), live
    // slots; the positions by falling window length
    __shared__ int s_off[LT], s_w[LT], s_code[LT], s_col[LT], s_kk[LT], s_perm[LT];

    const int r = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int i0 = blockIdx.x * LT;
    const bool rule = T >= SLAB;
    const float* __restrict__ xr = x + (size_t)r * T;
    // the slab's source is 16-byte aligned (its base is a multiple of 128)
    // when the row is: then one bulk copy, else the threads copy it
    const bool bulk = rule && ((reinterpret_cast<size_t>(xr) & 15) == 0);
    if (tid == 0 && bulk) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bar))
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }

    // ---- prologue: the window of position i = i0 + tid
    const int i = i0 + tid;
    const int* __restrict__ cnt_r = cnt + (size_t)r * n_lanes;
    const int ic = min(max(i - K + 1, 0), N - 1);
    const int ie = min(max(i, 0), N - 1);
    const int S = cnt_r[ic];
    int W = min(max(cnt_r[ie + 1] - S, 0), t_w);
    const int S_c = min(max(S, 0), T - 1);
    const int first_pos = path[(size_t)r * T];
    const int last_pos = path[(size_t)r * T + min(max(t_len[r] - 1, 0), T - 1)];
    const int p_lo = max(ic, first_pos);
    const int kk = min(ie, last_pos) - p_lo + 1;
    const int code = codes[(size_t)r * L + i];

    // ---- the tile's slab base: the block minimum of S_c
    int m = __reduce_min_sync(0xffffffffu, S_c);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (tid == 0) {
        for (int q = 1; q < LOCAL_WARPS; ++q) m = min(m, red[q]);
        const int base = rule ? (min(max(m, 0), T - SLAB) / LT) * LT : 0;
        base_s = base;
        if (bulk) {
            const unsigned bytes = SLAB * sizeof(float);
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                         :: "r"(smem_addr(&bar)), "r"(bytes) : "memory");
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1], %2, [%3];"
                :: "r"(smem_addr(slab)), "l"(xr + base), "r"(bytes), "r"(smem_addr(&bar))
                : "memory");
        }
    }
    __syncthreads();
    const int base = base_s;
    if (!bulk) {
        const int n = rule ? SLAB : T;
        for (int q = tid; q < n; q += LOCAL_THREADS) slab[q] = xr[base + q];
        if (!rule)
            for (int q = tid; q < t_w; q += LOCAL_THREADS) slab[T + q] = xr[T - 1];
    }

    // ---- masks, then the positions by falling window length (ties by
    // position): warps of like windows, and the masked ones last. With
    // tables a window clipped by the read's ends (kk < K) is masked and the
    // genome's validity applies; without, such a window is scored on its kk
    // live slots, and a live slot must hold a real k-mer (ids >= 0).
    const int off = S_c - base;
    if (rule && !(off >= 0 && off < SPAN)) W = 0;           // the span mask
    bool ok = kk > 0 && code < 4 && W > 0;
    int col;
    if constexpr (TAB) {
        col = src.woff[r] + i;
        ok = ok && kk == K && src.valid[col] != 0;
    } else {
        col = p_lo;
        const int* __restrict__ ids_r = src.ids + (size_t)r * N;
#pragma unroll
        for (int j = 0; j < K; ++j)
            ok = ok && (j >= kk || ids_r[min(max(p_lo + j, 0), N - 1)] >= 0);
    }
    const int w_ok = ok ? W : 0;
    s_off[tid] = off;
    s_w[tid] = w_ok;
    s_code[tid] = code;
    s_col[tid] = col;
    s_kk[tid] = kk;
    __syncthreads();
    int rank = 0;
    for (int q = 0; q < LT; ++q) {
        const int wq = s_w[q];
        rank += (wq > w_ok) || (wq == w_ok && q < tid);
    }
    s_perm[rank] = tid;
    __syncthreads();
    if (bulk) {
        // wait for the slab: phase 0 of the barrier completes with its bytes
        unsigned done = 0;
        while (!done) {
            asm volatile(
                "{\n.reg .pred p;\n"
                "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                "selp.u32 %0, 1, 0, p;\n}"
                : "=r"(done) : "r"(smem_addr(&bar)), "r"(0) : "memory");
        }
    }

    // ---- the DP: a warp takes groups of 8 positions in snake order over
    // the ranks (warp w: w, 7 - w, 8 + w, 15 - w), four threads a position,
    // one a base; the reference base's value by a shuffle among the four,
    // every mask, the (R, L, 4) result stored in place
    const int b = lane & 3;
    for (int it = 0; it < GROUPS / LOCAL_WARPS; ++it) {
        const int g = (it & 1) ? (it + 1) * LOCAL_WARPS - 1 - warp : it * LOCAL_WARPS + warp;
        const int p = s_perm[g * GROUP + (lane >> 2)];
        const int w = s_w[p];
        float o = 0.0f;
        if (w > 0) {
            float em[K], mu[K], iv[K];
            if constexpr (TAB) {
                const size_t plane = (size_t)K * 4 * src.rows_p;
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    const size_t at = (size_t)(j * 4 + b) * src.rows_p + s_col[p];
                    em[j] = src.tab[at];
                    mu[j] = src.tab[plane + at];
                    iv[j] = src.tab[2 * plane + at];
                }
            } else {
                kmer_constants<K>(src, src.ids + (size_t)r * N, N, i0 + p, s_col[p],
                                  s_kk[p], s_code[p], b, em, mu, iv);
            }
            // with tables kk == K at every position computed: its last slot
            o = rescore_body<K>(slab + s_off[p], em, mu, iv, w, TAB ? K - 1 : s_kk[p] - 1,
                                log_p_stay, log_p_move);
        }
        const int cod = min(max(s_code[p], 0), 3);
        const float ref = __shfl_sync(0xffffffffu, o, (lane & ~3) | cod);
        out[((size_t)r * L + i0 + p) * 4 + b] = w > 0 ? o - ref : 0.0f;
    }
}

template <int K>
__global__ void __launch_bounds__(LOCAL_THREADS, 8)
rescore_local_tab_kernel(const float* __restrict__ x, const int* __restrict__ cnt,
                         const int* __restrict__ path, const int* __restrict__ t_len,
                         const int* __restrict__ codes, TableSource src,
                         float* __restrict__ out, int T, int L, int N, int n_lanes,
                         int t_w, float log_p_stay, float log_p_move) {
    rescore_tile<K>(x, cnt, path, t_len, codes, src, out, T, L, N, n_lanes, t_w,
                    log_p_stay, log_p_move);
}

template <int K>
__global__ void __launch_bounds__(LOCAL_THREADS, 8)
rescore_local_kernel(const float* __restrict__ x, const int* __restrict__ cnt,
                     const int* __restrict__ path, const int* __restrict__ t_len,
                     const int* __restrict__ codes, KmerSource src,
                     float* __restrict__ out, int T, int L, int N, int n_lanes, int t_w,
                     float log_p_stay, float log_p_move) {
    rescore_tile<K>(x, cnt, path, t_len, codes, src, out, T, L, N, n_lanes, t_w,
                    log_p_stay, log_p_move);
}

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
        case 9: LAUNCH(9); break;                   \
        default: return (int)cudaErrorInvalidValue; \
    }

static bool local_shape_ok(int T, int L, int N, int n_lanes, int t_w) {
    return !(L % LT || T < 1 || N < 1 || n_lanes < N + 1 || t_w < 1 || t_w > MAX_TW);
}

// x (R, T); cnt (R, n_lanes) the walk's segment counts; path (R, T) and t_len
// (R,) for the path's two ends; codes (R, L) the window's bases (4 = pad), L
// a multiple of 128; woff (R,) the table column of each read's position 0;
// tab (3, k*4, rows_p); valid (rows_p,) bytes. out (R, L, 4).
NADAVCA_EXPORT int nadavca_rescore_local_tab(const float* x, const int* cnt,
                                             const int* path, const int* t_len,
                                             const int* codes, const int* woff,
                                             const float* tab, const unsigned char* valid,
                                             float* out, int R, int T, int L, int N,
                                             int n_lanes, int t_w, int k, int rows_p,
                                             float log_p_stay, float log_p_move,
                                             void* stream) {
    if (R == 0 || L == 0) return 0;
    if (!local_shape_ok(T, L, N, n_lanes, t_w)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(L / LT), (unsigned)R);
    const TableSource src{woff, tab, valid, rows_p};
#define LAUNCH_LOCAL(KV)                                                          \
    rescore_local_tab_kernel<KV><<<grid, LOCAL_THREADS, 0, (cudaStream_t)stream>>>( \
        x, cnt, path, t_len, codes, src, out, T, L, N, n_lanes, t_w, log_p_stay,    \
        log_p_move)
    RESCORE_DISPATCH(LAUNCH_LOCAL)
#undef LAUNCH_LOCAL
    return (int)cudaGetLastError();
}

// The same without genome tables: ids (R, N) the window's k-mer ids (-1 for
// none); em, mu, iv (n_kmers,) the per-k-mer constants. out (R, L, 4).
NADAVCA_EXPORT int nadavca_rescore_local(const float* x, const int* cnt, const int* path,
                                         const int* t_len, const int* codes,
                                         const int* ids, const float* em, const float* mu,
                                         const float* iv, float* out, int R, int T, int L,
                                         int N, int n_lanes, int t_w, int k, int n_kmers,
                                         float log_p_stay, float log_p_move,
                                         void* stream) {
    if (R == 0 || L == 0) return 0;
    if (!local_shape_ok(T, L, N, n_lanes, t_w) || n_kmers < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(L / LT), (unsigned)R);
    const KmerSource src{ids, em, mu, iv, n_kmers};
#define LAUNCH_LOCAL(KV)                                                      \
    rescore_local_kernel<KV><<<grid, LOCAL_THREADS, 0, (cudaStream_t)stream>>>( \
        x, cnt, path, t_len, codes, src, out, T, L, N, n_lanes, t_w, log_p_stay, \
        log_p_move)
    RESCORE_DISPATCH(LAUNCH_LOCAL)
#undef LAUNCH_LOCAL
    return (int)cudaGetLastError();
}
