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
// Both entry points share rescore_body, which reads the samples of a
// position through a pointer and a stride:
//
//   rescore_local_tab_kernel  replaces nadavca_tpu/ops/pallas_rescore.py:218
//     (_rescore_tab_kernel, launched by rescore_fill_tab_pallas :326) together
//     with the shear gather before it (:627, shear_gather_pallas :568) and the
//     tensor code of the tables branch of base_loglik_local_pallas around
//     them (:425-480): the constants come from the genome table, the samples
//     from a slab of x in shared memory, stride 1.
//   rescore_kernel  replaces :191 (_rescore_kernel, launched by
//     rescore_fill_pallas :280): constants per batch as (K*4, R, L) arrays,
//     samples from the shear gather's xs (t_w, R, L), stride R * L.
//
// rescore_local_tab_kernel: one block of four warps per (read r, tile of 128
// positions). In order:
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
//   masks     a real base, kk == k, the table's validity, W > 0 after the
//             span mask; a masked position's window counts as empty;
//   order     the positions ranked by falling window length (ties by
//             position, in shared memory), so that the masked ones come last;
//   DP        four threads per position, one per candidate base (a thread
//             holds 3 * K constants and K states): each warp takes groups of
//             8 positions of consecutive rank in snake order (warp w: groups
//             w, 7 - w, 8 + w, 15 - w), so a warp's 8 windows are alike and
//             the four warps' work is balanced; rescore_body on slab +
//             (S_c - base), stride 1, for the positions not masked;
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
// per slab, the counts, codes, table columns and validity read once, and the
// output written once. NEG_INF is the finite -1e30: dead slots sink by
// another -1e30 per step and never reach an infinity.
//
// Built with -fmad=false: the expression order above is that of the plain
// PyTorch version, so both round alike (see common.cuh).

#include "common.cuh"

// The DP of one position for NB candidate bases (4, or the one base of a
// thread): the samples are xp[0], xp[stride], ...; returns in o[b] the value
// of slot kk1 (0 where kk1 is outside [0, K)).
template <int K, int NB>
__device__ __forceinline__ void rescore_body(
        const float* __restrict__ xp, size_t stride,
        const float (&em)[K][NB], const float (&mu)[K][NB], const float (&iv)[K][NB],
        int w, int kk1, float log_p_stay, float log_p_move, float (&o)[NB]) {
    float v[K][NB];
    const float x0 = xp[0];
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const float d0 = x0 - mu[j][b];
            const float emit0 = em[j][b] - d0 * d0 * iv[j][b];
            v[j][b] = (j == 0) ? emit0 : NADAVCA_NEG_INF;
        }
    }
    for (int s = 1; s < w; ++s) {
        const float x = xp[(size_t)s * stride];
        // slots from the top down, so v[j-1] is still the previous step's
#pragma unroll
        for (int j = K - 1; j >= 0; --j) {
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                const float d = x - mu[j][b];
                const float emit = em[j][b] - d * d * iv[j][b];
                const float stay = v[j][b] + log_p_stay;
                const float below = (j > 0) ? v[j > 0 ? j - 1 : 0][b] : NADAVCA_NEG_INF;
                const float move = below + log_p_move;
                v[j][b] = emit + fmaxf(stay, move);
            }
        }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) o[b] = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (kk1 == j) {
#pragma unroll
            for (int b = 0; b < NB; ++b) o[b] = v[j][b];
        }
    }
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

template <int K>
__global__ void __launch_bounds__(LOCAL_THREADS, 8)
rescore_local_tab_kernel(const float* __restrict__ x, const int* __restrict__ cnt,
                         const int* __restrict__ path, const int* __restrict__ t_len,
                         const int* __restrict__ codes, const int* __restrict__ woff,
                         const float* __restrict__ tab,
                         const unsigned char* __restrict__ valid,
                         float* __restrict__ out, int T, int L, int N, int n_lanes,
                         int t_w, int rows_p, float log_p_stay, float log_p_move) {
    // the staged samples: a slab, or the whole row and its repeated last sample
    __shared__ __align__(128) float slab[SLAB + MAX_TW];
    __shared__ __align__(8) unsigned long long bar;
    __shared__ int red[LOCAL_WARPS];
    __shared__ int base_s;
    // per position of the tile: slab offset, window length (0: masked), base
    // code, table column; the positions by falling window length
    __shared__ int s_off[LT], s_w[LT], s_code[LT], s_col[LT], s_perm[LT];

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
    const int kk = min(ie, last_pos) - max(ic, first_pos) + 1;
    const int code = codes[(size_t)r * L + i];
    const int col = woff[r] + i;

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
    // position): warps of like windows, and the masked ones last
    const int off = S_c - base;
    if (rule && !(off >= 0 && off < SPAN)) W = 0;           // the span mask
    const bool ok = kk > 0 && code < 4 && kk == K && valid[col] != 0 && W > 0;
    const int w_ok = ok ? W : 0;
    s_off[tid] = off;
    s_w[tid] = w_ok;
    s_code[tid] = code;
    s_col[tid] = col;
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
    const size_t plane = (size_t)K * 4 * rows_p;
    for (int it = 0; it < GROUPS / LOCAL_WARPS; ++it) {
        const int g = (it & 1) ? (it + 1) * LOCAL_WARPS - 1 - warp : it * LOCAL_WARPS + warp;
        const int p = s_perm[g * GROUP + (lane >> 2)];
        const int w = s_w[p];
        float o[1] = {0.0f};
        if (w > 0) {
            float em[K][1], mu[K][1], iv[K][1];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const size_t at = (size_t)(j * 4 + b) * rows_p + s_col[p];
                em[j][0] = tab[at];
                mu[j][0] = tab[plane + at];
                iv[j][0] = tab[2 * plane + at];
            }
            // kk == K at every position computed: its last slot
            rescore_body<K, 1>(slab + s_off[p], 1, em, mu, iv, w, K - 1, log_p_stay,
                               log_p_move, o);
        }
        const int cod = min(max(s_code[p], 0), 3);
        const float ref = __shfl_sync(0xffffffffu, o[0], (lane & ~3) | cod);
        out[((size_t)r * L + i0 + p) * 4 + b] = w > 0 ? o[0] - ref : 0.0f;
    }
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
    float o[4];
    rescore_body<K, 4>(xs + idx, rl, em, mu, iv, min(w[idx], t_w), kk[idx] - 1,
                       log_p_stay, log_p_move, o);
    const int cod = codes[idx];
    float ref = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        if (cod == b) ref = o[b];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) out[(size_t)b * rl + idx] = o[b] - ref;
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
    if (L % LT || T < 1 || N < 1 || n_lanes < N + 1 || t_w < 1 || t_w > MAX_TW)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(L / LT), (unsigned)R);
#define LAUNCH_LOCAL(KV)                                                          \
    rescore_local_tab_kernel<KV><<<grid, LOCAL_THREADS, 0, (cudaStream_t)stream>>>( \
        x, cnt, path, t_len, codes, woff, tab, valid, out, T, L, N, n_lanes, t_w,   \
        rows_p, log_p_stay, log_p_move)
    RESCORE_DISPATCH(LAUNCH_LOCAL)
#undef LAUNCH_LOCAL
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
