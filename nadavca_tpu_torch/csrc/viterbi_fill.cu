// viterbi_fill: banded Viterbi fill with a per-chunk band and per-chunk
// renormalisation, one packed decision bit per (sample, band slot).
//
// Replaces the TPU kernel nadavca_tpu/ops/pallas_dp.py:188 (_fill_kernel,
// launched by viterbi_fill_pallas :357), no-skip single-step body.
//
//   V[t, j] = e(t, j) + max(V[t-1, j] + log_p_stay, V[t-1, j-1] + log_p_move)
//
// with the stay transition folded into the emission constant and the compare
// done on the transition difference, exactly as the TPU kernel writes it:
//   emit = (c2p * x + c1p) * x + c0p,  mv = V[j-1] + (log_p_move - log_p_stay),
//   bit = mv > V[j] (strict: a tie stays),  V' = emit + max(V[j], mv).
// t = 0 is a free start (emit - log_p_stay, bit 0); samples t >= t_len are
// identity steps with bit 0; slots with lo + j >= n_ref carry NEG_INF in their
// emission constant. At a chunk boundary the carried row moves to the new band
// start (V'[j] = V[j + delta], NEG_INF shifted in); at a chunk end the row
// maximum moves into acc (only if the row has a live cell).
//
// Layout: one block per read, one thread per band slot. The TPU's sequential
// chunk axis of the grid is the outer loop of the block, its in-chunk loop the
// inner one. Slot j needs slot j-1 of the previous step, so the row goes
// through shared memory, double-buffered so that one __syncthreads() per step
// is enough. Each thread packs its own 32 decision bits and stores one word,
// which gives the (T/32, R, B) layout with coalesced stores.
//
// Bound: operations, or rather their latency. The recurrence is a serial chain
// of T steps for each read; a step is a shared-memory round trip, a barrier
// and six dependent float operations, and only R blocks of B threads exist to
// hide it. The bytes (x once, the band levels once, R*T*B/8 bytes of decision
// words) are far below what the memory system moves in that time. Chunks that
// lie wholly beyond a read's end skip the step loop and store zero words.
//
// The skip variant (viterbi_fill_skip_kernel) replaces the use_skip branch of
// the same TPU kernel (pallas_dp.py:293-305, 313, 323-337): a third candidate
// V[t-1, j-2] + log_p_skip and a second plane of decision words,
//   emit = em_const - (x - mu)^2 * inv2v        (no polynomial, nothing folded)
//   stay = V[j] + log_p_stay,  move = V[j-1] + log_p_move,  bit = move > stay,
//   skip = V[j-2] + log_p_skip,  bit2 = skip > max(stay, move),  bit &= !bit2,
//   V' = emit + max(stay, move, skip);  free start: emit itself.
// The strict compares make stay beat move beat skip on ties. NEG_INF and the
// default log_p_skip are both the finite -1e30; their sums stay finite in
// float32 because nothing clamps them, so the operation order is the TPU's.
// Slot j takes slots j-1 and j-2 of the previous step out of the same
// shared-memory row after the one barrier of the step. Both variants are one
// body, specialised at compile time: the step loop without skip holds no
// branch on the variant and is the program it was before the skip existed.
//
// Built with -fmad=false: see common.cuh.

#include "common.cuh"

// p1, p2: without skip (log_p_move - log_p_stay, unused); with skip
// (log_p_move, log_p_skip). dec2 is the second plane, with skip only.
template <bool SKIP>
__device__ __forceinline__ void fill_body(const float* __restrict__ x,
                                          const int* __restrict__ t_len,
                                          const float* __restrict__ mu_b,
                                          const float* __restrict__ sg_b,
                                          const int* __restrict__ lo,
                                          const int* __restrict__ delta,
                                          const int* __restrict__ n_ref,
                                          int* __restrict__ dec,
                                          int* __restrict__ dec2,
                                          float* __restrict__ v_out,
                                          float* __restrict__ acc_out,
                                          int R, int T, int C, int B,
                                          float log_p_stay, float p1, float p2) {
    extern __shared__ float smem[];
    float* vbuf0 = smem;            // B
    float* vbuf1 = smem + B;        // B
    float* xs = smem + 2 * B;       // C
    float* red = xs + C;            // 32

    const int r = blockIdx.x;
    const int j = threadIdx.x;
    const int n_warps = B >> 5;
    const int n_chunks = T / C;
    const int wpc = C >> 5;         // decision words per chunk
    const int tl = t_len[r];
    const int nr = n_ref[r];

    float v = NADAVCA_NEG_INF;
    float acc = 0.0f;

    for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * C;
        if (c > 0) {
            // realign the carried row to the new band start
            const int d = delta[(size_t)r * n_chunks + c];
            vbuf0[j] = v;
            __syncthreads();
            const int src = j + d;
            v = (src >= 0 && src < B) ? vbuf0[src] : NADAVCA_NEG_INF;
            __syncthreads();
        }
        int n_act = tl - t0;
        if (n_act > C) n_act = C;
        const size_t dec_off = ((size_t)(t0 >> 5) * R + r) * B + j;
        int* dec_c = dec + dec_off;
        int* dec2_c = SKIP ? dec2 + dec_off : nullptr;
        const size_t word_stride = (size_t)R * B;
        int words_done = 0;

        if (n_act > 0) {
            for (int i = j; i < C; i += B) xs[i] = x[(size_t)r * T + t0 + i];
            const size_t bi = ((size_t)c * R + r) * B + j;
            const float mu = mu_b[bi];
            const float sg = sg_b[bi];
            const int lo_c = lo[(size_t)r * n_chunks + c];
            const float em_const = (lo_c + j < nr)
                ? (-logf(sg) - NADAVCA_HALF_LOG_2PI) : NADAVCA_NEG_INF;
            const float inv2v = 0.5f / (sg * sg);
            const float c2p = -inv2v;
            const float c1p = (mu + mu) * inv2v;
            const float c0p = (em_const - (mu * mu) * inv2v) + log_p_stay;
            __syncthreads();

            unsigned pack = 0u, pack2 = 0u;
            for (int s = 0; s < n_act; ++s) {
                float* buf = (s & 1) ? vbuf1 : vbuf0;
                buf[j] = v;
                __syncthreads();
                const float vm1 = (j > 0) ? buf[j - 1] : NADAVCA_NEG_INF;
                const float xv = xs[s];
                if (SKIP) {
                    const float vm2 = (j > 1) ? buf[j - 2] : NADAVCA_NEG_INF;
                    const float diff = xv - mu;
                    const float emit = em_const - (diff * diff) * inv2v;
                    if (t0 + s == 0) {
                        v = emit;
                    } else {
                        const float stay = v + log_p_stay;
                        const float move = vm1 + p1;
                        const float best = fmaxf(stay, move);
                        const float skip = vm2 + p2;
                        const bool bit2 = skip > best;
                        if (move > stay && !bit2) pack |= 1u << (s & 31);
                        if (bit2) pack2 |= 1u << (s & 31);
                        v = emit + fmaxf(best, skip);
                    }
                } else {
                    const float emit = (c2p * xv + c1p) * xv + c0p;
                    const float mv = vm1 + p1;
                    if (t0 + s == 0) {
                        v = emit - log_p_stay;
                    } else {
                        if (mv > v) pack |= 1u << (s & 31);
                        v = emit + fmaxf(v, mv);
                    }
                }
                if ((s & 31) == 31) {
                    dec_c[(size_t)words_done * word_stride] = (int)pack;
                    if (SKIP) dec2_c[(size_t)words_done * word_stride] = (int)pack2;
                    ++words_done;
                    pack = 0u;
                    pack2 = 0u;
                }
            }
            if (n_act & 31) {
                dec_c[(size_t)words_done * word_stride] = (int)pack;
                if (SKIP) dec2_c[(size_t)words_done * word_stride] = (int)pack2;
                ++words_done;
            }
        }
        for (int w = words_done; w < wpc; ++w) {
            dec_c[(size_t)w * word_stride] = 0;
            if (SKIP) dec2_c[(size_t)w * word_stride] = 0;
        }

        // chunk-end renormalisation into the accumulator
        float m = block_max(v, red, j, n_warps);
        m = (m > NADAVCA_NEG_INF_HALF) ? m : 0.0f;
        v = v - m;
        acc = acc + m;
        __syncthreads();   // red[] is free again, xs[] may be overwritten
    }
    v_out[(size_t)r * B + j] = v;
    if (j == 0) acc_out[r] = acc;
}

__global__ void viterbi_fill_kernel(const float* __restrict__ x,
                                    const int* __restrict__ t_len,
                                    const float* __restrict__ mu_b,
                                    const float* __restrict__ sg_b,
                                    const int* __restrict__ lo,
                                    const int* __restrict__ delta,
                                    const int* __restrict__ n_ref,
                                    int* __restrict__ dec,
                                    float* __restrict__ v_out,
                                    float* __restrict__ acc_out,
                                    int R, int T, int C, int B,
                                    float log_p_stay, float dcs) {
    fill_body<false>(x, t_len, mu_b, sg_b, lo, delta, n_ref, dec, nullptr, v_out,
                     acc_out, R, T, C, B, log_p_stay, dcs, 0.0f);
}

__global__ void viterbi_fill_skip_kernel(const float* __restrict__ x,
                                         const int* __restrict__ t_len,
                                         const float* __restrict__ mu_b,
                                         const float* __restrict__ sg_b,
                                         const int* __restrict__ lo,
                                         const int* __restrict__ delta,
                                         const int* __restrict__ n_ref,
                                         int* __restrict__ dec,
                                         int* __restrict__ dec2,
                                         float* __restrict__ v_out,
                                         float* __restrict__ acc_out,
                                         int R, int T, int C, int B,
                                         float log_p_stay, float log_p_move,
                                         float log_p_skip) {
    fill_body<true>(x, t_len, mu_b, sg_b, lo, delta, n_ref, dec, dec2, v_out,
                    acc_out, R, T, C, B, log_p_stay, log_p_move, log_p_skip);
}

static bool fill_shape_ok(int C, int B, int T) {
    return !(B < 32 || B > 1024 || (B & 31) || (C & 31) || C <= 0 || T % C);
}

NADAVCA_EXPORT int nadavca_viterbi_fill(const float* x, const int* t_len,
                                        const float* mu_b, const float* sg_b,
                                        const int* lo, const int* delta,
                                        const int* n_ref, int* dec,
                                        float* v_out, float* acc_out,
                                        int R, int T, int C, int B,
                                        float log_p_stay, float dcs,
                                        void* stream) {
    if (R == 0) return 0;
    if (!fill_shape_ok(C, B, T)) return (int)cudaErrorInvalidValue;
    const size_t shmem = (size_t)(2 * B + C + 32) * sizeof(float);
    viterbi_fill_kernel<<<R, B, shmem, (cudaStream_t)stream>>>(
        x, t_len, mu_b, sg_b, lo, delta, n_ref, dec, v_out, acc_out,
        R, T, C, B, log_p_stay, dcs);
    return (int)cudaGetLastError();
}

NADAVCA_EXPORT int nadavca_viterbi_fill_skip(const float* x, const int* t_len,
                                             const float* mu_b, const float* sg_b,
                                             const int* lo, const int* delta,
                                             const int* n_ref, int* dec, int* dec2,
                                             float* v_out, float* acc_out,
                                             int R, int T, int C, int B,
                                             float log_p_stay, float log_p_move,
                                             float log_p_skip, void* stream) {
    if (R == 0) return 0;
    if (!fill_shape_ok(C, B, T)) return (int)cudaErrorInvalidValue;
    const size_t shmem = (size_t)(2 * B + C + 32) * sizeof(float);
    viterbi_fill_skip_kernel<<<R, B, shmem, (cudaStream_t)stream>>>(
        x, t_len, mu_b, sg_b, lo, delta, n_ref, dec, dec2, v_out, acc_out,
        R, T, C, B, log_p_stay, log_p_move, log_p_skip);
    return (int)cudaGetLastError();
}
