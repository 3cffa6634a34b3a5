// viterbi_fill_pair: the banded Viterbi fill without skip, two samples per
// serial step.
//
// Replaces the two-sample body of the TPU fill kernel,
// nadavca_tpu/ops/pallas_dp.py:79 (_pair_fill_body, taken by _fill_kernel :188
// at :272 when dp_pair_step is set and use_skip is not).
//
// The nested recurrence over samples s, s+1
//   V(s)   = e1 + max(v + cs, v[j-1] + cm)
//   V(s+1) = e2 + max(V(s) + cs, V(s)[j-1] + cm)
// regroups by the total advance a = 0, 1, 2 of the pair into
//   V(s+1) = e2 + max(v + K0, v[j-1] + K1, v[j-2] + K2)
//   K0 = e1 + 2cs,  K1 = max(e1, e1[j-1]) + (cs + cm),  K2 = e1[j-1] + 2cm,
// where the K depend on the emissions alone. The per-sample decision bits come
// from the winning total advance: a = 2 sets both, a = 1 sets the bit of
// sample s+1 if e1[j-1] > e1 (move first, then stay) and the bit of sample s
// otherwise. The first pair of a read is a free start at its first sample and
// one single step; a read that ends between the two samples takes one single
// step. Expressions, their order and the strict compares are the TPU body's;
// the sums 2cs, cs + cm, 2cm arrive from the host, formed in double and
// rounded to float32 once. The emission is em_const - (x - mu)^2 * inv2v.
//
// Layout: as viterbi_fill.cu, one block per read and one thread per band slot,
// the row through double-buffered shared memory. Slot j takes v[j-1] and
// v[j-2] after ONE barrier per pair, and computes e1[j-1] itself from its left
// neighbour's constants, which it loads at the start of the chunk: the same
// operations on the same values give the neighbour's own e1 bit for bit, so no
// second exchange is needed.
//
// Bound: the latency of the serial chain, as for the single-step fill; this
// variant halves the barriers and shared-memory round trips per sample and
// pays for it with about twice the float operations, all off the chain.
//
// Built with -fmad=false: see common.cuh.

#include "common.cuh"

__global__ void viterbi_fill_pair_kernel(const float* __restrict__ x,
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
                                         float cs, float cm,
                                         float cs2, float csm, float cm2) {
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
        int* dec_c = dec + ((size_t)(t0 >> 5) * R + r) * B + j;
        const size_t word_stride = (size_t)R * B;
        int words_done = 0;

        if (n_act > 0) {
            for (int i = j; i < C; i += B) xs[i] = x[(size_t)r * T + t0 + i];
            const size_t bi = ((size_t)c * R + r) * B + j;
            const int lo_c = lo[(size_t)r * n_chunks + c];
            const float mu = mu_b[bi];
            const float sg = sg_b[bi];
            const float em_const = (lo_c + j < nr)
                ? (-logf(sg) - NADAVCA_HALF_LOG_2PI) : NADAVCA_NEG_INF;
            const float inv2v = 0.5f / (sg * sg);
            // the left neighbour's constants (slot 0 has none: e1[j-1] is NEG_INF)
            const float mu_m = (j > 0) ? mu_b[bi - 1] : 0.0f;
            const float sg_m = (j > 0) ? sg_b[bi - 1] : 1.0f;
            const float em_m = (j > 0 && lo_c + j - 1 < nr)
                ? (-logf(sg_m) - NADAVCA_HALF_LOG_2PI) : NADAVCA_NEG_INF;
            const float inv_m = 0.5f / (sg_m * sg_m);
            __syncthreads();

            unsigned pack = 0u;
            const int n_pairs = (n_act + 1) >> 1;
            for (int u = 0; u < n_pairs; ++u) {
                const int s = u << 1;
                float* buf = (u & 1) ? vbuf1 : vbuf0;
                buf[j] = v;
                __syncthreads();
                const float vm1 = (j > 0) ? buf[j - 1] : NADAVCA_NEG_INF;
                const float vm2 = (j > 1) ? buf[j - 2] : NADAVCA_NEG_INF;
                const float x1 = xs[s];
                const float x2 = xs[s + 1];
                const float d1 = x1 - mu;
                const float e1 = em_const - (d1 * d1) * inv2v;
                const float d2 = x2 - mu;
                const float e2 = em_const - (d2 * d2) * inv2v;
                const float d1m = x1 - mu_m;
                const float e1m = (j > 0) ? (em_m - (d1m * d1m) * inv_m)
                                          : NADAVCA_NEG_INF;
                const bool first = (t0 + s == 0);
                bool bit_lo = false, bit_hi = false;
                if (s + 1 < n_act) {
                    if (first) {
                        // free start at sample 0, one single step to sample 1
                        const float stay_f = e1 + cs;
                        const float move_f = e1m + cm;
                        bit_hi = move_f > stay_f;
                        v = e2 + fmaxf(stay_f, move_f);
                    } else {
                        const float K0 = e1 + cs2;
                        const bool b_dec = e1m > e1;
                        const float K1 = fmaxf(e1, e1m) + csm;
                        const float K2 = e1m + cm2;
                        const float c0 = v + K0;
                        const float c1 = vm1 + K1;
                        const float c2 = vm2 + K2;
                        const bool a1best = c1 > c0;
                        const float m01 = fmaxf(c0, c1);
                        const bool a2best = c2 > m01;
                        v = e2 + fmaxf(m01, c2);
                        bit_hi = a2best || (a1best && b_dec);
                        bit_lo = a2best || (a1best && !b_dec);
                    }
                } else {
                    // the read ends between the two samples: one single step
                    if (first) {
                        v = e1;
                    } else {
                        const float stay_h = v + cs;
                        const float move_h = vm1 + cm;
                        bit_lo = move_h > stay_h;
                        v = e1 + fmaxf(stay_h, move_h);
                    }
                }
                if (bit_lo) pack |= 1u << (s & 31);
                if (bit_hi) pack |= 1u << ((s + 1) & 31);
                if ((s & 31) == 30) {
                    dec_c[(size_t)words_done * word_stride] = (int)pack;
                    ++words_done;
                    pack = 0u;
                }
            }
            if ((n_pairs << 1) & 31) {
                dec_c[(size_t)words_done * word_stride] = (int)pack;
                ++words_done;
            }
        }
        for (int w = words_done; w < wpc; ++w)
            dec_c[(size_t)w * word_stride] = 0;

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

NADAVCA_EXPORT int nadavca_viterbi_fill_pair(const float* x, const int* t_len,
                                             const float* mu_b, const float* sg_b,
                                             const int* lo, const int* delta,
                                             const int* n_ref, int* dec,
                                             float* v_out, float* acc_out,
                                             int R, int T, int C, int B,
                                             float cs, float cm, float cs2,
                                             float csm, float cm2, void* stream) {
    if (R == 0) return 0;
    if (B < 32 || B > 1024 || (B & 31) || (C & 31) || C <= 0 || T % C)
        return (int)cudaErrorInvalidValue;
    const size_t shmem = (size_t)(2 * B + C + 32) * sizeof(float);
    viterbi_fill_pair_kernel<<<R, B, shmem, (cudaStream_t)stream>>>(
        x, t_len, mu_b, sg_b, lo, delta, n_ref, dec, v_out, acc_out,
        R, T, C, B, cs, cm, cs2, csm, cm2);
    return (int)cudaGetLastError();
}
