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
//
// Bound on this card. The bytes (x once, the level rows once, R*T*B/8 bytes
// of decision words per plane) and the operations (8 per cell, 15 with skip)
// are far below what the card does in the time of one read's chain: the
// recurrence is a serial chain of t_len.max() samples per read, and one
// read's band is all the parallel work a sample has. At the main shape
// (R = 256, B = 128) the batch fills 1 in 8 of the card's warp slots, and the
// time per sample does not change from R = 16 to R = 256. So the time is
// (samples of the longest read) x (cycles per sample of a read), and the
// design is about the cycles of one sample.
//
// The port's first fill gave each read a block of B threads, one slot each,
// and sent the row through shared memory with a block barrier on every
// sample: ~140 cycles per sample (70 ns at 1.98 GHz), the store, the barrier
// and the load of the neighbour on the chain.
//
// Layout. A read's band is W chain warps; lane l of chain warp w holds the S
// contiguous slots j0 = 32*S*w + S*l .. j0 + S - 1 in registers (v and one
// 32-bit word of decision bits per plane). Per sample:
//   - slot j0 - 1 (and j0 - 2 under skip) comes from lane l - 1 by
//     __shfl_up_sync; lane 0 takes NEG_INF, or the left warp's edge;
//   - the other slots take their neighbours from the lane's own registers,
//     updated from slot S-1 down so that every read sees the old row;
//   - the S emissions come from shared memory in one 16-byte load, issued a
//     sample ahead;
//   - the bit goes into the word at a position known at compile time: the
//     sample loop is unrolled by 32 (one word), and each lane stores its S
//     words once per 32 samples, as 16-byte stores, coalesced over the warp.
// A dependency path moves one slot per sample at most, so it crosses a lane
// boundary (a shuffle) at most once every S samples; inside a lane a sample's
// chain is three dependent float operations (add, max, add).
//
// The emissions depend on nothing of the recurrence, and computed in the
// chain warp they took a third of its instructions. So each chain warp has a
// producer warp beside it that computes the emissions of the same slots
// (the chunk's constants, logf included, and 4 operations per slot and
// sample) into a table in shared memory, HALF samples at a time into two
// buffers. They hand over through two counters in shared memory (halves
// made, halves used; st.release / ld.acquire), never a block barrier: the
// producer runs up to two half-groups ahead.
//
// The producer also gathers the chunk's band levels itself, a chunk ahead,
// from the read's (R, N) rows of expected levels: mu[lo_c + j] and
// sigma[lo_c + j], 0 and 1 where the position leaves [0, N). That is the
// TPU's band gather (nadavca_tpu/ops/pallas_dp.py:520, _band_gather_kernel,
// launched by band_gather_pallas :558), folded in: on this card it was a
// launch of its own that wrote the chunk-major bands (22.8 MB at the main
// shape) for the producers to read back once. The loads are the same in
// number, contiguous in j, and the values the same floats, so nothing
// rounds differently. All three variants gather their own levels; no
// standalone band gather is left in the port.
//
// Bands wider than one warp (W > 1). Slot j needs j-1 and j-2 only, never
// j+1, so a chain warp depends on the warp to its left and on no other. The
// warps of a read run as a wavefront: at each sample, lane 31 of warp w
// stores its last slot(s) (the values that sample reads) into a ring in
// shared memory, and after each half-group publishes how many it has done;
// warp w+1 waits for that count before the same half-group, loads its 16
// edge values into one register per lane and hands them to lane 0 sample by
// sample by __shfl_sync, off its chain. The ring holds RING_HALVES
// half-groups; a warp waits for its right neighbour only when it would
// overwrite one not yet read. No barrier and no shared-memory load stands on
// a sample's chain; a warp runs one half-group behind its left neighbour,
// which costs W - 1 half-groups per chunk, because the chunk's realign and
// renormalisation join the chain warps (named barrier 1 over them; the
// producers never join it). A named barrier per sample would put a store, a
// barrier and a load on every sample's chain, as the first fill did; a halo
// would recompute slots and shrink what each warp owns. With W = 1
// (MULTI = false) the program holds no ring, no wait for a neighbour and no
// block barrier after its start.
//
// Once per chunk: the realign by delta is a round trip through a shared row
// (a __syncwarp, or the named barrier when W > 1), and the row maximum is a
// warp reduction by shuffles (then across the W warps through shared memory).
// Chunks that lie wholly beyond a read's end run no sample and store zero
// words.
//
// What the compiler made of it (cuobjdump -sass; scripts/torch_fill_turns.py
// counts it): without skip at S = 4, a chain warp issues 23 instructions per
// sample (8 FADD, 4 FMNMX, 4 FSETP, 4 IADD3 for the bits, SHFL.UP, the lane-0
// select, the emission load) with 30 stall cycles per sample in the
// compiler's own schedule, its producer 17 instructions; with skip at S = 2
// and W > 1, 30 and 10. On an H100 (1.98 GHz) a sample takes ~63 cycles
// without skip and ~117 with skip (PERF.md): twice the compiler's schedule,
// whatever the shuffle, the bit packing or the emission loads add (each left
// out in turn costs under 10 %), and whatever the number of warps per SM.
//
// (S, W) by band width and variant, a fixed table (slots_per_lane): without
// skip S = 4 with W = B / 128, chosen by timing S = 4, W = 1 against S = 2,
// W = 2 at B = 128 and S = 8, W = 1 against S = 4, W = 2 at B = 256; with
// skip, whose sample is twice the instructions, S = 2 (W = B / 64) up to
// B = 256, which beat S = 4 at both widths; above 256 S = 4 (PERF.md). The
// two-sample fill S = 2 up to B = 384 (W = B / 64), which beat S = 4 and
// S = 8 at B = 128, 256 and 384; at 512 S = 4 (W = 4) beat S = 2 (W = 8)
// (PERF.md).
//
// The two-sample variant (viterbi_fill_pair_kernel) replaces the TPU's pair
// body (pallas_dp.py:79, _pair_fill_body, taken by _fill_kernel at :272 under
// dp_pair_step without skip). The nested recurrence over samples s, s+1
//   V(s) = e1 + max(v + cs, v[j-1] + cm),  V(s+1) = e2 + max(V(s) + cs, V(s)[j-1] + cm)
// regroups by the pair's total advance 0 / 1 / 2 into
//   V(s+1) = e2 + max(v + K0, v[j-1] + K1, v[j-2] + K2),
//   K0 = e1 + 2cs,  K1 = max(e1, e1[j-1]) + (cs + cm),  K2 = e1[j-1] + 2cm,
// with e = em_const - (x - mu)^2 * inv2v; the per-sample bits come from the
// winning advance (a = 2 both; a = 1 the second sample's if e1[j-1] > e1,
// else the first's), the TPU's expressions in its order. The pair's first
// sample's bit stands at the slot where the pair ends, so the walk does not
// always retrace the optimal path: the TPU's defect, reproduced bit for bit
// (ROADMAP.md, Queue 3). The first pair of a read is a free start and one
// single step; a read that ends after a pair's first sample takes one single
// step. On this layout a pair is one step of the chain: it reads v[j-1] and
// v[j-2] as the skip sample does (two shuffles, two ring values per pair at a
// warp edge), and computes the K from e1, e2 of its slots and e1[j-1], which
// for the lane's slot 0 is the emission of slot j0 - 1: its producer gathers
// S + 1 levels from j0 - 1 and hands e1, e2 and that edge over, HALF / 2
// pairs a half-group, so the float is the left lane's (or the left warp's)
// own. The K stay in the chain warp: the three emission rows of a pair are
// what fits two buffers of a half-group in shared memory at B = 1024 (four
// rows, K0, K1, K2 and e2, would take 256 KB). The port's first design gave
// each read a block of B threads with a block barrier and a
// shared-memory round trip per pair. It takes any band width that is a
// multiple of 32: the last warp's lanes past the band run idle and are never
// stored.
//
// The three variants are one body, specialised at compile time: the program
// without skip holds no skip code and no second plane, the single-step ones
// no pair code.
//
// Built with -fmad=false: see common.cuh.

#include "common.cuh"

#include <stddef.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
// half-groups of edge values a chain warp may run ahead of its right neighbour
constexpr int RING_HALVES = 8;
// most chain warps a read's band may take (each has a producer warp beside
// it: the kernels' launch bound is twice this)
constexpr int MAX_WARPS = 8;
// samples a producer hands over to its chain warp, and a chain warp to its
// right neighbour, at a time: a half-group (two buffers of emissions)
constexpr int HALF = 16;

__device__ __forceinline__ unsigned shared_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
                 : "=r"(v) : "r"(shared_addr(p)) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
    asm volatile("st.release.cta.shared.b32 [%0], %1;"
                 :: "r"(shared_addr(p)), "r"(v) : "memory");
}

// A barrier over the W chain warps of a read (named barrier 1; the
// producer warps never join it), or over the one warp.
template <bool MULTI>
__device__ __forceinline__ void chain_sync(int W) {
    if (MULTI) asm volatile("bar.sync 1, %0;" :: "r"(32 * W) : "memory");
    else __syncwarp();
}

template <int S>
__device__ __forceinline__ void load_slots(const float* __restrict__ p, float (&out)[S]) {
    static_assert(S == 2 || S % 4 == 0, "S is 2 or a multiple of 4");
    if constexpr (S == 2) {
        const float2 q = *reinterpret_cast<const float2*>(p);
        out[0] = q.x;
        out[1] = q.y;
    } else {
#pragma unroll
        for (int i = 0; i < S / 4; ++i) {
            const float4 q = reinterpret_cast<const float4*>(p)[i];
            out[4 * i] = q.x;
            out[4 * i + 1] = q.y;
            out[4 * i + 2] = q.z;
            out[4 * i + 3] = q.w;
        }
    }
}

template <int S>
__device__ __forceinline__ void store_slots(float* p, const float (&in)[S]) {
    if constexpr (S == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
    } else {
#pragma unroll
        for (int i = 0; i < S / 4; ++i)
            reinterpret_cast<float4*>(p)[i] =
                make_float4(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]);
    }
}

template <int S>
__device__ __forceinline__ void store_slots(int* p, const unsigned (&in)[S]) {
    if constexpr (S == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(in[0], in[1]);
    } else {
#pragma unroll
        for (int i = 0; i < S / 4; ++i)
            reinterpret_cast<uint4*>(p)[i] =
                make_uint4(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]);
    }
}

// A chain warp's slots: the carried row and the words of decision bits of the
// current group.
template <bool SKIP, int S>
struct Chain {
    float v[S];
    unsigned pk[S];
    unsigned pk2[SKIP ? S : 1];
};

// A producer's emission constants of one chunk: without skip c2p, c1p, c0p;
// with skip mu, em_const, inv2v.
template <int S>
struct EmitConst {
    float a[S], b[S], c[S];
};

// The transition constants of the two-sample step: the single-step ones and
// the pair sums 2cs, cs + cm, 2cm, each summed in double on the host and
// rounded to float once.
struct PairK {
    float cs, cm, cs2, csm, cm2;
};

// A pair producer's constants of one chunk: mu, em_const, inv2v of the lane's
// S slots at 1 .. S and, at 0, of slot j0 - 1, whose first emission is e1[j-1]
// of the lane's slot 0.
template <int S>
struct PairConst {
    float mu[S + 1], em[S + 1], iv[S + 1];
};

// The emissions of one pair for the lane's slots into a pair row of the
// table, em_const - (x - mu)^2 * inv2v: e1 (first sample) and e2 (second) of
// the S slots, each a row of 32 * S, then e1 of slot j0 - 1 at [2 ROW + lane]
// (NEG_INF left of slot 0, as the TPU shifts it in).
template <int S>
__device__ __forceinline__ void pair_emissions(const PairConst<S>& q, float x1, float x2,
                                               bool left_end, int lane, float* row) {
    constexpr int ROW = 32 * S;
    float e1[S], e2[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
        const float d1 = x1 - q.mu[k + 1];
        e1[k] = q.em[k + 1] - (d1 * d1) * q.iv[k + 1];
        const float d2 = x2 - q.mu[k + 1];
        e2[k] = q.em[k + 1] - (d2 * d2) * q.iv[k + 1];
    }
    const float d0 = x1 - q.mu[0];
    const float e1m0 = left_end ? NADAVCA_NEG_INF : q.em[0] - (d0 * d0) * q.iv[0];
    store_slots<S>(row + lane * S, e1);
    store_slots<S>(row + ROW + lane * S, e2);
    row[2 * ROW + lane] = e1m0;
}

// The emissions of one sample for the lane's slots, into its row of the
// table: without skip (c2p * x + c1p) * x + c0p, with skip
// em_const - (x - mu)^2 * inv2v.
template <bool SKIP, int S>
__device__ __forceinline__ void emissions(const EmitConst<S>& q, float xv, float* row) {
    float e[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
        if constexpr (SKIP) {
            const float diff = xv - q.a[k];
            e[k] = q.b[k] - (diff * diff) * q.c[k];
        } else {
            e[k] = (q.a[k] * xv + q.b[k]) * xv + q.c[k];
        }
    }
    store_slots<S>(row, e);
}

// One sample for the lane's slots, given their emissions. left1, left2:
// slots j0 - 1 and j0 - 2 of the previous sample. p1, p2: without skip
// (log_p_move - log_p_stay, unused); with skip (log_p_move, log_p_skip).
template <bool SKIP, int S>
__device__ __forceinline__ void sample(Chain<SKIP, S>& q, const float (&emit)[S],
                                       float left1, float left2, unsigned bit,
                                       float log_p_stay, float p1, float p2) {
#pragma unroll
    for (int k = S - 1; k >= 0; --k) {
        const int k1 = k >= 1 ? k - 1 : 0;
        const int k2 = k >= 2 ? k - 2 : 0;
        const float vm1 = k >= 1 ? q.v[k1] : left1;
        if constexpr (SKIP) {
            const float vm2 = k >= 2 ? q.v[k2] : (k == 1 ? left1 : left2);
            const float stay = q.v[k] + log_p_stay;
            const float move = vm1 + p1;
            const float best = fmaxf(stay, move);
            const float skip = vm2 + p2;
            const bool bit2 = skip > best;
            if (move > stay && !bit2) q.pk[k] |= bit;
            if (bit2) q.pk2[k] |= bit;
            q.v[k] = emit[k] + fmaxf(best, skip);
        } else {
            const float mv = vm1 + p1;
            if (mv > q.v[k]) q.pk[k] |= bit;
            q.v[k] = emit[k] + fmaxf(q.v[k], mv);
        }
    }
}

// Sample s of a group (u of its half-group), its emissions given: the edge
// handed to the right warp, the neighbours, the update. At the free start
// (t = 0) the emission alone (with the folded stay taken out again without
// skip), no bit. e1g / e2g hold the half's left edges, sample u in lane u;
// ring1 / ring2 this warp's ring row of the half (MULTI, with a right
// neighbour, written by lane 31 only).
template <bool SKIP, int S, bool MULTI>
__device__ __forceinline__ void group_sample(Chain<SKIP, S>& q, const float (&emit)[S],
                                             int s, int u, bool first, int lane, float e1g,
                                             float e2g, bool feed, float* ring1,
                                             float* ring2, float log_p_stay, float p1,
                                             float p2) {
    if (MULTI && feed) {
        ring1[u] = q.v[S - 1];
        if constexpr (SKIP) ring2[u] = q.v[S - 2];
    }
    if (first) {
#pragma unroll
        for (int k = 0; k < S; ++k) q.v[k] = SKIP ? emit[k] : emit[k] - log_p_stay;
        return;
    }
    float e1 = NADAVCA_NEG_INF, e2 = NADAVCA_NEG_INF;
    if (MULTI) {
        e1 = __shfl_sync(FULL_MASK, e1g, u);
        if constexpr (SKIP) e2 = __shfl_sync(FULL_MASK, e2g, u);
    }
    const float u1 = __shfl_up_sync(FULL_MASK, q.v[S - 1], 1);
    const float left1 = lane == 0 ? e1 : u1;
    float left2 = NADAVCA_NEG_INF;
    if constexpr (SKIP) {
        const float u2 = __shfl_up_sync(FULL_MASK, q.v[S - 2], 1);
        left2 = lane == 0 ? e2 : u2;
    }
    sample<SKIP, S>(q, emit, left1, left2, 1u << s, log_p_stay, p1, p2);
}

// One pair of samples (s, s + 1; s even, the bit of s in the group's word)
// for the lane's slots, given their emissions: e1, e2 of the S slots, e1m0 =
// e1 of slot j0 - 1. u: the pair in its half-group, whose ring row lane 31
// feeds with v[S-1] and v[S-2] before the update (MULTI, with a right
// neighbour). first: the read's first pair (a free start at s, one single
// step to s + 1, the bit of s + 1 only); half: the read ends after s (one
// single step, the bit of s only; with first, v = e1 and no bit). Otherwise
// the regrouped step of the TPU's pair body, by total advance 0 / 1 / 2:
//   V = e2 + max(v + K0, v[j-1] + K1, v[j-2] + K2),  K0 = e1 + 2cs,
//   K1 = max(e1, e1[j-1]) + (cs + cm),  K2 = e1[j-1] + 2cm,
// and the two bits from the winning advance (a = 1: b_dec = e1[j-1] > e1
// picks which sample moved). Strict compares: the smaller advance wins a tie.
template <int S, bool MULTI>
__device__ __forceinline__ void pair_sample(Chain<false, S>& q, const float (&e1)[S],
                                            const float (&e2)[S], float e1m0, int s, int u,
                                            bool first, bool half, int lane, float e1g,
                                            float e2g, bool feed, float* ring1,
                                            float* ring2, const PairK& c) {
    static_assert(S >= 2, "the pair step reads two slots to the left");
    if (MULTI && feed) {
        ring1[u] = q.v[S - 1];
        ring2[u] = q.v[S - 2];
    }
    if (first) {
#pragma unroll
        for (int k = S - 1; k >= 0; --k) {
            if (half) {
                q.v[k] = e1[k];
            } else {
                const float e1m = k >= 1 ? e1[k >= 1 ? k - 1 : 0] : e1m0;
                const float stay_f = e1[k] + c.cs;
                const float move_f = e1m + c.cm;
                if (move_f > stay_f) q.pk[k] |= 2u << s;
                q.v[k] = e2[k] + fmaxf(stay_f, move_f);
            }
        }
        return;
    }
    float l1 = NADAVCA_NEG_INF, l2 = NADAVCA_NEG_INF;
    if (MULTI) {
        l1 = __shfl_sync(FULL_MASK, e1g, u);
        l2 = __shfl_sync(FULL_MASK, e2g, u);
    }
    const float u1 = __shfl_up_sync(FULL_MASK, q.v[S - 1], 1);
    const float u2 = __shfl_up_sync(FULL_MASK, q.v[S - 2], 1);
    const float left1 = lane == 0 ? l1 : u1;
    const float left2 = lane == 0 ? l2 : u2;
#pragma unroll
    for (int k = S - 1; k >= 0; --k) {
        const int k1 = k >= 1 ? k - 1 : 0;
        const int k2 = k >= 2 ? k - 2 : 0;
        const float vm1 = k >= 1 ? q.v[k1] : left1;
        if (half) {
            const float stay_h = q.v[k] + c.cs;
            const float move_h = vm1 + c.cm;
            if (move_h > stay_h) q.pk[k] |= 1u << s;
            q.v[k] = e1[k] + fmaxf(stay_h, move_h);
        } else {
            const float vm2 = k >= 2 ? q.v[k2] : (k == 1 ? left1 : left2);
            const float e1m = k >= 1 ? e1[k1] : e1m0;
            const float K0 = e1[k] + c.cs2;
            const bool b_dec = e1m > e1[k];
            const float K1 = fmaxf(e1[k], e1m) + c.csm;
            const float K2 = e1m + c.cm2;
            const float c0 = q.v[k] + K0;
            const float c1 = vm1 + K1;
            const float c2 = vm2 + K2;
            const bool a1best = c1 > c0;
            const float m01 = fmaxf(c0, c1);
            const bool a2best = c2 > m01;
            q.v[k] = e2[k] + fmaxf(m01, c2);
            if (a2best || (a1best && b_dec)) q.pk[k] |= 2u << s;
            if (a2best || (a1best && !b_dec)) q.pk[k] |= 1u << s;
        }
    }
}

// The band levels of the lane's slots in one chunk, from the read's rows of
// the expected levels: mu[lo_c + j0 + k], sigma likewise, and the pad values
// 0 and 1 where the position leaves [0, N) (the gather of the TPU's band
// gather kernel, made here: lo_c is arbitrary, so these loads are scalar;
// they come once per chunk, a chunk ahead, off the chain's path).
template <int S>
__device__ __forceinline__ void load_band(const float* __restrict__ mu_r,
                                          const float* __restrict__ sg_r, int p0, int N,
                                          float (&mu)[S], float (&sg)[S]) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
        const int p = p0 + k;
        const bool in = p >= 0 && p < N;
        mu[k] = in ? mu_r[p] : 0.0f;
        sg[k] = in ? sg_r[p] : 1.0f;
    }
}

// The producer warp of one chain warp: the emissions of the same slots for
// every live sample, HALF samples at a time into the buffer (h & 1) of the
// table, h the read's half-group counter. made / used count the halves
// written and read. mu_r, sg_r: the read's rows of N expected levels.
template <bool SKIP, int S>
__device__ __forceinline__ void produce(const float* __restrict__ xr,
                                        const float* __restrict__ mu_r,
                                        const float* __restrict__ sg_r,
                                        const int* __restrict__ lo_r, int T, int C, int N,
                                        int j0, int lane, int tl, int nr,
                                        float log_p_stay, float* tab, int* made,
                                        const int* used) {
    constexpr int ROW = 32 * S;
    const int n_chunks = T / C;
    float mu_n[S], sg_n[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
        mu_n[k] = 0.0f;
        sg_n[k] = 1.0f;
    }
    if (tl > 0) load_band<S>(mu_r, sg_r, lo_r[0] + j0, N, mu_n, sg_n);
    float xg_n = tl > 0 ? xr[lane] : 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * C;
        const int n_act = min(tl - t0, C);
        if (n_act <= 0) break;              // and so are the chunks after it
        EmitConst<S> q;
        const int lo_c = lo_r[c];
#pragma unroll
        for (int k = 0; k < S; ++k) {
            const float mu = mu_n[k], sg = sg_n[k];
            const float em_const = (lo_c + j0 + k < nr)
                ? (-logf(sg) - NADAVCA_HALF_LOG_2PI) : NADAVCA_NEG_INF;
            const float inv2v = 0.5f / (sg * sg);
            if constexpr (SKIP) {
                q.a[k] = mu;
                q.b[k] = em_const;
                q.c[k] = inv2v;
            } else {
                q.a[k] = -inv2v;
                q.b[k] = (mu + mu) * inv2v;
                q.c[k] = (em_const - (mu * mu) * inv2v) + log_p_stay;
            }
        }
        if (t0 + C < tl) load_band<S>(mu_r, sg_r, lo_r[c + 1] + j0, N, mu_n, sg_n);
        const int n_groups = (n_act + 31) >> 5;
        for (int g = 0; g < n_groups; ++g) {
            const int G = c * (C >> 5) + g;
            const float xg = xg_n;
            if ((G + 1) * 32 < tl) xg_n = xr[(G + 1) * 32 + lane];
            const int n = min(32, n_act - 32 * g);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int nh = min(HALF, n - HALF * half);
                if (nh <= 0) break;
                const int h = 2 * G + half;
                // the chain warp is done with the half that last used this buffer
                while (load_acquire(used) < h - 1) {
                }
                float* dst = tab + (h & 1) * HALF * ROW;
                if (nh == HALF) {
#pragma unroll
                    for (int u = 0; u < HALF; ++u)
                        emissions<SKIP, S>(q, __shfl_sync(FULL_MASK, xg, HALF * half + u),
                                           dst + u * ROW);
                } else {
#pragma unroll 1
                    for (int u = 0; u < nh; ++u)
                        emissions<SKIP, S>(q, __shfl_sync(FULL_MASK, xg, HALF * half + u),
                                           dst + u * ROW);
                }
                __threadfence_block();
                __syncwarp();
                if (lane == 0) store_release(made, h + 1);
            }
        }
    }
}

// The producer warp of one chain warp of the two-sample fill: as produce,
// with the pair's emissions (pair_emissions) of HALF / 2 pairs a half-group,
// a pair row of PROW = 2 ROW + 32 floats each. It gathers the levels of S + 1
// slots a chunk, from j0 - 1, so that e1[j-1] of the lane's slot 0 is its own
// and the same float as the left lane's (or the left warp's) e1.
template <int S>
__device__ __forceinline__ void produce_pair(const float* __restrict__ xr,
                                             const float* __restrict__ mu_r,
                                             const float* __restrict__ sg_r,
                                             const int* __restrict__ lo_r, int T, int C,
                                             int N, int j0, int lane, int tl, int nr,
                                             float* tab, int* made, const int* used) {
    constexpr int M = S + 1;
    constexpr int PROW = 64 * S + 32;
    constexpr int PAIRS = HALF / 2;
    const int n_chunks = T / C;
    float mu_n[M], sg_n[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
        mu_n[k] = 0.0f;
        sg_n[k] = 1.0f;
    }
    if (tl > 0) load_band<M>(mu_r, sg_r, lo_r[0] + j0 - 1, N, mu_n, sg_n);
    float xg_n = tl > 0 ? xr[lane] : 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * C;
        const int n_act = min(tl - t0, C);
        if (n_act <= 0) break;              // and so are the chunks after it
        PairConst<S> q;
        const int lo_c = lo_r[c];
#pragma unroll
        for (int k = 0; k < M; ++k) {
            const float sg = sg_n[k];
            q.mu[k] = mu_n[k];
            q.em[k] = (lo_c + j0 - 1 + k < nr) ? (-logf(sg) - NADAVCA_HALF_LOG_2PI)
                                               : NADAVCA_NEG_INF;
            q.iv[k] = 0.5f / (sg * sg);
        }
        if (t0 + C < tl) load_band<M>(mu_r, sg_r, lo_r[c + 1] + j0 - 1, N, mu_n, sg_n);
        const int n_groups = (n_act + 31) >> 5;
        for (int g = 0; g < n_groups; ++g) {
            const int G = c * (C >> 5) + g;
            const float xg = xg_n;
            if ((G + 1) * 32 < tl) xg_n = xr[(G + 1) * 32 + lane];
            const int n = min(32, n_act - 32 * g);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int nh = min(HALF, n - HALF * half);
                if (nh <= 0) break;
                const int h = 2 * G + half;
                while (load_acquire(used) < h - 1) {
                }
                float* dst = tab + (h & 1) * PAIRS * PROW;
                if (nh == HALF) {
#pragma unroll
                    for (int u = 0; u < PAIRS; ++u)
                        pair_emissions<S>(q, __shfl_sync(FULL_MASK, xg, HALF * half + 2 * u),
                                          __shfl_sync(FULL_MASK, xg, HALF * half + 2 * u + 1),
                                          j0 == 0, lane, dst + u * PROW);
                } else {
#pragma unroll 1
                    for (int u = 0; u < (nh + 1) >> 1; ++u)
                        pair_emissions<S>(q, __shfl_sync(FULL_MASK, xg, HALF * half + 2 * u),
                                          __shfl_sync(FULL_MASK, xg, HALF * half + 2 * u + 1),
                                          j0 == 0, lane, dst + u * PROW);
                }
                __threadfence_block();
                __syncwarp();
                if (lane == 0) store_release(made, h + 1);
            }
        }
    }
}

// One half-group h = 2G + half of a chain warp: n samples (HALF when FULL)
// from bit s0 of word row G. Waits for the left warp's edges of the half
// (MULTI), for room in its own ring, and for the producer's emissions; then
// hands the buffer back and, with W > 1, publishes its own edges.
template <bool SKIP, int S, bool MULTI, bool FULL>
__device__ __forceinline__ void chain_half(Chain<SKIP, S>& q, int h, int s0, int n,
                                           bool first_group, int w, int W, int lane,
                                           const float* tab, const int* made, int* used,
                                           int* done, float* ring, float log_p_stay,
                                           float p1, float p2) {
    constexpr int PLANES = SKIP ? 2 : 1;
    constexpr int ROW = 32 * S;
    const bool feed = MULTI && w + 1 < W && lane == 31;
    float e1g = NADAVCA_NEG_INF, e2g = NADAVCA_NEG_INF;
    float* ring1 = nullptr;
    float* ring2 = nullptr;
    if (MULTI) {
        const int slot = h % RING_HALVES;
        if (w > 0) {
            while (load_acquire(done + w - 1) <= h) {
            }
            const float* in = ring + ((size_t)((w - 1) * RING_HALVES + slot) * PLANES) * HALF;
            e1g = in[lane & (HALF - 1)];
            if constexpr (SKIP) e2g = in[HALF + (lane & (HALF - 1))];
        }
        if (w + 1 < W) {
            // the right neighbour must have read this ring slot
            while (h >= RING_HALVES && load_acquire(done + w + 1) <= h - RING_HALVES) {
            }
            ring1 = ring + ((size_t)(w * RING_HALVES + slot) * PLANES) * HALF;
            ring2 = ring1 + HALF;
        }
    }
    while (load_acquire(made) <= h) {
    }
    const float* src = tab + (h & 1) * HALF * ROW;
    if constexpr (FULL) {
        float e_next[S];
        load_slots<S>(src, e_next);
#pragma unroll
        for (int u = 0; u < HALF; ++u) {
            float e[S];
#pragma unroll
            for (int k = 0; k < S; ++k) e[k] = e_next[k];
            if (u + 1 < HALF) load_slots<S>(src + (u + 1) * ROW, e_next);
            group_sample<SKIP, S, MULTI>(q, e, s0 + u, u, false, lane, e1g, e2g, feed,
                                         ring1, ring2, log_p_stay, p1, p2);
        }
    } else {
#pragma unroll 1
        for (int u = 0; u < n; ++u) {
            float e[S];
            load_slots<S>(src + u * ROW, e);
            group_sample<SKIP, S, MULTI>(q, e, s0 + u, u, first_group && s0 + u == 0, lane,
                                         e1g, e2g, feed, ring1, ring2, log_p_stay, p1, p2);
        }
    }
    __syncwarp();
    if (lane == 0) store_release(used, h + 1);
    if (MULTI && lane == 31) store_release(done + w, h + 1);
}

// The two-sample counterpart of chain_half: the half-group's n samples as
// (n + 1) / 2 pairs, the last a half pair when n is odd. The ring row of a
// half carries two edge values per pair (v[S-1] and v[S-2] of lane 31).
template <int S, bool MULTI, bool FULL>
__device__ __forceinline__ void pair_half(Chain<false, S>& q, int h, int s0, int n,
                                          bool first_group, int w, int W, int lane,
                                          const float* tab, const int* made, int* used,
                                          int* done, float* ring, const PairK& c) {
    constexpr int ROW = 32 * S;
    constexpr int PROW = 2 * ROW + 32;
    constexpr int PAIRS = HALF / 2;
    const bool feed = MULTI && w + 1 < W && lane == 31;
    float e1g = NADAVCA_NEG_INF, e2g = NADAVCA_NEG_INF;
    float* ring1 = nullptr;
    float* ring2 = nullptr;
    if (MULTI) {
        const int slot = h % RING_HALVES;
        if (w > 0) {
            while (load_acquire(done + w - 1) <= h) {
            }
            const float* in = ring + ((size_t)((w - 1) * RING_HALVES + slot) * 2) * HALF;
            e1g = in[lane & (HALF - 1)];
            e2g = in[HALF + (lane & (HALF - 1))];
        }
        if (w + 1 < W) {
            // the right neighbour must have read this ring slot
            while (h >= RING_HALVES && load_acquire(done + w + 1) <= h - RING_HALVES) {
            }
            ring1 = ring + ((size_t)(w * RING_HALVES + slot) * 2) * HALF;
            ring2 = ring1 + HALF;
        }
    }
    while (load_acquire(made) <= h) {
    }
    const float* src = tab + (h & 1) * PAIRS * PROW;
    if constexpr (FULL) {
        float a_n[S], b_n[S];
        load_slots<S>(src + lane * S, a_n);
        load_slots<S>(src + ROW + lane * S, b_n);
        float m_n = src[2 * ROW + lane];
#pragma unroll
        for (int u = 0; u < PAIRS; ++u) {
            float e1[S], e2[S];
#pragma unroll
            for (int k = 0; k < S; ++k) {
                e1[k] = a_n[k];
                e2[k] = b_n[k];
            }
            const float e1m0 = m_n;
            if (u + 1 < PAIRS) {
                const float* nx = src + (u + 1) * PROW;
                load_slots<S>(nx + lane * S, a_n);
                load_slots<S>(nx + ROW + lane * S, b_n);
                m_n = nx[2 * ROW + lane];
            }
            pair_sample<S, MULTI>(q, e1, e2, e1m0, s0 + 2 * u, u, false, false, lane, e1g,
                                  e2g, feed, ring1, ring2, c);
        }
    } else {
#pragma unroll 1
        for (int u = 0; u < (n + 1) >> 1; ++u) {
            const float* at = src + u * PROW;
            float e1[S], e2[S];
            load_slots<S>(at + lane * S, e1);
            load_slots<S>(at + ROW + lane * S, e2);
            pair_sample<S, MULTI>(q, e1, e2, at[2 * ROW + lane], s0 + 2 * u, u,
                                  first_group && s0 + 2 * u == 0, 2 * u + 1 >= n, lane,
                                  e1g, e2g, feed, ring1, ring2, c);
        }
    }
    __syncwarp();
    if (lane == 0) store_release(used, h + 1);
    if (MULTI && lane == 31) store_release(done + w, h + 1);
}


// A chain warp: the recurrence over its slots, the realign and the
// renormalisation, the decision words. B is the band's width; a lane whose
// slots lie at or past it (the last warp of a band that is not a multiple of
// 32 * S, two-sample fill only) runs with the others, and its slots are never
// read by a live one, enter no row maximum and are not stored.
template <bool SKIP, bool PAIR, int S, bool MULTI>
__device__ __forceinline__ void chain(const int* __restrict__ delta_r,
                                      int* __restrict__ dec, int* __restrict__ dec2,
                                      float* __restrict__ v_out,
                                      float* __restrict__ acc_out, int R, int T, int C,
                                      int B, int r, int w, int W, int lane, int j0, int tl,
                                      float log_p_stay, float p1, float p2, const PairK& pc,
                                      const float* tab, const int* made, int* used,
                                      float* row, float* red, int* done, float* ring) {
    const int n_chunks = T / C;
    const int gpc = C >> 5;                 // groups (decision words) per chunk
    const bool live = j0 < B;               // B is a multiple of 32, S divides 32

    Chain<SKIP, S> q;
#pragma unroll
    for (int k = 0; k < S; ++k) {
        q.v[k] = NADAVCA_NEG_INF;
        q.pk[k] = 0u;
        if constexpr (SKIP) q.pk2[k] = 0u;
    }
    float acc = 0.0f;
    int d_n = 0;
    for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * C;
        const int d = d_n;
        if (c + 1 < n_chunks) d_n = delta_r[c + 1];
        if (c > 0) {
            // realign the carried row to the new band start: V'[j] = V[j + d]
            // (W > 1: the chunk-end barrier already ordered the last reads)
            if (!MULTI) __syncwarp();
            store_slots<S>(row + j0, q.v);
            chain_sync<MULTI>(W);
#pragma unroll
            for (int k = 0; k < S; ++k) {
                const long long src = (long long)(j0 + k) + d;
                q.v[k] = (src >= 0 && src < B) ? row[src] : NADAVCA_NEG_INF;
            }
        }

        int n_act = tl - t0;
        if (n_act > C) n_act = C;
        const int n_groups = n_act > 0 ? (n_act + 31) >> 5 : 0;
        for (int g = 0; g < n_groups; ++g) {
            const int G = c * gpc + g;              // absolute group = word row
            const int n = min(32, n_act - 32 * g);
            if (n == 32 && G > 0) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    if constexpr (PAIR)
                        pair_half<S, MULTI, true>(q, 2 * G + half, HALF * half, HALF, false,
                                                  w, W, lane, tab, made, used, done, ring,
                                                  pc);
                    else
                        chain_half<SKIP, S, MULTI, true>(q, 2 * G + half, HALF * half, HALF,
                                                         false, w, W, lane, tab, made, used,
                                                         done, ring, log_p_stay, p1, p2);
                }
            } else {
                // the read's first group (free start) and its last, partial one
                for (int half = 0; half < 2; ++half) {
                    const int nh = min(HALF, n - HALF * half);
                    if (nh <= 0) break;
                    if constexpr (PAIR)
                        pair_half<S, MULTI, false>(q, 2 * G + half, HALF * half, nh, G == 0,
                                                   w, W, lane, tab, made, used, done, ring,
                                                   pc);
                    else
                        chain_half<SKIP, S, MULTI, false>(q, 2 * G + half, HALF * half, nh,
                                                          G == 0, w, W, lane, tab, made,
                                                          used, done, ring, log_p_stay, p1,
                                                          p2);
                }
            }
            const size_t off = ((size_t)G * R + r) * B + j0;
            if (live) {
                store_slots<S>(dec + off, q.pk);
                if constexpr (SKIP) store_slots<S>(dec2 + off, q.pk2);
            }
#pragma unroll
            for (int k = 0; k < S; ++k) {
                q.pk[k] = 0u;
                if constexpr (SKIP) q.pk2[k] = 0u;
            }
        }
        for (int g = n_groups; g < gpc && live; ++g) {
            const size_t off = ((size_t)(c * gpc + g) * R + r) * B + j0;
            const unsigned zero[S] = {};
            store_slots<S>(dec + off, zero);
            if constexpr (SKIP) store_slots<S>(dec2 + off, zero);
        }

        // chunk-end renormalisation into the accumulator
        float m = q.v[0];
#pragma unroll
        for (int k = 1; k < S; ++k) m = fmaxf(m, q.v[k]);
        // a slot past the band: NEG_INF changes no maximum that is kept
        if (!live) m = NADAVCA_NEG_INF;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
        if (MULTI) {
            if (lane == 0) red[w] = m;
            chain_sync<MULTI>(W);
            m = red[0];
            for (int i = 1; i < W; ++i) m = fmaxf(m, red[i]);
        }
        m = (m > NADAVCA_NEG_INF_HALF) ? m : 0.0f;
#pragma unroll
        for (int k = 0; k < S; ++k) q.v[k] = q.v[k] - m;
        acc = acc + m;
    }
    if (live) store_slots<S>(v_out + (size_t)r * B + j0, q.v);
    if (j0 == 0) acc_out[r] = acc;
}

// Floats of one chain warp's table: two buffers of a half-group, HALF sample
// rows of 32 * S emissions, or HALF / 2 pair rows of 64 * S + 32.
template <bool PAIR, int S>
__host__ __device__ constexpr int table_floats() {
    return PAIR ? HALF * (64 * S + 32) : 2 * HALF * 32 * S;
}

// A read's block: W = ceil(B / (32 * S)) chain warps (warps 0 .. W-1), then
// one producer warp for each (warps W .. 2W-1).
template <bool SKIP, bool PAIR, int S, bool MULTI>
__device__ __forceinline__ void fill_body(const float* __restrict__ x,
                                          const int* __restrict__ t_len,
                                          const float* __restrict__ mu,
                                          const float* __restrict__ sigma,
                                          const int* __restrict__ lo,
                                          const int* __restrict__ delta,
                                          const int* __restrict__ n_ref,
                                          int* __restrict__ dec,
                                          int* __restrict__ dec2,
                                          float* __restrict__ v_out,
                                          float* __restrict__ acc_out,
                                          int R, int T, int C, int B, int N,
                                          float log_p_stay, float p1, float p2,
                                          const PairK& pc) {
    constexpr int RING_PLANES = SKIP || PAIR ? 2 : 1;
    extern __shared__ __align__(16) float smem[];
    const int W = (B + 32 * S - 1) / (32 * S);
    float* row = smem;                                      // 32 * S * W: the realign
    float* red = row + 32 * S * W;                          // row maxima of the warps
    int* done = reinterpret_cast<int*>(red + MAX_WARPS);    // groups done, per warp
    int* made = done + MAX_WARPS;                           // halves produced
    int* used = made + MAX_WARPS;                           // halves consumed
    float* ring = reinterpret_cast<float*>(used + MAX_WARPS);
    // ring: [warp][RING_HALVES][RING_PLANES][HALF] edge values (MULTI only);
    // then the tables, [warp][table_floats], 16-byte aligned
    float* table = ring + (MULTI ? (size_t)W * RING_HALVES * RING_PLANES * HALF : 0);

    const int r = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int w = wid < W ? wid : wid - W;  // the chain warp served
    const int j0 = (w * 32 + lane) * S;
    const int tl = t_len[r];
    const int n_chunks = T / C;
    // a producer's own slots (the pair producer places its lanes itself)
    float* tab = table + (size_t)w * table_floats<PAIR, S>() + (PAIR ? 0 : lane * S);
    if (threadIdx.x < MAX_WARPS) {
        done[threadIdx.x] = 0;
        made[threadIdx.x] = 0;
        used[threadIdx.x] = 0;
    }
    __syncthreads();
    if (wid >= W) {
        if constexpr (PAIR)
            produce_pair<S>(x + (size_t)r * T, mu + (size_t)r * N, sigma + (size_t)r * N,
                            lo + (size_t)r * n_chunks, T, C, N, j0, lane, tl, n_ref[r], tab,
                            made + w, used + w);
        else
            produce<SKIP, S>(x + (size_t)r * T, mu + (size_t)r * N, sigma + (size_t)r * N,
                             lo + (size_t)r * n_chunks, T, C, N, j0, lane, tl, n_ref[r],
                             log_p_stay, tab, made + w, used + w);
        return;
    }
    chain<SKIP, PAIR, S, MULTI>(delta + (size_t)r * n_chunks, dec, dec2, v_out, acc_out, R,
                                T, C, B, r, w, W, lane, j0, tl, log_p_stay, p1, p2, pc, tab,
                                made + w, used + w, row, red, done, ring);
}

template <int S, bool MULTI>
__global__ void __launch_bounds__(64 * MAX_WARPS, 1)
viterbi_fill_kernel(const float* __restrict__ x, const int* __restrict__ t_len,
                    const float* __restrict__ mu, const float* __restrict__ sigma,
                    const int* __restrict__ lo, const int* __restrict__ delta,
                    const int* __restrict__ n_ref, int* __restrict__ dec,
                    float* __restrict__ v_out, float* __restrict__ acc_out,
                    int R, int T, int C, int B, int N, float log_p_stay, float dcs) {
    fill_body<false, false, S, MULTI>(x, t_len, mu, sigma, lo, delta, n_ref, dec, nullptr,
                                      v_out, acc_out, R, T, C, B, N, log_p_stay, dcs, 0.0f,
                                      PairK{});
}

template <int S, bool MULTI>
__global__ void __launch_bounds__(64 * MAX_WARPS, 1)
viterbi_fill_skip_kernel(const float* __restrict__ x, const int* __restrict__ t_len,
                         const float* __restrict__ mu, const float* __restrict__ sigma,
                         const int* __restrict__ lo, const int* __restrict__ delta,
                         const int* __restrict__ n_ref, int* __restrict__ dec,
                         int* __restrict__ dec2, float* __restrict__ v_out,
                         float* __restrict__ acc_out, int R, int T, int C, int B, int N,
                         float log_p_stay, float log_p_move, float log_p_skip) {
    fill_body<true, false, S, MULTI>(x, t_len, mu, sigma, lo, delta, n_ref, dec, dec2,
                                     v_out, acc_out, R, T, C, B, N, log_p_stay, log_p_move,
                                     log_p_skip, PairK{});
}

template <int S, bool MULTI>
__global__ void __launch_bounds__(64 * MAX_WARPS, 1)
viterbi_fill_pair_kernel(const float* __restrict__ x, const int* __restrict__ t_len,
                         const float* __restrict__ mu, const float* __restrict__ sigma,
                         const int* __restrict__ lo, const int* __restrict__ delta,
                         const int* __restrict__ n_ref, int* __restrict__ dec,
                         float* __restrict__ v_out, float* __restrict__ acc_out,
                         int R, int T, int C, int B, int N, PairK pc) {
    fill_body<false, true, S, MULTI>(x, t_len, mu, sigma, lo, delta, n_ref, dec, nullptr,
                                     v_out, acc_out, R, T, C, B, N, pc.cs, pc.cm, 0.0f, pc);
}

enum Variant { SINGLE = 0, SKIPPING = 1, PAIRED = 2 };

// The fixed (S, W) table: S slots per lane, W = ceil(B / (32 * S)) chain
// warps. Without skip S = 4; with skip, whose sample is twice the
// instructions, S = 2 up to B = 256, above it S = 4 (W = B / 128, at most 8);
// the two-sample fill S = 2 up to B = 384, then S = 4.
int slots_per_lane(int B, int variant) {
    if (variant == PAIRED) return B <= 384 ? 2 : 4;
    return variant == SKIPPING && B <= 256 ? 2 : 4;
}

// Band widths: the single-step fills take multiples of 32 * S; the
// two-sample fill any multiple of 32 (its last warp's lanes past the band
// run idle), as its first design did.
bool fill_shape_ok(int C, int B, int T, int S, int variant) {
    if (!(S == 2 || S == 4 || S == 8)) return false;
    if (B <= 0 || B > 1024 || B % 32 != 0) return false;
    if (variant != PAIRED && B % (32 * S) != 0) return false;
    if ((B + 32 * S - 1) / (32 * S) > MAX_WARPS) return false;
    return !((C & 31) || C <= 0 || T % C);
}

template <bool PAIR, int S>
size_t fill_shmem(int W, bool skip) {
    const size_t ring = W > 1 ? (size_t)W * RING_HALVES * (skip || PAIR ? 2 : 1) * HALF : 0;
    const size_t tables = (size_t)W * table_floats<PAIR, S>();
    return (32 * S * W + 4 * MAX_WARPS + ring + tables) * sizeof(float);
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <typename K>
cudaError_t allow_shmem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}
#define NADAVCA_FILL_ARGS x, t_len, mu, sigma, lo, delta, n_ref

template <int S>
int launch_fill(const float* x, const int* t_len, const float* mu, const float* sigma,
                const int* lo, const int* delta, const int* n_ref, int* dec,
                float* v_out, float* acc_out, int R, int T, int C, int B, int N,
                float log_p_stay, float dcs, cudaStream_t stream) {
    const int W = B / (32 * S);
    const size_t shmem = fill_shmem<false, S>(W, false);
    if (W > 1) {
        if (cudaError_t e = allow_shmem(viterbi_fill_kernel<S, true>, shmem)) return (int)e;
        viterbi_fill_kernel<S, true><<<R, 64 * W, shmem, stream>>>(
            NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B, N, log_p_stay, dcs);
    } else {
        if (cudaError_t e = allow_shmem(viterbi_fill_kernel<S, false>, shmem)) return (int)e;
        viterbi_fill_kernel<S, false><<<R, 64, shmem, stream>>>(
            NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B, N, log_p_stay, dcs);
    }
    return (int)cudaGetLastError();
}

template <int S>
int launch_fill_skip(const float* x, const int* t_len, const float* mu,
                     const float* sigma, const int* lo, const int* delta,
                     const int* n_ref, int* dec, int* dec2, float* v_out,
                     float* acc_out, int R, int T, int C, int B, int N, float log_p_stay,
                     float log_p_move, float log_p_skip, cudaStream_t stream) {
    const int W = B / (32 * S);
    const size_t shmem = fill_shmem<false, S>(W, true);
    if (W > 1) {
        if (cudaError_t e = allow_shmem(viterbi_fill_skip_kernel<S, true>, shmem))
            return (int)e;
        viterbi_fill_skip_kernel<S, true><<<R, 64 * W, shmem, stream>>>(
            NADAVCA_FILL_ARGS, dec, dec2, v_out, acc_out, R, T, C, B, N, log_p_stay,
            log_p_move, log_p_skip);
    } else {
        if (cudaError_t e = allow_shmem(viterbi_fill_skip_kernel<S, false>, shmem))
            return (int)e;
        viterbi_fill_skip_kernel<S, false><<<R, 64, shmem, stream>>>(
            NADAVCA_FILL_ARGS, dec, dec2, v_out, acc_out, R, T, C, B, N, log_p_stay,
            log_p_move, log_p_skip);
    }
    return (int)cudaGetLastError();
}

template <int S>
int launch_fill_pair(const float* x, const int* t_len, const float* mu,
                     const float* sigma, const int* lo, const int* delta,
                     const int* n_ref, int* dec, float* v_out, float* acc_out, int R,
                     int T, int C, int B, int N, const PairK& pc, cudaStream_t stream) {
    const int W = (B + 32 * S - 1) / (32 * S);
    const size_t shmem = fill_shmem<true, S>(W, false);
    if (W > 1) {
        if (cudaError_t e = allow_shmem(viterbi_fill_pair_kernel<S, true>, shmem))
            return (int)e;
        viterbi_fill_pair_kernel<S, true><<<R, 64 * W, shmem, stream>>>(
            NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B, N, pc);
    } else {
        if (cudaError_t e = allow_shmem(viterbi_fill_pair_kernel<S, false>, shmem))
            return (int)e;
        viterbi_fill_pair_kernel<S, false><<<R, 64, shmem, stream>>>(
            NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B, N, pc);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The table's S for band width B and variant (0 the single-step fill, 1 with
// skip, 2 the two-sample fill; the wrapper reports it, cuda_dp.fill_layout
// mirrors it).
NADAVCA_EXPORT int nadavca_fill_slots_per_lane(int B, int variant) {
    return slots_per_lane(B, variant);
}

// The fill at an explicit S (2, 4 or 8 slots per lane, W = B / (32 * S) warps
// of at most 8): the layouts the table chose between, for timing them. mu,
// sigma: the (R, N) rows of expected levels, from which the producers gather
// the band of each chunk.
NADAVCA_EXPORT int nadavca_viterbi_fill_layout(const float* x, const int* t_len,
                                               const float* mu, const float* sigma,
                                               const int* lo, const int* delta,
                                               const int* n_ref, int* dec,
                                               float* v_out, float* acc_out,
                                               int R, int T, int C, int B, int N,
                                               float log_p_stay, float dcs, int S,
                                               void* stream) {
    if (R == 0) return 0;
    if (!fill_shape_ok(C, B, T, S, SINGLE) || N < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (S) {
    case 2: return launch_fill<2>(NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B, N,
                                  log_p_stay, dcs, st);
    case 4: return launch_fill<4>(NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B, N,
                                  log_p_stay, dcs, st);
    default: return launch_fill<8>(NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B, N,
                                   log_p_stay, dcs, st);
    }
}

NADAVCA_EXPORT int nadavca_viterbi_fill_skip_layout(const float* x, const int* t_len,
                                                    const float* mu, const float* sigma,
                                                    const int* lo, const int* delta,
                                                    const int* n_ref, int* dec, int* dec2,
                                                    float* v_out, float* acc_out,
                                                    int R, int T, int C, int B, int N,
                                                    float log_p_stay, float log_p_move,
                                                    float log_p_skip, int S,
                                                    void* stream) {
    if (R == 0) return 0;
    if (!fill_shape_ok(C, B, T, S, SKIPPING) || N < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (S) {
    case 2: return launch_fill_skip<2>(NADAVCA_FILL_ARGS, dec, dec2, v_out, acc_out, R,
                                       T, C, B, N, log_p_stay, log_p_move, log_p_skip, st);
    case 4: return launch_fill_skip<4>(NADAVCA_FILL_ARGS, dec, dec2, v_out, acc_out, R,
                                       T, C, B, N, log_p_stay, log_p_move, log_p_skip, st);
    default: return launch_fill_skip<8>(NADAVCA_FILL_ARGS, dec, dec2, v_out, acc_out,
                                        R, T, C, B, N, log_p_stay, log_p_move, log_p_skip,
                                        st);
    }
}

// The two-sample fill at an explicit S, W = ceil(B / (32 * S)) <= 8. cs, cm:
// log_p_stay, log_p_move; cs2, csm, cm2 their pair sums.
NADAVCA_EXPORT int nadavca_viterbi_fill_pair_layout(const float* x, const int* t_len,
                                                    const float* mu, const float* sigma,
                                                    const int* lo, const int* delta,
                                                    const int* n_ref, int* dec,
                                                    float* v_out, float* acc_out,
                                                    int R, int T, int C, int B, int N,
                                                    float cs, float cm, float cs2,
                                                    float csm, float cm2, int S,
                                                    void* stream) {
    if (R == 0) return 0;
    if (!fill_shape_ok(C, B, T, S, PAIRED) || N < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const PairK pc{cs, cm, cs2, csm, cm2};
    switch (S) {
    case 2: return launch_fill_pair<2>(NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B,
                                       N, pc, st);
    case 4: return launch_fill_pair<4>(NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C, B,
                                       N, pc, st);
    default: return launch_fill_pair<8>(NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C,
                                        B, N, pc, st);
    }
}

NADAVCA_EXPORT int nadavca_viterbi_fill(const float* x, const int* t_len,
                                        const float* mu, const float* sigma,
                                        const int* lo, const int* delta,
                                        const int* n_ref, int* dec,
                                        float* v_out, float* acc_out,
                                        int R, int T, int C, int B, int N,
                                        float log_p_stay, float dcs,
                                        void* stream) {
    return nadavca_viterbi_fill_layout(NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T, C,
                                       B, N, log_p_stay, dcs, slots_per_lane(B, SINGLE),
                                       stream);
}

NADAVCA_EXPORT int nadavca_viterbi_fill_skip(const float* x, const int* t_len,
                                             const float* mu, const float* sigma,
                                             const int* lo, const int* delta,
                                             const int* n_ref, int* dec, int* dec2,
                                             float* v_out, float* acc_out,
                                             int R, int T, int C, int B, int N,
                                             float log_p_stay, float log_p_move,
                                             float log_p_skip, void* stream) {
    return nadavca_viterbi_fill_skip_layout(NADAVCA_FILL_ARGS, dec, dec2, v_out, acc_out,
                                            R, T, C, B, N, log_p_stay, log_p_move,
                                            log_p_skip, slots_per_lane(B, SKIPPING), stream);
}

NADAVCA_EXPORT int nadavca_viterbi_fill_pair(const float* x, const int* t_len,
                                             const float* mu, const float* sigma,
                                             const int* lo, const int* delta,
                                             const int* n_ref, int* dec,
                                             float* v_out, float* acc_out,
                                             int R, int T, int C, int B, int N,
                                             float cs, float cm, float cs2, float csm,
                                             float cm2, void* stream) {
    return nadavca_viterbi_fill_pair_layout(NADAVCA_FILL_ARGS, dec, v_out, acc_out, R, T,
                                            C, B, N, cs, cm, cs2, csm, cm2,
                                            slots_per_lane(B, PAIRED), stream);
}

// The message of a CUDA error code, for the wrappers' exceptions.
NADAVCA_EXPORT const char* nadavca_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
