// CPU reference implementation of the banded Viterbi + local SNP rescoring.
//
// Role: the measured CPU baseline for BASELINE.md (the reference tool
// publishes no numbers and is not installable in this sandbox — SURVEY.md §6
// — so this single-core C++ implementation of the same spec, equivalent in
// shape to the reference's nadavca.dtw C++ extension, is the denominator for
// the ">=50x vs CPU" target). Implements exactly the recurrence of
// nadavca_tpu/ops/dp_spec.py; results are asserted against the spec in tests.
//
// Build: g++ -O3 -shared -fPIC -o libbanded_dp.so banded_dp.cpp
// Called from Python via ctypes (nadavca_tpu/ops/cpu_ref.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr float NEG_INF = -1e30f;
constexpr float HALF_LOG_2PI = 0.91893853320467274178f;

inline float gauss_logpdf(float x, float mu, float sigma) {
  float z = (x - mu) / sigma;
  return -0.5f * z * z - std::log(sigma) - HALF_LOG_2PI;
}
}  // namespace

extern "C" {

// Banded Viterbi fill + backtrack for one read.
//   x[T]           normalized signal
//   mu[N], sg[N]   expected level mean/std per reference k-mer position
//   lo[T]          nondecreasing band start per sample, in [0, max(N-B,0)]
//   B              band width
//   use_skip       nonzero enables the advance-by-2 transition at lp_skip
// Outputs: *score, path[T] (k-mer position per sample).
// Returns 0 on success.
int banded_viterbi(const float* x, int64_t T, const float* mu, const float* sg,
                   int64_t N, const int32_t* lo, int32_t B, float lp_stay,
                   float lp_move, float lp_skip, int32_t use_skip,
                   float* score, int32_t* path) {
  if (T <= 0 || N <= 0) return 1;
  int64_t Bw = B < N ? B : N;
  std::vector<float> V(Bw), Vp(Bw);
  std::vector<uint8_t> dec(static_cast<size_t>(T) * Bw);

  for (int64_t j = 0; j < Bw; ++j) {
    int64_t i = lo[0] + j;
    V[j] = (i < N) ? gauss_logpdf(x[0], mu[i], sg[i]) : NEG_INF;
  }
  for (int64_t t = 1; t < T; ++t) {
    Vp.swap(V);
    int64_t d = lo[t] - lo[t - 1];
    uint8_t* dt = &dec[static_cast<size_t>(t) * Bw];
    for (int64_t j = 0; j < Bw; ++j) {
      int64_t js = j + d;       // stay source
      int64_t jm = j + d - 1;   // move source
      float stay = (js >= 0 && js < Bw) ? Vp[js] + lp_stay : NEG_INF;
      float move = (jm >= 0 && jm < Bw) ? Vp[jm] + lp_move : NEG_INF;
      float best;
      uint8_t adv;
      // strict > keeps the spec's first-max tie rule: stay > move > skip
      if (move > stay) {
        best = move;
        adv = 1;
      } else {
        best = stay;
        adv = 0;
      }
      if (use_skip) {
        int64_t jk = j + d - 2;  // skip source (advance by 2)
        float skip = (jk >= 0 && jk < Bw) ? Vp[jk] + lp_skip : NEG_INF;
        if (skip > best) {
          best = skip;
          adv = 2;
        }
      }
      int64_t i = lo[t] + j;
      if (best > NEG_INF / 2 && i < N) {
        V[j] = gauss_logpdf(x[t], mu[i], sg[i]) + best;
        dt[j] = adv;
      } else {
        V[j] = NEG_INF;
        dt[j] = 0;
      }
    }
  }
  // final argmax over valid cells
  int64_t jbest = 0;
  float sbest = NEG_INF;
  for (int64_t j = 0; j < Bw; ++j) {
    if (lo[T - 1] + j < N && V[j] > sbest) {
      sbest = V[j];
      jbest = j;
    }
  }
  *score = sbest;
  int64_t j = jbest;
  path[T - 1] = static_cast<int32_t>(lo[T - 1] + j);
  for (int64_t t = T - 1; t > 0; --t) {
    int64_t d = lo[t] - lo[t - 1];
    j = j + d - dec[static_cast<size_t>(t) * Bw + j];
    path[t - 1] = static_cast<int32_t>(lo[t - 1] + j);
  }
  return 0;
}

// Local re-DP base-substitution log-likelihoods for one read.
//   codes[L]        encoded window bases (0..3; >3 skipped)
//   path[T]         Viterbi path (k-mer positions)
//   level_mean/std  4^k model tables
// Output: out[L*4], reference base column = 0.
int base_loglik_local(const float* x, int64_t T, const int32_t* codes,
                      int64_t L, const int32_t* path, const float* level_mean,
                      const float* level_std, int32_t k, float lp_stay,
                      float lp_move, int32_t max_window, float* out) {
  int64_t N = L - k + 1;
  if (N <= 0 || T <= 0) return 1;
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(L) * 4);

  // kmer ids + segment bounds
  std::vector<int64_t> ids(N, -1);
  {
    int64_t id = 0, bad = 0;
    // rolling id over window
    for (int64_t p = 0; p < N; ++p) {
      id = 0;
      bad = 0;
      for (int32_t o = 0; o < k; ++o) {
        int32_t b = codes[p + o];
        if (b > 3) bad = 1;
        id = id * 4 + (b & 3);
      }
      ids[p] = bad ? -1 : id;
    }
  }
  // segment bounds by bisection on the monotone path: cnt[i] = #{t : path[t]
  // < i}, so S = cnt[p_lo] and E = cnt[p_hi + 1]. Stays correct for skip
  // paths (a skipped position has an empty sample range) — matches
  // dp_spec.base_substitution_loglik_local's searchsorted semantics.
  std::vector<int64_t> cnt(N + 1, 0);
  {
    int64_t t = 0;
    for (int64_t i = 0; i <= N; ++i) {
      while (t < T && path[t] < i) ++t;
      cnt[i] = t;
    }
  }
  int64_t first_pos = path[0], last_pos = path[T - 1];

  std::vector<int64_t> pow4(k);
  pow4[k - 1] = 1;
  for (int32_t o = k - 2; o >= 0; --o) pow4[o] = pow4[o + 1] * 4;

  std::vector<float> V(k), Vp(k), dmu(k), dsg(k);
  for (int64_t i = 0; i < L; ++i) {
    int32_t ref = codes[i];
    if (ref > 3) continue;
    int64_t p_lo = i - k + 1;
    if (p_lo < 0) p_lo = 0;
    int64_t p_hi = i < N - 1 ? i : N - 1;
    if (p_lo < first_pos) p_lo = first_pos;
    if (p_hi > last_pos) p_hi = last_pos;
    if (p_hi < p_lo) continue;
    bool bad = false;
    for (int64_t p = p_lo; p <= p_hi; ++p)
      if (ids[p] < 0) bad = true;
    if (bad) continue;
    int64_t S = cnt[p_lo], E = cnt[p_hi + 1];
    if (E <= S) continue;
    if (E - S > max_window) E = S + max_window;
    int64_t kk = p_hi - p_lo + 1;
    float scores[4];
    for (int32_t b = 0; b < 4; ++b) {
      for (int64_t jj = 0; jj < kk; ++jj) {
        int64_t p = p_lo + jj;
        int64_t o = i - p;
        int64_t nid = (o >= 0 && o < k) ? ids[p] + (int64_t)(b - ref) * pow4[o]
                                        : ids[p];
        dmu[jj] = level_mean[nid];
        dsg[jj] = level_std[nid];
      }
      for (int64_t jj = 0; jj < kk; ++jj) V[jj] = NEG_INF;
      V[0] = gauss_logpdf(x[S], dmu[0], dsg[0]);
      for (int64_t t = S + 1; t < E; ++t) {
        for (int64_t jj = 0; jj < kk; ++jj) Vp[jj] = V[jj];
        for (int64_t jj = 0; jj < kk; ++jj) {
          float stay = Vp[jj] + lp_stay;
          float move = jj > 0 ? Vp[jj - 1] + lp_move : NEG_INF;
          V[jj] = gauss_logpdf(x[t], dmu[jj], dsg[jj]) +
                  (move > stay ? move : stay);
        }
      }
      scores[b] = V[kk - 1];
    }
    for (int32_t b = 0; b < 4; ++b) out[i * 4 + b] = scores[b] - scores[ref];
  }
  return 0;
}

}  // extern "C"
