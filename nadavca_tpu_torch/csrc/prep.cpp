// Native host-side read preprocessing for nadavca_tpu.
//
// The TPU device path runs at ~10k reads/s per chip, so the per-read Python
// host work (normalize → seed-and-vote anchor → move-table composition →
// expected levels → calibration fit) becomes the pipeline bottleneck
// (~2.4 ms/read measured). This file is the native equivalent of
// nadavca_tpu/pipeline.preprocess_read + anchor.SeedIndex/anchor_basecall/
// signal_anchor_path + io.fast5.normalize_signal + KmerModel.expected_signal
// — same algorithms, same numeric conventions (numpy median/MAD, np.cov's
// ddof=1 over np.var's ddof=0, round-half-even), so outputs are
// interchangeable with the Python path (tests/test_prep_native.py checks
// exact anchor/path parity and float-tolerance signal parity).
//
// Role parity note: the reference tool shells out to bwa for anchoring and
// does normalization in Python (SURVEY.md "Approximate aligner" row;
// reconstructed — reference mount empty); this rebuild keeps the whole prep
// path in-process and native.
//
// Exposed via ctypes (see nadavca_tpu/prep_native.py); no pybind11 in this
// environment.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int8_t kComplement[5] = {3, 2, 1, 0, 4};

struct SeedIndex {
  int seed_k;
  std::vector<int8_t> codes;          // concatenated contig codes
  std::vector<int64_t> contig_start;  // (n_contigs + 1)
  // sorted by id; pos is position within contig
  std::vector<int32_t> ids;
  std::vector<int64_t> pos;
  std::vector<int32_t> contig;
};

// kmer id at a fixed position; -1 if any non-ACGT base
inline int32_t kmer_id_at(const int8_t* c, int k) {
  int64_t id = 0;
  for (int o = 0; o < k; ++o) {
    if (c[o] > 3) return -1;
    id = id * 4 + c[o];
  }
  return static_cast<int32_t>(id);
}

void kmer_ids(const int8_t* c, int64_t n_codes, int k,
              std::vector<int32_t>* out) {
  int64_t n = n_codes - k + 1;
  out->clear();
  if (n <= 0) return;
  out->resize(n);
  // rolling update with a "last bad base" tracker (O(n) not O(nk))
  int64_t id = 0;
  int64_t last_bad = -1;
  const int64_t mask = (int64_t(1) << (2 * k)) - 1;
  for (int64_t i = 0; i < n_codes; ++i) {
    int8_t b = c[i];
    if (b > 3) last_bad = i;
    id = ((id << 2) | (b & 3)) & mask;
    int64_t p = i - k + 1;
    if (p >= 0) (*out)[p] = (last_bad >= p) ? -1 : static_cast<int32_t>(id);
  }
}

// numpy-convention median of a scratch copy (even count: mean of middles)
double median_inplace(std::vector<double>* v) {
  size_t n = v->size();
  if (n == 0) return 0.0;
  size_t m = n / 2;
  std::nth_element(v->begin(), v->begin() + m, v->end());
  double hi = (*v)[m];
  if (n % 2 == 1) return hi;
  double lo = *std::max_element(v->begin(), v->begin() + m);
  return 0.5 * (lo + hi);
}

}  // namespace

extern "C" {

void* prep_index_build(const int8_t* codes, const int64_t* contig_start,
                       int32_t n_contigs, int32_t seed_k) {
  auto* h = new SeedIndex;
  h->seed_k = seed_k;
  int64_t total = contig_start[n_contigs];
  h->codes.assign(codes, codes + total);
  h->contig_start.assign(contig_start, contig_start + n_contigs + 1);

  std::vector<int32_t> ids;
  for (int32_t ci = 0; ci < n_contigs; ++ci) {
    int64_t s = contig_start[ci], e = contig_start[ci + 1];
    kmer_ids(codes + s, e - s, seed_k, &ids);
    for (int64_t p = 0; p < static_cast<int64_t>(ids.size()); ++p) {
      if (ids[p] >= 0) {
        h->ids.push_back(ids[p]);
        h->pos.push_back(p);
        h->contig.push_back(ci);
      }
    }
  }
  // stable sort by id keeps (contig, pos) order within equal ids, matching
  // numpy's stable argsort in anchor.SeedIndex
  std::vector<int64_t> order(h->ids.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return h->ids[a] < h->ids[b];
  });
  SeedIndex sorted;
  sorted.ids.reserve(order.size());
  sorted.pos.reserve(order.size());
  sorted.contig.reserve(order.size());
  for (int64_t i : order) {
    sorted.ids.push_back(h->ids[i]);
    sorted.pos.push_back(h->pos[i]);
    sorted.contig.push_back(h->contig[i]);
  }
  h->ids.swap(sorted.ids);
  h->pos.swap(sorted.pos);
  h->contig.swap(sorted.contig);
  return h;
}

void prep_index_free(void* handle) { delete static_cast<SeedIndex*>(handle); }

// Per-read preprocessing. Returns 0 on success, 1 if unanchored, 2 if the
// anchored window exceeds the caller's buffer capacity (caller falls back).
//
// norm_method: 0 = median/MAD, 1 = mean/std. level_mean/level_std may be
// null to skip the calibration fit (then out_signal is just normalized).
// out_meta: [contig, strand, ref_start, ref_end, votes].
int prep_read(void* handle, const float* signal_pa, int64_t T,
              int32_t norm_method, const int8_t* basecall, int64_t n_bases,
              const int64_t* move_index, const float* level_mean,
              const float* level_std, int32_t model_k, int32_t seed_stride,
              int32_t diag_bin, int32_t min_votes, int32_t margin,
              int64_t window_cap, float* out_signal, double* out_path,
              int32_t* out_meta, int8_t* out_window, int64_t* out_wlen,
              float* out_mu, float* out_sigma, int64_t* out_nref) {
  const auto& idx = *static_cast<SeedIndex*>(handle);
  const int k = idx.seed_k;
  if (n_bases - k + 1 <= 0 || T <= 0) return 1;

  // ---- normalize (numpy median / MAD conventions, float64 math)
  std::vector<double> x64(T);
  {
    std::vector<double> scratch(T);
    for (int64_t t = 0; t < T; ++t) scratch[t] = x64[t] = signal_pa[t];
    double shift, scale;
    if (norm_method == 0) {
      double med = median_inplace(&scratch);
      for (int64_t t = 0; t < T; ++t) scratch[t] = std::fabs(x64[t] - med);
      double mad = median_inplace(&scratch);
      shift = med;
      if (mad > 0) {
        scale = 1.4826 * mad;
      } else {
        double m = 0, s2 = 0;
        for (double v : x64) m += v;
        m /= T;
        for (double v : x64) s2 += (v - m) * (v - m);
        scale = std::sqrt(s2 / T);
        if (scale == 0) scale = 1.0;
      }
    } else {
      double m = 0, s2 = 0;
      for (double v : x64) m += v;
      m /= T;
      for (double v : x64) s2 += (v - m) * (v - m);
      shift = m;
      scale = std::sqrt(s2 / T);
      if (scale == 0) scale = 1.0;
    }
    for (int64_t t = 0; t < T; ++t) x64[t] = (x64[t] - shift) / scale;
  }

  // ---- seed-and-vote anchoring (anchor.anchor_basecall, same parameters)
  struct Best {
    int64_t votes = -1;
    int strand = 0, ci = 0;
    int64_t lo_pos = 0, hi_pos = 0, first_off = 0, last_off = 0;
  } best;
  std::vector<int8_t> rc(n_bases);
  for (int64_t i = 0; i < n_bases; ++i)
    rc[i] = kComplement[basecall[n_bases - 1 - i]];
  std::vector<int32_t> qids;
  std::vector<std::pair<int64_t, int64_t>> hits;  // (vote key, hit index)
  std::vector<int64_t> hit_pos, hit_off;
  std::vector<int32_t> hit_contig;
  for (int strand : {+1, -1}) {
    const int8_t* c = strand > 0 ? basecall : rc.data();
    kmer_ids(c, n_bases, k, &qids);
    hits.clear();
    hit_pos.clear();
    hit_off.clear();
    hit_contig.clear();
    for (int64_t q = 0; q < static_cast<int64_t>(qids.size());
         q += seed_stride) {
      int32_t id = qids[q];
      if (id < 0) continue;
      auto lo = std::lower_bound(idx.ids.begin(), idx.ids.end(), id);
      auto hi = std::upper_bound(lo, idx.ids.end(), id);
      for (auto it = lo; it != hi; ++it) {
        int64_t i = it - idx.ids.begin();
        int64_t p = idx.pos[i];
        // floor division like numpy's // on possibly-negative numerators
        int64_t num = p - q;
        int64_t diag = num >= 0 ? num / diag_bin
                                : -((-num + diag_bin - 1) / diag_bin);
        int64_t key = static_cast<int64_t>(idx.contig[i]) * (int64_t(1) << 40)
                      + (diag + (int64_t(1) << 30));
        hits.emplace_back(key, static_cast<int64_t>(hit_pos.size()));
        hit_pos.push_back(p);
        hit_off.push_back(q);
        hit_contig.push_back(idx.contig[i]);
      }
    }
    if (hits.empty()) continue;
    std::sort(hits.begin(), hits.end());
    // histogram over sorted keys; argmax = first max (numpy argmax on the
    // sorted-unique array)
    int64_t best_key = 0, best_cnt = -1;
    for (size_t i = 0; i < hits.size();) {
      size_t j = i;
      while (j < hits.size() && hits[j].first == hits[i].first) ++j;
      if (static_cast<int64_t>(j - i) > best_cnt) {
        best_cnt = j - i;
        best_key = hits[i].first;
      }
      i = j;
    }
    // merge the two adjacent diagonal bins
    int64_t votes = 0;
    for (size_t i = 0; i < hits.size();) {
      size_t j = i;
      while (j < hits.size() && hits[j].first == hits[i].first) ++j;
      if (hits[i].first >= best_key - 1 && hits[i].first <= best_key + 1)
        votes += j - i;
      i = j;
    }
    if (votes > best.votes) {
      int32_t ci = static_cast<int32_t>(best_key >> 40);
      int64_t dg = (best_key & ((int64_t(1) << 40) - 1)) - (int64_t(1) << 30);
      int64_t lo_pos = INT64_MAX, hi_pos = INT64_MIN;
      int64_t first_off = INT64_MAX, last_off = INT64_MIN;
      for (size_t i = 0; i < hits.size(); ++i) {
        int64_t hidx = hits[i].second;
        if (hit_contig[hidx] != ci) continue;
        int64_t num = hit_pos[hidx] - hit_off[hidx];
        int64_t diag = num >= 0 ? num / diag_bin
                                : -((-num + diag_bin - 1) / diag_bin);
        if (std::llabs(diag - dg) > 1) continue;
        lo_pos = std::min(lo_pos, hit_pos[hidx]);
        hi_pos = std::max(hi_pos, hit_pos[hidx]);
        first_off = std::min(first_off, hit_off[hidx]);
        last_off = std::max(last_off, hit_off[hidx]);
      }
      best = {votes, strand, ci, lo_pos, hi_pos + k, first_off, last_off};
    }
  }
  if (best.votes < min_votes) return 1;

  const int64_t clen =
      idx.contig_start[best.ci + 1] - idx.contig_start[best.ci];
  int64_t start = std::max<int64_t>(0, best.lo_pos - best.first_off - margin);
  int64_t end = std::min<int64_t>(
      clen, best.hi_pos + (n_bases - best.last_off - k) + margin);
  int64_t wlen = end - start;
  if (wlen <= 0) return 1;
  if (wlen > window_cap) return 2;
  double base0 = best.strand > 0
                     ? static_cast<double>((best.lo_pos - start) -
                                           best.first_off)
                     : static_cast<double>((end - best.lo_pos - n_bases) +
                                           best.first_off);

  // ---- window codes (revcomp for reverse strand)
  const int8_t* gc = idx.codes.data() + idx.contig_start[best.ci];
  if (best.strand > 0) {
    std::memcpy(out_window, gc + start, wlen);
  } else {
    for (int64_t i = 0; i < wlen; ++i)
      out_window[i] = kComplement[gc[end - 1 - i]];
  }
  *out_wlen = wlen;

  // ---- anchor path: compose base→window with the move table, running max
  {
    double run = -1e300;
    int64_t b = 0;
    for (int64_t t = 0; t < T; ++t) {
      while (b + 1 < n_bases && move_index[b + 1] <= t) ++b;
      // searchsorted(right) - 1 clipped at 0: before the first move, b = 0
      double v = base0 + static_cast<double>(b);
      run = std::max(run, v);
      out_path[t] = run;
    }
  }

  // ---- expected levels of the window
  int64_t n_ref = 0;
  if (level_mean != nullptr) {
    std::vector<int32_t> wids;
    kmer_ids(out_window, wlen, model_k, &wids);
    n_ref = static_cast<int64_t>(wids.size());
    for (int64_t i = 0; i < n_ref; ++i) {
      if (wids[i] >= 0) {
        out_mu[i] = level_mean[wids[i]];
        out_sigma[i] = level_std[wids[i]];
      } else {
        out_mu[i] = 0.0f;
        out_sigma[i] = 1.0f;
      }
    }
    *out_nref = n_ref;
  } else {
    *out_nref = 0;
  }

  // ---- trimmed linear calibration fit (pipeline.preprocess_read: np.cov's
  // ddof=1 numerator over np.var's ddof=0 denominator, resid over ALL
  // samples, keep-mask refit, round-half-even path indexing)
  for (int64_t t = 0; t < T; ++t) out_signal[t] = static_cast<float>(x64[t]);
  if (level_mean != nullptr && n_ref > 1) {
    std::vector<double> pred(T);
    for (int64_t t = 0; t < T; ++t) {
      int64_t ap = static_cast<int64_t>(std::nearbyint(out_path[t]));
      ap = std::min(std::max<int64_t>(ap, 0), n_ref - 1);
      pred[t] = out_mu[ap];
    }
    std::vector<uint8_t> keep(T, 1);
    std::vector<double> resid(T);
    for (int pass = 0; pass < 2; ++pass) {
      int64_t nk = 0;
      double mp = 0, mx = 0;
      for (int64_t t = 0; t < T; ++t)
        if (keep[t]) {
          ++nk;
          mp += pred[t];
          mx += x64[t];
        }
      if (nk < 16) break;
      mp /= nk;
      mx /= nk;
      double spp = 0, spx = 0, sxx = 0;
      for (int64_t t = 0; t < T; ++t)
        if (keep[t]) {
          double dp = pred[t] - mp, dx = x64[t] - mx;
          spp += dp * dp;
          spx += dp * dx;
          sxx += dx * dx;
        }
      double vp = spp / nk;  // np.var, ddof = 0
      if (vp < 1e-6) break;
      double aa = (spx / (nk - 1)) / vp;  // np.cov, ddof = 1
      double bb = mx - aa * mp;
      double sr = 0, sr2 = 0;
      for (int64_t t = 0; t < T; ++t) resid[t] = x64[t] - (aa * pred[t] + bb);
      for (int64_t t = 0; t < T; ++t)
        if (keep[t]) {
          sr += resid[t];
          sr2 += resid[t] * resid[t];
        }
      double rs = std::sqrt(sr2 / nk - (sr / nk) * (sr / nk));
      double r2 = 1.0 - (sr2 / nk) / std::max(sxx / nk, 1e-9);
      if (aa > 0.5 && aa < 2.0 && r2 > 0.5)
        for (int64_t t = 0; t < T; ++t)
          out_signal[t] = static_cast<float>((x64[t] - bb) / aa);
      for (int64_t t = 0; t < T; ++t) keep[t] = std::fabs(resid[t]) < 3.0 * rs;
    }
  }

  out_meta[0] = best.ci;
  out_meta[1] = best.strand;
  out_meta[2] = static_cast<int32_t>(start);
  out_meta[3] = static_cast<int32_t>(end);
  out_meta[4] = static_cast<int32_t>(best.votes);
  return 0;
}

}  // extern "C"
