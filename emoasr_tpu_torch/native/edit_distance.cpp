// Native edit-distance kernel for corpus WER scoring.
//
// The reference computes WER with a per-cell Python DP
// (emoASR asr/metrics.py:20-105) -- O(N^2) interpreted ops per
// utterance pair, the bottleneck of corpus-level scoring and of the
// rescoring grid (which re-scores the corpus per weight pair).  This kernel
// runs the same DP in C++ with OpenMP-free std::thread parallelism across
// utterances and returns the S/I/D/C counts with the reference's backtrace
// priority (C > I > S > D) so breakdowns match bit-for-bit.
//
// Exposed via a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Counts {
  int32_t n_sub, n_ins, n_del, n_ref;
};

// One (hyp, ref) pair: ints as token ids.
Counts edit_distance_pair(const int32_t* ref, int32_t rlen, const int32_t* hyp,
                          int32_t hlen) {
  const int W = hlen + 1;
  std::vector<uint16_t> d((rlen + 1) * W);
  for (int j = 0; j <= hlen; ++j) d[j] = static_cast<uint16_t>(j);
  for (int i = 1; i <= rlen; ++i) {
    d[i * W] = static_cast<uint16_t>(i);
    const uint16_t* prev = &d[(i - 1) * W];
    uint16_t* row = &d[i * W];
    const int32_t r = ref[i - 1];
    for (int j = 1; j <= hlen; ++j) {
      uint16_t best = static_cast<uint16_t>(
          prev[j - 1] + (r == hyp[j - 1] ? 0 : 1));
      best = std::min<uint16_t>(best, static_cast<uint16_t>(row[j - 1] + 1));
      best = std::min<uint16_t>(best, static_cast<uint16_t>(prev[j] + 1));
      row[j] = best;
    }
  }

  // backtrace with the reference's priority: C, I, S, D
  Counts c{0, 0, 0, rlen};
  int x = rlen, y = hlen;
  while (!(x == 0 && y == 0)) {
    if (x > 0 && y > 0) {
      if (d[x * W + y] == d[(x - 1) * W + (y - 1)] && ref[x - 1] == hyp[y - 1]) {
        --x; --y;
      } else if (d[x * W + y] == d[x * W + (y - 1)] + 1) {
        ++c.n_ins; --y;
      } else if (d[x * W + y] == d[(x - 1) * W + (y - 1)] + 1) {
        ++c.n_sub; --x; --y;
      } else {
        ++c.n_del; --x;
      }
    } else if (x == 0) {
      if (d[y] == d[y - 1] + 1) { ++c.n_ins; --y; }
      else { ++c.n_del; --x; }
    } else {
      ++c.n_del; --x;
    }
  }
  return c;
}

}  // namespace

extern "C" {

// Batched corpus scoring.
//  refs/hyps: concatenated token ids; *_offsets: n+1 prefix offsets.
//  out: (n, 4) int32 rows [n_sub, n_ins, n_del, n_ref].
void batch_edit_distance(const int32_t* refs, const int64_t* ref_offsets,
                         const int32_t* hyps, const int64_t* hyp_offsets,
                         int64_t n, int32_t* out, int32_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t rlen = static_cast<int32_t>(ref_offsets[i + 1] - ref_offsets[i]);
      const int32_t hlen = static_cast<int32_t>(hyp_offsets[i + 1] - hyp_offsets[i]);
      Counts c = edit_distance_pair(refs + ref_offsets[i], rlen,
                                    hyps + hyp_offsets[i], hlen);
      out[i * 4 + 0] = c.n_sub;
      out[i * 4 + 1] = c.n_ins;
      out[i * 4 + 2] = c.n_del;
      out[i * 4 + 3] = c.n_ref;
    }
  };
  if (num_threads == 1 || n < 2 * num_threads) {
    work(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
