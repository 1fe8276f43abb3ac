// Measured single-core CPU baseline for the multi-MUM/MEM pipeline.
//
// Purpose: the reference C++ cannot be compiled offline
// (its thirdparty deps are FetchContent'd from GitHub), so this standalone,
// dependency-free single-core implementation of the same pipeline provides
// the measured "single-core C++" denominator for bench.py's vs_baseline.
//
// Architecture mirrors the reference's direct path (-g,
// /root/reference/include/direct_gsacak.hpp:50-116): full text + {1,0}
// sentinels -> suffix array -> LCP -> BWT -> doc array -> one streaming
// pass of the LCP-interval stack match finder. All algorithms are written
// from scratch:
//   * SA-IS induced-sorting suffix array (Nong/Zhang/Chan algorithm, the
//     same family as the reference's gsacak dependency) — no code taken
//     from gsa-is.
//   * Kasai et al. LCP construction.
//   * LCP-interval stack with the reference's five emission conditions
//     (semantics re-derived from /root/reference/include/mem_finder.hpp:
//     update :161-170, update_mems :304-355, check_doc_range :265-289,
//     left-maximality via last_bwt_change :189-208, write_mum coordinate
//     transform + strand canonicalization :357-428, write_mem :210-263).
//
// Build: python native/build_baseline.py
//   (g++ -O3 -march=native -funroll-loops, the reference's own release
//    flags, CMakeModules/ConfigureCompilerGcc.cmake:120)
//
// Usage:
//   baseline_cpu TEXT_FILE LENGTHS_FILE L K F_DOC F_TOTAL NO_MAX_FREQ RC REPS
// where TEXT_FILE is the raw concatenated collection bytes (per-doc
// "fwd$" or "fwd$rc$" layout, no trailing sentinels) and LENGTHS_FILE has
// one per-doc text length (incl. terminators) per line. Prints ONE JSON
// line with match count, checksums, and per-stage single-thread wall times.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double seconds_since(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

// ---------------------------------------------------------------------------
// SA-IS suffix array (induced sorting), written from the published algorithm.
// Requires s[n-1] to be a unique, smallest sentinel. Alphabet [0, K).
// ---------------------------------------------------------------------------

template <typename CharT>
void sais(const CharT* s, int32_t* sa, int32_t n, int32_t K) {
  if (n == 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  // Suffix types: true = S-type, false = L-type; the sentinel is S.
  std::vector<bool> is_s(n);
  is_s[n - 1] = true;
  for (int32_t i = n - 2; i >= 0; --i)
    is_s[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[i + 1]);
  auto is_lms = [&](int32_t i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

  std::vector<int32_t> bkt(K);
  auto fill_buckets = [&](bool ends) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (int32_t i = 0; i < n; ++i) ++bkt[s[i]];
    int32_t sum = 0;
    for (int32_t c = 0; c < K; ++c) {
      sum += bkt[c];
      bkt[c] = ends ? sum : sum - bkt[c];
    }
  };

  auto induce = [&]() {
    // L-types left-to-right from bucket heads.
    fill_buckets(false);
    for (int32_t i = 0; i < n; ++i) {
      int32_t j = sa[i];
      if (j > 0 && !is_s[j - 1]) sa[bkt[s[j - 1]]++] = j - 1;
    }
    // S-types right-to-left from bucket tails.
    fill_buckets(true);
    for (int32_t i = n - 1; i >= 0; --i) {
      int32_t j = sa[i];
      if (j > 0 && is_s[j - 1]) sa[--bkt[s[j - 1]]] = j - 1;
    }
  };

  // Stage 1: approximately sort LMS suffixes by one induction round.
  std::fill(sa, sa + n, -1);
  fill_buckets(true);
  for (int32_t i = 1; i < n; ++i)
    if (is_lms(i)) sa[--bkt[s[i]]] = i;
  induce();

  // Compact the now-sorted LMS substrings to the front.
  int32_t n1 = 0;
  for (int32_t i = 0; i < n; ++i)
    if (is_lms(sa[i])) sa[n1++] = sa[i];

  // Name LMS substrings; equal substrings get equal names.
  std::fill(sa + n1, sa + n, -1);
  int32_t name = 0;
  int32_t prev = -1;
  for (int32_t i = 0; i < n1; ++i) {
    int32_t pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int32_t d = 0; d < n; ++d) {
        if (s[pos + d] != s[prev + d] ||
            is_s[pos + d] != is_s[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  for (int32_t i = n - 1, j = n - 1; i >= n1; --i)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // Recurse on the reduced string if names collide.
  int32_t* s1 = sa + n - n1;
  if (name < n1) {
    sais<int32_t>(s1, sa, n1, name);
  } else {
    for (int32_t i = 0; i < n1; ++i) sa[s1[i]] = i;
  }

  // Stage 2: place LMS suffixes in their true order, induce the rest.
  for (int32_t i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) s1[j++] = i;
  for (int32_t i = 0; i < n1; ++i) sa[i] = s1[sa[i]];
  std::fill(sa + n1, sa + n, -1);
  fill_buckets(true);
  for (int32_t i = n1 - 1; i >= 0; --i) {
    int32_t j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
  }
  induce();
}

// ---------------------------------------------------------------------------
// Kasai LCP: lcp[r] = LCP(suffix sa[r-1], suffix sa[r]), lcp[0] = 0.
// ---------------------------------------------------------------------------

void kasai_lcp(const uint8_t* s, const int32_t* sa, int32_t* lcp, int32_t n) {
  std::vector<int32_t> isa(n);
  for (int32_t r = 0; r < n; ++r) isa[sa[r]] = r;
  int32_t h = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t r = isa[i];
    if (r > 0) {
      int32_t j = sa[r - 1];
      while (i + h < n && j + h < n && s[i + h] == s[j + h]) ++h;
      lcp[r] = h;
      if (h) --h;
    } else {
      lcp[r] = 0;
      h = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Streaming LCP-interval stack match finder (reference semantics; see the
// citations in the file header). Counts emitted matches and accumulates
// order-independent checksums for cross-validation against the engine.
// ---------------------------------------------------------------------------

struct MatchOptions {
  int64_t min_match_len = 20;
  int64_t num_distinct = 0;   // k, already normalized to absolute
  int64_t max_doc_freq = 1;   // f (0 = unlimited); MUM mode iff f == 1
  int64_t max_total_freq = 0; // F
  bool no_max_freq = true;    // F unbounded
  bool use_revcomp = true;
};

struct Interval {
  int64_t start;
  int64_t len;
  int64_t prev_lcp;
};

class StackFinder {
 public:
  StackFinder(const MatchOptions& o, int64_t num_docs,
              const std::vector<int64_t>& seq_lengths,
              const int32_t* sa, const int32_t* da, const uint8_t* bwt)
      : o_(o), num_docs_(num_docs), sa_(sa), da_(da), bwt_(bwt) {
    doc_offsets_.resize(num_docs, 0);
    doc_lens_.assign(seq_lengths.begin(), seq_lengths.end());
    int64_t s = 0;
    for (int64_t i = 0; i + 1 < num_docs; ++i) {
      s += doc_lens_[i];
      doc_offsets_[i + 1] = s;
    }
    if (o.use_revcomp)
      for (auto& d : doc_lens_) d /= 2;
    stack_.push_back({0, 0, 0});
    counts_.assign(num_docs + 1, 0);
    offsets_.assign(num_docs, -1);
    strands_.assign(num_docs, 0);
  }

  // Per-SA-row update (stream contract, direct_gsacak.hpp:96-116; order of
  // operations matches mem_finder::update, mem_finder.hpp:161-170: intervals
  // are closed BEFORE this row's BWT char affects last_bwt_change).
  void update(int64_t j, int64_t lcp) {
    update_mems(j, lcp);
    if (j == 0 || bwt_[j] != bwt_[j - 1]) last_bwt_change_ = j;
    prev_lcp_ = lcp;
  }

  uint64_t matches = 0;
  uint64_t sum_len = 0;
  uint64_t occ_hash = 0;

 private:
  bool check_bwt_range(int64_t start) const {
    // all BWT chars equal over [start..j-1] iff no change after `start`
    return last_bwt_change_ <= start;
  }

  bool check_doc_range(int64_t start, int64_t end) {
    // distinct-doc count and per-doc frequency over the SA interval
    // (mem_finder.hpp:265-289). Full arrays are resident, so this scans
    // da_ directly instead of a sliding deque — same O(interval) cost.
    int64_t unique = 0;
    bool ok = true;
    for (int64_t i = start; i <= end; ++i) {
      int32_t d = da_[i];
      if (counts_[d] == 0) ++unique;
      ++counts_[d];
      if (o_.max_doc_freq && counts_[d] > o_.max_doc_freq) {
        ok = false;
        break;
      }
    }
    for (int64_t i = start; i <= end; ++i) counts_[da_[i]] = 0;
    return ok && unique >= o_.num_distinct;
  }

  void update_mems(int64_t j, int64_t lcp) {
    int64_t start = j - 1;
    while (lcp < stack_.back().len) {
      Interval iv = stack_.back();
      stack_.pop_back();
      if (iv.len >= o_.min_match_len && j - iv.start >= o_.num_distinct &&
          (o_.no_max_freq || j - iv.start <= o_.max_total_freq) &&
          check_doc_range(iv.start, j - 1)) {
        if (!check_bwt_range(iv.start)) {
          if (o_.max_doc_freq == 1)
            emit_mum(iv.len, iv.start, j - 1);
          else
            emit_mem(iv.len, iv.start, j - 1);
        }
      }
      start = iv.start;
      prev_lcp_ = iv.prev_lcp;
    }
    if (lcp > stack_.back().len && lcp >= o_.min_match_len)
      stack_.push_back({start, lcp, prev_lcp_});
  }

  void emit_mum(int64_t length, int64_t start, int64_t end) {
    for (int64_t d = 0; d < num_docs_; ++d) {
      offsets_[d] = -1;
      strands_[d] = 0;
    }
    for (int64_t i = start; i <= end; ++i) {
      int32_t d = da_[i];
      int64_t pos = int64_t(sa_[i]) - doc_offsets_[d];
      char st = '+';
      if (o_.use_revcomp && pos >= doc_lens_[d]) {
        st = '-';
        if (pos + length >= 2 * doc_lens_[d]) return;  // crosses fwd$rc seam
        pos = 2 * doc_lens_[d] - pos - length - 1;
      }
      offsets_[d] = pos;
      strands_[d] = st;
    }
    // canonical orientation: first present genome must be '+'
    int64_t first = 0;
    while (first < num_docs_ - 1 && strands_[first] == 0) ++first;
    if (strands_[first] == '-') return;
    ++matches;
    sum_len += uint64_t(length);
    for (int64_t d = 0; d < num_docs_; ++d)
      if (strands_[d])
        occ_hash += mix(uint64_t(offsets_[d]) * 131 + uint64_t(d) * 7 +
                        (strands_[d] == '-' ? 3 : 0) + uint64_t(length));
  }

  void emit_mem(int64_t length, int64_t start, int64_t end) {
    ++matches;
    sum_len += uint64_t(length);
    for (int64_t i = start; i <= end; ++i) {
      int32_t d = da_[i];
      int64_t pos = int64_t(sa_[i]) - doc_offsets_[d];
      char st = '+';
      if (o_.use_revcomp && pos >= doc_lens_[d]) {
        st = '-';
        // reference quirk: the interval's final row omits the -1
        // (mem_finder.hpp:248)
        pos = (i < end) ? 2 * doc_lens_[d] - pos - length - 1
                        : 2 * doc_lens_[d] - pos - length;
      }
      occ_hash += mix(uint64_t(pos) * 131 + uint64_t(d) * 7 +
                      (st == '-' ? 3 : 0) + uint64_t(length));
    }
  }

  static uint64_t mix(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    return x;
  }

  const MatchOptions& o_;
  int64_t num_docs_;
  const int32_t* sa_;
  const int32_t* da_;
  const uint8_t* bwt_;
  std::vector<int64_t> doc_offsets_, doc_lens_;
  std::vector<Interval> stack_;
  std::vector<int64_t> counts_;
  std::vector<int64_t> offsets_;
  std::vector<char> strands_;
  int64_t prev_lcp_ = 0;
  int64_t last_bwt_change_ = 0;
};

}  // namespace

int main(int argc, char** argv) {
  if (argc < 10) {
    std::fprintf(stderr,
                 "usage: %s TEXT LENGTHS L K F_DOC F_TOTAL NO_MAX_FREQ RC "
                 "REPS\n",
                 argv[0]);
    return 2;
  }
  const char* text_path = argv[1];
  const char* lengths_path = argv[2];
  MatchOptions opts;
  opts.min_match_len = std::atoll(argv[3]);
  opts.num_distinct = std::atoll(argv[4]);
  opts.max_doc_freq = std::atoll(argv[5]);
  opts.max_total_freq = std::atoll(argv[6]);
  opts.no_max_freq = std::atoi(argv[7]) != 0;
  opts.use_revcomp = std::atoi(argv[8]) != 0;
  int reps = std::atoi(argv[9]);

  // Collection text: raw bytes + the direct path's {1,0} sentinels
  // (direct_gsacak.hpp:56-62).
  std::ifstream tf(text_path, std::ios::binary | std::ios::ate);
  if (!tf) {
    std::fprintf(stderr, "cannot open %s\n", text_path);
    return 1;
  }
  int64_t text_len = tf.tellg();
  tf.seekg(0);
  if (text_len + 2 > INT32_MAX) {
    std::fprintf(stderr, "baseline_cpu: text too large for int32 SA\n");
    return 1;
  }
  int32_t n = int32_t(text_len + 2);
  std::vector<uint8_t> text(n);
  tf.read(reinterpret_cast<char*>(text.data()), text_len);
  text[n - 2] = 1;
  text[n - 1] = 0;

  std::vector<int64_t> seq_lengths;
  {
    std::ifstream lf(lengths_path);
    int64_t v;
    while (lf >> v) seq_lengths.push_back(v);
  }
  int64_t num_docs = int64_t(seq_lengths.size());

  // doc id per text position (rank over doc ends, ref_builder.cpp:183-190);
  // sentinel positions get num_docs like the Python doc_array clamp.
  std::vector<int32_t> doc_of(n, int32_t(num_docs));
  {
    int64_t pos = 0;
    for (int64_t d = 0; d < num_docs; ++d)
      for (int64_t i = 0; i < seq_lengths[d]; ++i) doc_of[pos++] = int32_t(d);
  }

  double t_sa = 0, t_lcp = 0, t_scan = 0, t_best = 1e30;
  uint64_t matches = 0, sum_len = 0, occ_hash = 0;
  std::vector<int32_t> sa(n), lcp(n), da(n);
  std::vector<uint8_t> bwt(n);
  for (int rep = 0; rep < std::max(reps, 1); ++rep) {
    auto t0 = Clock::now();
    sais<uint8_t>(text.data(), sa.data(), n, 256);
    double sa_s = seconds_since(t0);

    auto t1 = Clock::now();
    kasai_lcp(text.data(), sa.data(), lcp.data(), n);
    double lcp_s = seconds_since(t1);

    auto t2 = Clock::now();
    for (int32_t r = 0; r < n; ++r) {
      bwt[r] = text[(int64_t(sa[r]) + n - 1) % n];
      da[r] = doc_of[sa[r]];
    }
    StackFinder finder(opts, num_docs, seq_lengths, sa.data(), da.data(),
                       bwt.data());
    for (int32_t r = 0; r < n; ++r) finder.update(r, lcp[r]);
    double scan_s = seconds_since(t2);

    matches = finder.matches;
    sum_len = finder.sum_len;
    occ_hash = finder.occ_hash;
    double total = sa_s + lcp_s + scan_s;
    if (total < t_best) {
      t_best = total;
      t_sa = sa_s;
      t_lcp = lcp_s;
      t_scan = scan_s;
    }
  }

  std::printf(
      "{\"n\": %d, \"num_docs\": %lld, \"matches\": %llu, "
      "\"sum_len\": %llu, \"occ_hash\": %llu, \"t_sa\": %.4f, "
      "\"t_lcp\": %.4f, \"t_scan\": %.4f, \"t_total\": %.4f}\n",
      n, static_cast<long long>(num_docs),
      static_cast<unsigned long long>(matches),
      static_cast<unsigned long long>(sum_len),
      static_cast<unsigned long long>(occ_hash), t_sa, t_lcp, t_scan, t_best);
  return 0;
}
