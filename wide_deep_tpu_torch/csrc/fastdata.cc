// wide_deep_tpu_torch native data loader: TSV -> packed feature batches.
//
// The port's copy of the JAX package's loader (cpp/fastdata.cc), which it
// extends: a multi-valued cell keeps up to kMaxValues values, a continuous
// feature may take log1p, and a hash feature may pool by the sum.
// Multithreaded C++ hot path for the host feature pipeline, bit-identical to
// the port's Python implementation in features/pipeline.py: same XXH64
// string fingerprints (features/hashing.py), same cross-combine chain, same
// packing layout (features/plan.py).  Loaded via ctypes from
// features/native.py, which compiles it at first use; the binary plan
// format is produced by native.serialize_plan (version 13) and must stay in
// lockstep.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ----------------------------------------------------------- xxhash64 (spec)
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t round1(uint64_t acc, uint64_t lane) {
  return rotl64(acc + lane * P2, 31) * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  return (acc ^ round1(0, val)) * P1 + P4;
}

inline uint64_t read64(const char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/arm LE)
}

inline uint32_t read32(const char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t xxh64(const char* data, size_t n, uint64_t seed = 0) {
  const char* p = data;
  const char* end = data + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const char* limit = end - 32;
    do {
      v1 = round1(v1, read64(p));
      v2 = round1(v2, read64(p + 8));
      v3 = round1(v3, read64(p + 16));
      v4 = round1(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(static_cast<unsigned char>(*p)) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// cross-combine chain (hashing.py::combine64): order-sensitive fold
inline uint64_t combine64(uint64_t acc, uint64_t val) {
  uint64_t x = acc ^ (val * P2);
  return rotl64(x, 31) * P1;
}

// --------------------------------------------------------------- plan model
enum Kind { kHash = 0, kVocab = 1, kIdentity = 2, kContinuous = 3 };
enum Tran { tNone = 0, tMinMax = 1, tStandard = 2, tLog = 3, tLog1p = 4 };

// the most values a multi-valued cell keeps (the config's max_len cap)
constexpr int kMaxValues = 128;

struct Feature {
  std::string name;
  int64_t col = 0;
  int64_t kind = 0;
  int64_t max_len = 1;
  // category placement (packed pools: slot_index feeds the segment column)
  int64_t size = 0, wide_off = 0;
  int64_t group = 0, row_off = 0, slot_index = 0;   // hash
  int64_t ind_off = 0, ind_col = 0;                 // vocab/identity
  std::unordered_map<std::string, int32_t> vocab;   // vocab
  // continuous
  int64_t tran = 0;
  double a = 0.0, b = 1.0;
  int64_t cont_idx = 0;
  std::vector<double> bounds;
  int64_t has_wide = 0;
  int64_t wide_folded = 0;  // wide weight rides the fused embedding table
  int64_t sum_pool = 0;     // hash: pooled by the sum, else the mean
};

struct Cross {
  std::vector<int64_t> members;  // indices into features
  int64_t bucket = 0, max_len = 0, wide_off = 0;
  int64_t is_deep = 0, group = 0, row_off = 0, slot_index = 0;
  int64_t wide_folded = 0;
};

struct Plan {
  int64_t n_columns = 0, multivalue = 0, pack_budget = 3;
  int64_t wide_packed = 0, ind_len = 0, n_cont = 0;
  int64_t scatter_shards = 1;  // >1: per-table-shard plan emission
  std::vector<int64_t> group_dims, group_packed, group_rows;
  std::vector<Feature> features;
  std::vector<Cross> crosses;
};

// ---- Pallas range-scatter plan constants; MUST match ops/scatter.py
// (T_IDS / MAXR / ALIGN_IDS / ALIGN_ROWS) — the Python/C++ parity test
// fails loudly on drift.
constexpr int64_t kTIds = 1024;
constexpr int64_t kMaxr = 2048;
constexpr int64_t kAlignIds = 128;
constexpr int64_t kAlignRows = 256;

inline int64_t rows_pad(int64_t rows) {
  int64_t aligned = (rows + kAlignRows - 1) / kAlignRows * kAlignRows;
  return std::max(aligned, kMaxr);
}

// rows is the RAW table row count; padding applied here so the tile-array
// size agrees with ops/scatter.py n_tiles_for for ANY rows (a mismatch
// for rows < kMaxr would silently misalign the [4, n_tiles] layout).
inline int64_t n_tiles_for(int64_t n_ids, int64_t rows) {
  rows = rows_pad(rows);
  return (n_ids + kTIds - 1) / kTIds
         + (rows + (kMaxr - kAlignRows) - 1) / (kMaxr - kAlignRows) + 1;
}

// per-shard stream cap (ops/scatter.py shard_cap parity): SHARD_SLACK x the
// even split, kAlignIds-aligned, never above n_ids
constexpr int64_t kShardSlack = 2;

inline int64_t shard_cap(int64_t n_ids, int64_t n_shards) {
  int64_t cap = (n_ids * kShardSlack + n_shards - 1) / n_shards;
  cap = (cap + kAlignIds - 1) / kAlignIds * kAlignIds;
  return std::min(cap, n_ids);
}

// window-mode plan constants (ops/scatter.py window_cap / window_rows_pad
// parity): write-only fixed row windows for sparse streams
inline int64_t window_n_tiles(int64_t rows) {
  return std::max<int64_t>((rows + kMaxr - 1) / kMaxr, 1);
}

inline int64_t window_cap(int64_t n_ids, int64_t rows) {
  double mean = static_cast<double>(n_ids) / window_n_tiles(rows);
  int64_t cap =
      static_cast<int64_t>(std::ceil(4.0 * mean / kAlignIds)) * kAlignIds;
  return std::max<int64_t>(kAlignIds, std::min(cap, kTIds));
}

// dedup-exchange caps are NOT recomputed here: ops/scatter.dedup_cap uses
// np.exp, and a 1-ulp libm divergence from std::exp at a ceil boundary
// would make this side index buffers the Python side allocated one
// kAlignIds step differently — heap corruption.  The caller passes the
// Python-computed cap per group through wdt_transform's dedup_caps (the
// other caps — shard, live, window — are integer/IEEE-exact math and stay
// mirrored).

// LSD radix passes over pre-materialized keys in `sorted`, digit width
// adapted to the key range [0, max_key]: <=12 bits one pass, else two
// passes of ceil(bits/2) (<=4096 buckets — cache-resident counts vs the
// 512 KB histogram 16-bit digits need; measured 1.6x on the production
// d8 stream).  Stable; fills perm with the argsort.
void radix_sort_keys(int64_t n, int32_t* perm, int32_t* sorted,
                     uint32_t max_key) {
  std::vector<int32_t> tmp_idx(n), tmp_ids(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = static_cast<int32_t>(i);
  int bits = 1;
  while (bits < 32 && (uint64_t(1) << bits) <= max_key) ++bits;
  int widths[2], shifts[2];
  if (bits <= 12) {
    widths[0] = bits; widths[1] = 0;
  } else {
    widths[0] = (bits + 1) / 2; widths[1] = bits - widths[0];
  }
  shifts[0] = 0; shifts[1] = widths[0];
  int32_t* src_i = perm;
  int32_t* src_v = sorted;
  int32_t* dst_i = tmp_idx.data();
  int32_t* dst_v = tmp_ids.data();
  std::vector<int64_t> count((int64_t(1) << std::max(widths[0], widths[1]))
                             + 1);
  for (int pass = 0; pass < 2 && widths[pass] > 0; ++pass) {
    const int shift = shifts[pass];
    const uint32_t mask = (uint32_t(1) << widths[pass]) - 1;
    const int64_t nb = int64_t(1) << widths[pass];
    std::fill(count.begin(), count.begin() + nb + 1, 0);
    for (int64_t i = 0; i < n; ++i)
      ++count[((static_cast<uint32_t>(src_v[i]) >> shift) & mask) + 1];
    if (count[1] == n) continue;  // all keys zero here: identity pass
    for (int64_t b = 0; b < nb; ++b) count[b + 1] += count[b];
    for (int64_t i = 0; i < n; ++i) {
      int64_t pos =
          count[(static_cast<uint32_t>(src_v[i]) >> shift) & mask]++;
      dst_i[pos] = src_i[i];
      dst_v[pos] = src_v[i];
    }
    std::swap(src_i, dst_i);
    std::swap(src_v, dst_v);
  }
  if (src_i != perm) {
    std::memcpy(perm, src_i, n * sizeof(int32_t));
    std::memcpy(sorted, src_v, n * sizeof(int32_t));
  }
}

// stable radix argsort in FULL uint32 bit order (negative ids sort after
// all positives, exactly like the legacy 2x16-bit passes) — raw-id
// callers' out-of-range detection relies on rogue values sorting to the
// tail, so this path must not mask bit 31.
void stable_radix_argsort(const int32_t* ids, int64_t n, int32_t* perm,
                          int32_t* sorted) {
  std::memcpy(sorted, ids, n * sizeof(int32_t));
  radix_sort_keys(n, perm, sorted, 0xFFFFFFFFu);
}

// sentinel-keyed variant fused with the weight-0 padding remap
// (key_i = wts[i] != 0 ? ids[i] : sentinel): skips the separate remap
// buffer and sizes the radix digits by the known bound.  Returns false
// when a live id falls outside [0, sentinel] — the plan contract is
// broken and the caller must fail loudly (masked digits could otherwise
// mis-sort the rogue id silently).
bool stable_radix_argsort_keyed(const int32_t* ids, const float* wts,
                                int32_t sentinel, int64_t n, int32_t* perm,
                                int32_t* sorted) {
  bool ok = true;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = wts[i] != 0.0f ? ids[i] : sentinel;
    ok &= static_cast<uint32_t>(v) <= static_cast<uint32_t>(sentinel);
    sorted[i] = v;
  }
  if (!ok) return false;
  radix_sort_keys(n, perm, sorted, static_cast<uint32_t>(sentinel));
  return true;
}

// tiling of a sorted id stream (ops/scatter.py build_scatter_tiles parity);
// returns false on a contract violation (an id outside [0, rows), which
// would otherwise silently drop the rest of the stream — the Python tiler
// asserts loudly in the same case)
bool build_tiles(const int32_t* ids_sorted, int64_t n, int64_t rows,
                 int32_t* tiles, int64_t n_tiles) {
  // tiles laid out [4, n_tiles]: starts, offs, counts, row_los
  int32_t* starts = tiles;
  int32_t* offs = tiles + n_tiles;
  int32_t* counts = tiles + 2 * n_tiles;
  int32_t* row_los = tiles + 3 * n_tiles;
  const int64_t rp = rows_pad(rows);
  const int64_t max_lo = rp - kMaxr;
  int64_t t = 0, i = 0;
  while (i < n && t < n_tiles) {
    if (ids_sorted[i] < 0 || ids_sorted[i] >= rows) return false;
    int64_t lo = std::min<int64_t>(
        static_cast<int64_t>(ids_sorted[i]) / kAlignRows * kAlignRows,
        max_lo);
    int64_t j_cap = std::min(i + kTIds, n);
    int64_t j = i;
    while (j < j_cap && ids_sorted[j] < lo + kMaxr) ++j;
    starts[t] = static_cast<int32_t>(i / kAlignIds * kAlignIds);
    offs[t] = static_cast<int32_t>(i - starts[t]);
    counts[t] = static_cast<int32_t>(j - i);
    row_los[t] = static_cast<int32_t>(lo);
    ++t;
    i = j;
  }
  return i >= n;  // every id consumed (t hit n_tiles early otherwise)
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  int64_t i64() {
    if (p + 8 > end) { ok = false; return 0; }
    int64_t v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  double f64() {
    if (p + 8 > end) { ok = false; return 0; }
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  std::string str() {
    int64_t n = i64();
    if (!ok || n < 0 || p + n > end) { ok = false; return {}; }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
};

Plan* parse_plan(const uint8_t* buf, int64_t len) {
  Reader r{buf, buf + len};
  if (len < 12 || std::memcmp(buf, "WDTP", 4) != 0) return nullptr;
  r.p += 4;
  // version 12: per-shard live counts in the sharded range/window/compact
  // plan output layouts; the check keeps stale libs from silently
  // mis-reading the call
  // version 13: v12's fields, then a pooling flag per feature in plan
  // order (1: a hash feature sums its rows, combiner: sum)
  if (r.i64() != 13) return nullptr;
  auto plan = new Plan();
  plan->scatter_shards = std::max<int64_t>(r.i64(), 1);
  plan->n_columns = r.i64();
  plan->multivalue = r.i64();
  plan->pack_budget = r.i64();
  plan->wide_packed = r.i64();
  plan->ind_len = r.i64();
  plan->n_cont = r.i64();
  int64_t n_groups = r.i64();
  for (int64_t g = 0; g < n_groups; ++g) {
    plan->group_dims.push_back(r.i64());
    plan->group_packed.push_back(r.i64());
    plan->group_rows.push_back(r.i64());
  }
  int64_t n_features = r.i64();
  for (int64_t i = 0; i < n_features && r.ok; ++i) {
    Feature f;
    f.name = r.str();
    f.col = r.i64();
    f.kind = r.i64();
    if (f.kind == kHash) {
      f.max_len = r.i64();
      f.size = r.i64();
      f.wide_off = r.i64();
      f.group = r.i64();
      f.row_off = r.i64();
      f.slot_index = r.i64();
      f.wide_folded = r.i64();
    } else if (f.kind == kVocab || f.kind == kIdentity) {
      f.max_len = r.i64();
      f.size = r.i64();
      f.wide_off = r.i64();
      f.ind_off = r.i64();
      f.ind_col = r.i64();
      if (f.kind == kVocab) {
        // assignment, not emplace: a DUPLICATE vocab entry must resolve
        // to its LAST index like the Python dict comprehension
        // (pipeline.py vocab maps) — emplace keeps the first and the
        // two loaders emit different indicator ids for the same row
        for (int64_t v = 0; v < f.size && r.ok; ++v)
          f.vocab[r.str()] = static_cast<int32_t>(v);
      }
    } else {  // continuous
      f.max_len = r.i64();  // always 1
      f.tran = r.i64();
      f.a = r.f64();
      f.b = r.f64();
      f.cont_idx = r.i64();
      int64_t nb = r.i64();
      for (int64_t k = 0; k < nb && r.ok; ++k) f.bounds.push_back(r.f64());
      f.has_wide = r.i64();
      f.wide_off = r.i64();
    }
    plan->features.push_back(std::move(f));
  }
  int64_t n_crosses = r.i64();
  for (int64_t i = 0; i < n_crosses && r.ok; ++i) {
    Cross c;
    int64_t nm = r.i64();
    for (int64_t m = 0; m < nm && r.ok; ++m) c.members.push_back(r.i64());
    c.bucket = r.i64();
    c.max_len = r.i64();
    c.wide_off = r.i64();
    c.is_deep = r.i64();
    c.group = r.i64();
    c.row_off = r.i64();
    c.slot_index = r.i64();
    c.wide_folded = r.i64();
    plan->crosses.push_back(std::move(c));
  }
  for (auto& f : plan->features) f.sum_pool = r.i64();
  if (!r.ok) { delete plan; return nullptr; }
  return plan;
}

// ------------------------------------------------------------ row transform
struct Outs {
  float* label;
  float* weight;
  float* mask;
  int32_t* wide_ids;
  float* wide_wts;
  std::vector<int32_t*> g_ids;
  std::vector<float*> g_wts;
  std::vector<int32_t*> g_seg;
  int32_t* ind_ids;
  float* ind_wts;
  float* cont;
};

struct View {
  const char* p;
  size_t n;
  bool eq(const char* s) const { return std::strlen(s) == n && std::memcmp(p, s, n) == 0; }
};

inline double to_double(const View& v) {
  if (v.n == 0 || (v.n == 1 && v.p[0] == '-')) return 0.0;
  // cells longer than the buffer are junk by contract (both paths; the
  // Python side rejects >63-char numerics identically) — truncating
  // would silently parse a different number than Python
  if (v.n >= 64) return 0.0;
  char buf[64];
  size_t n = v.n;
  std::memcpy(buf, v.p, n);
  buf[n] = 0;
  // match Python float() semantics exactly (fuzz-parity contract,
  // tests/test_fuzz_native.py): surrounding whitespace allowed, the
  // WHOLE remainder must parse (strtod's prefix parse would accept
  // "1 2" or "5.5.5"), and hex forms are junk ("0x1f" is 31 to strtod,
  // ValueError to Python)
  size_t b = 0, e = n;
  while (b < e && std::isspace(static_cast<unsigned char>(buf[b]))) b++;
  while (e > b && std::isspace(static_cast<unsigned char>(buf[e - 1]))) e--;
  if (b == e) return 0.0;
  for (size_t i = b; i < e; i++)
    if (buf[i] == 'x' || buf[i] == 'X') return 0.0;
  buf[e] = 0;
  char* endp = nullptr;
  double d = std::strtod(buf + b, &endp);
  if (endp != buf + e) return 0.0;
  // junk tolerance: inf/nan ("1e309", "nan") map to the 0 default like
  // the Python path (pipeline._to_float) — an inf continuous feature
  // otherwise NaNs the loss steps later with no pointer to the bad row
  if (!std::isfinite(d)) return 0.0;
  return d;
}

inline int64_t to_int(const View& v) {
  double d = to_double(v);
  // beyond-int64 magnitudes -> 0 (static_cast of such doubles is UB);
  // mirrors pipeline._to_int, pinned by tests/test_fuzz_native.py
  if (d > 4.611686018427388e18 || d < -4.611686018427388e18) return 0;
  return static_cast<int64_t>(d);
}

// split a cell on ',' honoring multivalue + cap (pipeline.py::_split)
inline int split_values(const Plan& plan, const View& cell, int64_t max_len,
                        View* out) {
  if (cell.n == 0 || (cell.n == 1 && cell.p[0] == '-')) {
    out[0] = View{cell.p, 0};  // empty string value
    return 1;
  }
  if (!plan.multivalue) {
    out[0] = cell;
    return 1;
  }
  int count = 0;
  const char* start = cell.p;
  const char* end = cell.p + cell.n;
  const char* q = start;
  while (q <= end && count < max_len) {
    if (q == end || *q == ',') {
      out[count++] = View{start, static_cast<size_t>(q - start)};
      start = q + 1;
    }
    ++q;
  }
  return count;
}

void process_row(const Plan& plan, const View* cells, bool shifted,
                 bool has_label, bool multiclass, bool weighted,
                 double pos_w, double neg_w,
                 int64_t b, const Outs& o, int64_t wide_len,
                 const std::vector<int64_t>& group_lens,
                 int64_t ind_len, int64_t n_cont,
                 std::vector<std::vector<uint64_t>>& member_vals,
                 std::vector<int64_t>& gcur) {
  int shift = shifted ? 1 : 0;
  // packed-pool cursors (pipeline.py wide_put/emb_put semantics)
  int64_t wcur = 0;
  std::fill(gcur.begin(), gcur.end(), 0);
  auto wide_put = [&](int64_t gid) {
    if (wcur < wide_len) {
      o.wide_ids[b * wide_len + wcur] = static_cast<int32_t>(gid);
      o.wide_wts[b * wide_len + wcur] = 1.0f;
      ++wcur;
    }
  };
  if (has_label) {
    float lab;
    if (multiclass) {
      lab = static_cast<float>(to_int(cells[0]));
    } else {
      lab = (cells[0].n == 1 && cells[0].p[0] == '1') ? 1.0f : 0.0f;
    }
    o.label[b] = lab;
    o.weight[b] = weighted ? (lab != 0.0f ? static_cast<float>(pos_w)
                                          : static_cast<float>(neg_w))
                           : 1.0f;
  }
  o.mask[b] = 1.0f;

  View vals[kMaxValues];
  for (size_t fi = 0; fi < plan.features.size(); ++fi) {
    const Feature& f = plan.features[fi];
    const View& cell = cells[f.col - shift];
    auto& mv = member_vals[fi];
    mv.clear();
    if (f.kind == kContinuous) {
      double raw = to_double(cell);
      double x = raw;
      if (f.tran == tMinMax) x = (raw - f.a) / (f.b - f.a);
      else if (f.tran == tStandard) x = (raw - f.a) / f.b;
      else if (f.tran == tLog) x = std::log(std::max(raw, 1e-12));
      else if (f.tran == tLog1p) x = std::log1p(std::max(raw, 0.0));
      o.cont[b * n_cont + f.cont_idx] = static_cast<float>(x);
      if (!f.bounds.empty()) {
        int64_t bucket = std::upper_bound(f.bounds.begin(), f.bounds.end(),
                                          raw) - f.bounds.begin();
        if (f.has_wide) {
          wide_put(f.wide_off + bucket);
        }
        mv.push_back(static_cast<uint64_t>(bucket));
      }
      continue;
    }
    // defense in depth: the config layer rejects max_len > kMaxValues
    // (config.py), but an out-of-band plan must clamp rather than
    // overflow the fixed stack buffer above
    int k = split_values(plan, cell,
                         std::min<int64_t>(f.max_len, kMaxValues), vals);
    if (f.kind == kHash) {
      // per-slot cap = pack_budget for multivalue slots (pipeline.py parity)
      int cap = f.max_len == 1 ? 1 : static_cast<int>(plan.pack_budget);
      int kept = std::min(k, cap);
      float w = f.sum_pool ? 1.0f : 1.0f / kept;
      int64_t glen = group_lens[f.group];
      int64_t& c = gcur[f.group];
      for (int j = 0; j < k; ++j) {
        uint64_t fp = xxh64(vals[j].p, vals[j].n);
        int64_t id = fp % static_cast<uint64_t>(f.size);
        if (j < kept) {
          if (!f.wide_folded) wide_put(f.wide_off + id);
          if (c < glen) {
            o.g_ids[f.group][b * glen + c] = static_cast<int32_t>(f.row_off + id);
            o.g_wts[f.group][b * glen + c] = w;
            o.g_seg[f.group][b * glen + c] = static_cast<int32_t>(f.slot_index);
            ++c;
          }
        }
        mv.push_back(fp);
      }
    } else if (f.kind == kVocab) {
      // wide contribution rides the indicator block (dense path)
      int out_j = 0;
      for (int j = 0; j < k; ++j) {
        std::string key(vals[j].p, vals[j].n);
        auto it = f.vocab.find(key);
        mv.push_back(xxh64(vals[j].p, vals[j].n));
        if (it == f.vocab.end()) continue;  // OOV dropped
        int32_t id = it->second;
        o.ind_ids[b * ind_len + f.ind_col + out_j] =
            static_cast<int32_t>(f.ind_off + id);
        o.ind_wts[b * ind_len + f.ind_col + out_j] = 1.0f;
        ++out_j;
      }
    } else {  // identity (wide via indicator block, like vocab)
      for (int j = 0; j < k; ++j) {
        int64_t id = to_int(vals[j]);
        if (id < 0 || id >= f.size) id = 0;  // default_value=0 semantics
        o.ind_ids[b * ind_len + f.ind_col + j] =
            static_cast<int32_t>(f.ind_off + id);
        o.ind_wts[b * ind_len + f.ind_col + j] = 1.0f;
        mv.push_back(static_cast<uint64_t>(id));
      }
    }
  }

  // crosses: chained fingerprints over the (capped) cartesian product,
  // truncation applied after each member expansion (pipeline.py order)
  uint64_t combos[64], next[64];
  for (const Cross& c : plan.crosses) {
    int n_combo = 1;
    combos[0] = P5;
    for (int64_t mi : c.members) {
      const auto& col = member_vals[mi];
      size_t ncol = col.empty() ? 1 : col.size();
      uint64_t zero = 0;
      const uint64_t* cp = col.empty() ? &zero : col.data();
      int n_next = 0;
      for (int a = 0; a < n_combo && n_next < c.max_len; ++a)
        for (size_t v = 0; v < ncol && n_next < c.max_len; ++v)
          next[n_next++] = combine64(combos[a], cp[v]);
      std::memcpy(combos, next, n_next * sizeof(uint64_t));
      n_combo = n_next;
    }
    int ccap = c.max_len == 1 ? 1 : static_cast<int>(plan.pack_budget);
    int ckept = std::min(n_combo, ccap);
    float w = 1.0f / ckept;
    for (int j = 0; j < ckept; ++j) {
      int64_t id = combos[j] % static_cast<uint64_t>(c.bucket);
      if (!c.wide_folded) wide_put(c.wide_off + id);
      if (c.is_deep) {
        int64_t glen = group_lens[c.group];
        int64_t& gc = gcur[c.group];
        if (gc < glen) {
          o.g_ids[c.group][b * glen + gc] = static_cast<int32_t>(c.row_off + id);
          o.g_wts[c.group][b * glen + gc] = w;
          o.g_seg[c.group][b * glen + gc] = static_cast<int32_t>(c.slot_index);
          ++gc;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

void* wdt_plan_create(const char* buf, int64_t len) {
  return parse_plan(reinterpret_cast<const uint8_t*>(buf), len);
}

void wdt_plan_free(void* plan) { delete static_cast<Plan*>(plan); }

// outs layout: label, weight, mask, wide_ids, wide_wts,
//              [per group: ids, wts, seg]..., ind_ids, ind_wts, cont,
//              then per scat_mask group (ascending):
//                scatter_shards == 1: ids_sorted [B*P], perm [B*P],
//                  tiles [4, n_tiles_for(B*P, rows)], live [1]
//                  (weight-0 pool padding remapped to the rows_pad
//                  sentinel so it sorts to the tail; tiles cover only
//                  the live prefix; live = non-padding count)
//                scatter_shards == S > 1: ids [S, cap], perm [S, cap],
//                  tiles [S, 4, n_tiles_for(cap, rows/S)], ok [S], live [S]
//                  (ops/scatter.make_sharded_scatter_plan layout: localized
//                  sorted streams per table shard; ok=0 on cap overflow;
//                  live = per-shard id count for live-cap compaction)
//              then per window_mask group (ascending):
//                scatter_shards == 1: ids [B*P], perm [B*P],
//                  tiles [3, window_n_tiles(rows)], ok [1]
//                  (ops/scatter.make_window_plan layout: weight-0 padding
//                  remapped to an out-of-window sentinel before the sort;
//                  ok=0 + zero tiles when a window exceeds window_cap)
//                scatter_shards == S > 1: ids [S, cap], perm [S, cap],
//                  tiles [S, 3, window_n_tiles(rows/S)], ok [S], live [S]
//                  (ops/scatter.make_sharded_window_plan layout)
//              then per sopt_mask group (ascending):
//                scatter_shards == 1: uids [B*P], ids [B*P], perm [B*P],
//                  tiles [4, n_tiles_for(B*P, B*P)]
//                  (ops/scatter.make_compact_plan layout: dedup ranks +
//                  sentinel-padded unique rows)
//                scatter_shards == S > 1: uids [S, cap], ids [S, cap],
//                  perm [S, cap], tiles [S, 4, n_tiles_for(cap, cap)],
//                  ok [S], live [S]
//                  (ops/scatter.make_sharded_compact_plan layout)
//              then per dedup_mask group (ascending): uids [S, dcap],
//                slots [B, P] (ops/scatter.make_dedup_plan layout:
//                per-shard unique LOCAL ids sentinel-padded with
//                shard_rows; slots[b,p] = shard*dcap + unique position)
// scat_mask / window_mask / sopt_mask / dedup_mask: bit g set = emit that
// plan kind for group g (range and window are mutually exclusive per
// group; sopt/dedup may coexist; ops/scatter.py contract, caller sizes
// buffers).  dedup_caps: [n_groups] int64, the caller-computed
// ops/scatter.dedup_cap per group (only dedup_mask entries read) — the
// SAME value that sized the uids buffers, so the two sides cannot diverge
// on the transcendental cap math.  Returns -4 when a dedup shard's unique
// count exceeds its static cap (the Python builder raises in the same
// case).
int64_t wdt_transform(void* plan_ptr, const char* text, int64_t text_len,
                      int64_t capacity, int has_label, int multiclass,
                      double pos_w, double neg_w, int weighted, int n_threads,
                      int64_t scat_mask, int64_t window_mask,
                      int64_t sopt_mask, int64_t dedup_mask,
                      const int64_t* dedup_caps, void** outs) {
  const Plan& plan = *static_cast<Plan*>(plan_ptr);
  // WDT_LOADER_PROF=1: per-call phase times on stderr (ops attribution;
  // measured round 4 on the production config at B=25600: parse ~72%,
  // plan post-passes ~28% of a 1-thread transform)
  const char* prof_env = std::getenv("WDT_LOADER_PROF");
  const bool prof = prof_env && prof_env[0] && prof_env[0] != '0';
  auto tprev = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[wdt_loader] %-8s %7.2f ms\n", name,
                 std::chrono::duration<double, std::milli>(now - tprev)
                     .count());
    tprev = now;
  };
  Outs o;
  int idx = 0;
  o.label = static_cast<float*>(outs[idx++]);
  o.weight = static_cast<float*>(outs[idx++]);
  o.mask = static_cast<float*>(outs[idx++]);
  o.wide_ids = static_cast<int32_t*>(outs[idx++]);
  o.wide_wts = static_cast<float*>(outs[idx++]);
  for (size_t g = 0; g < plan.group_dims.size(); ++g) {
    o.g_ids.push_back(static_cast<int32_t*>(outs[idx++]));
    o.g_wts.push_back(static_cast<float*>(outs[idx++]));
    o.g_seg.push_back(static_cast<int32_t*>(outs[idx++]));
  }
  o.ind_ids = static_cast<int32_t*>(outs[idx++]);
  o.ind_wts = static_cast<float*>(outs[idx++]);
  o.cont = static_cast<float*>(outs[idx++]);
  struct ScatOut { int64_t group; int32_t *ids, *perm, *tiles, *ok, *live; };
  std::vector<ScatOut> scats;
  for (size_t g = 0; g < plan.group_dims.size(); ++g) {
    if (!(scat_mask >> g & 1)) continue;
    ScatOut s;
    s.group = static_cast<int64_t>(g);
    s.ids = static_cast<int32_t*>(outs[idx++]);
    s.perm = static_cast<int32_t*>(outs[idx++]);
    s.tiles = static_cast<int32_t*>(outs[idx++]);
    s.ok = plan.scatter_shards > 1 ? static_cast<int32_t*>(outs[idx++])
                                   : nullptr;
    s.live = static_cast<int32_t*>(outs[idx++]);  // [1] single / [S] sharded
    scats.push_back(s);
  }
  struct WScatOut { int64_t group; int32_t *ids, *perm, *tiles, *ok, *live; };
  std::vector<WScatOut> wscats;
  for (size_t g = 0; g < plan.group_dims.size(); ++g) {
    if (!(window_mask >> g & 1)) continue;
    WScatOut s;
    s.group = static_cast<int64_t>(g);
    s.ids = static_cast<int32_t*>(outs[idx++]);
    s.perm = static_cast<int32_t*>(outs[idx++]);
    s.tiles = static_cast<int32_t*>(outs[idx++]);
    s.ok = static_cast<int32_t*>(outs[idx++]);
    s.live = plan.scatter_shards > 1 ? static_cast<int32_t*>(outs[idx++])
                                     : nullptr;
    wscats.push_back(s);
  }
  struct SoptOut {
    int64_t group;
    int32_t *uids, *ids, *perm, *tiles, *ok, *live;
  };
  std::vector<SoptOut> sopts;
  for (size_t g = 0; g < plan.group_dims.size(); ++g) {
    if (!(sopt_mask >> g & 1)) continue;
    SoptOut s;
    s.group = static_cast<int64_t>(g);
    s.uids = static_cast<int32_t*>(outs[idx++]);
    s.ids = static_cast<int32_t*>(outs[idx++]);
    s.perm = static_cast<int32_t*>(outs[idx++]);
    s.tiles = static_cast<int32_t*>(outs[idx++]);
    s.ok = plan.scatter_shards > 1 ? static_cast<int32_t*>(outs[idx++])
                                   : nullptr;
    s.live = plan.scatter_shards > 1 ? static_cast<int32_t*>(outs[idx++])
                                     : nullptr;
    sopts.push_back(s);
  }
  struct DedupOut { int64_t group; int64_t cap; int32_t *uids, *slots; };
  std::vector<DedupOut> dedups;
  for (size_t g = 0; g < plan.group_dims.size(); ++g) {
    if (!(dedup_mask >> g & 1)) continue;
    DedupOut s;
    s.group = static_cast<int64_t>(g);
    s.cap = dedup_caps ? dedup_caps[g] : 0;
    if (s.cap <= 0) return -2;  // caller must pass the sizing cap
    s.uids = static_cast<int32_t*>(outs[idx++]);
    s.slots = static_cast<int32_t*>(outs[idx++]);
    dedups.push_back(s);
  }

  // pass 1: line spans + validity (cell count match)
  struct Line { const char* p; size_t n; bool shifted; };
  std::vector<Line> lines;
  lines.reserve(capacity);
  const char* p = text;
  const char* end = text + text_len;
  while (p < end && static_cast<int64_t>(lines.size()) < capacity) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', end - p));
    const char* le = nl ? nl : end;
    size_t n = le - p;
    if (n > 0 && p[n - 1] == '\r') --n;
    if (n > 0) {
      int64_t tabs = static_cast<int64_t>(
          std::count(p, p + n, '\t'));
      if (has_label) {
        if (tabs == plan.n_columns - 1) lines.push_back({p, n, false});
      } else {
        if (tabs == plan.n_columns - 1) lines.push_back({p, n, false});
        else if (tabs == plan.n_columns - 2) lines.push_back({p, n, true});
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  int64_t n_rows = lines.size();
  if (n_rows == 0) return 0;

  auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<View> cells(plan.n_columns);
    std::vector<std::vector<uint64_t>> member_vals(plan.features.size());
    for (auto& v : member_vals) v.reserve(16);
    std::vector<int64_t> gcur(plan.group_dims.size(), 0);
    for (int64_t b = lo; b < hi; ++b) {
      const Line& ln = lines[b];
      // split row into cells
      int nc = 0;
      const char* s = ln.p;
      const char* e = ln.p + ln.n;
      const char* q = s;
      int expect = plan.n_columns - (ln.shifted ? 1 : 0);
      while (q <= e && nc < expect) {
        if (q == e || *q == '\t') {
          cells[nc++] = View{s, static_cast<size_t>(q - s)};
          s = q + 1;
        }
        ++q;
      }
      process_row(plan, cells.data(), ln.shifted, has_label != 0,
                  multiclass != 0, weighted != 0, pos_w, neg_w, b, o,
                  plan.wide_packed, plan.group_packed,
                  plan.ind_len ? plan.ind_len : 1,
                  plan.n_cont ? plan.n_cont : 1, member_vals, gcur);
    }
  };

  int nt = std::max(1, n_threads);
  if (nt == 1 || n_rows < 256) {
    worker(0, n_rows);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n_rows + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n_rows);
      if (lo >= hi) break;
      threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  lap("parse");

  // scatter-plan post-pass: stable argsort of each requested group's full
  // (padding included — padded rows hold id 0) id matrix + range tiling
  // (ops/scatter.py parity).  Groups sort in parallel when threads allow.
  if (!scats.empty()) {
    std::atomic<bool> scat_ok{true};
    auto do_scat = [&](const ScatOut& s) {
      int64_t g = s.group;
      int64_t n = capacity * plan.group_packed[g];
      int64_t rows = plan.group_rows[g];
      int64_t n_shards = plan.scatter_shards;
      if (n_shards <= 1) {
        // live-cap compaction (ops/scatter.make_scatter_plan parity):
        // weight-0 pool padding -> rows_pad sentinel so it sorts to the
        // stream tail; only the live prefix is tiled
        const int64_t sentinel = rows_pad(rows);
        if (!stable_radix_argsort_keyed(o.g_ids[g], o.g_wts[g],
                                        static_cast<int32_t>(sentinel), n,
                                        s.perm, s.ids)) {
          scat_ok.store(false, std::memory_order_relaxed);  // id > sentinel
          return;
        }
        int64_t live = std::lower_bound(s.ids, s.ids + n,
                                        static_cast<int32_t>(sentinel))
                       - s.ids;
        s.live[0] = static_cast<int32_t>(live);
        if (!build_tiles(s.ids, live, rows, s.tiles, n_tiles_for(n, rows)))
          scat_ok.store(false, std::memory_order_relaxed);
        return;
      }
      // per-table-shard emission: sort the global stream once, split at the
      // static shard row boundaries, localize + tile each shard's slice
      // (ops/scatter.make_sharded_scatter_plan parity)
      if (rows % n_shards) {
        scat_ok.store(false, std::memory_order_relaxed);
        return;
      }
      const int64_t shard_rows = rows / n_shards;
      const int64_t cap = shard_cap(n, n_shards);
      const int64_t nt = n_tiles_for(cap, shard_rows);
      // weight-0 padding -> sentinel (ops/scatter.make_sharded_scatter_plan
      // parity): without it every padding entry (id 0) counts against
      // shard 0's cap and overflows it at production occupancies
      std::vector<int32_t> gperm(n), gsort(n);
      if (!stable_radix_argsort_keyed(o.g_ids[g], o.g_wts[g],
                                      static_cast<int32_t>(rows), n,
                                      gperm.data(), gsort.data())) {
        scat_ok.store(false, std::memory_order_relaxed);  // id >= rows
        return;
      }
      const int64_t live = std::lower_bound(gsort.begin(), gsort.end(),
                                            static_cast<int32_t>(rows))
                           - gsort.begin();
      int64_t lo = 0;
      for (int64_t sh = 0; sh < n_shards; ++sh) {
        const int64_t bound = (sh + 1) * shard_rows;
        int64_t hi = std::lower_bound(gsort.begin() + lo, gsort.end(),
                                      static_cast<int32_t>(bound))
                     - gsort.begin();
        const int64_t cnt = hi - lo;
        int32_t* sid = s.ids + sh * cap;
        int32_t* spm = s.perm + sh * cap;
        int32_t* stl = s.tiles + sh * 4 * nt;
        s.live[sh] = static_cast<int32_t>(cnt);
        if (cnt > cap) {  // hot-key skew: consumer falls back to XLA
          s.ok[sh] = 0;
          lo = hi;
          continue;
        }
        const int32_t base = static_cast<int32_t>(sh * shard_rows);
        for (int64_t i = 0; i < cnt; ++i) {
          sid[i] = gsort[lo + i] - base;
          spm[i] = gperm[lo + i];
        }
        if (!build_tiles(sid, cnt, shard_rows, stl, nt)) {
          scat_ok.store(false, std::memory_order_relaxed);
          return;
        }
        s.ok[sh] = 1;
        lo = hi;
      }
      if (lo != live)  // ids >= rows (or < 0): contract violation
        scat_ok.store(false, std::memory_order_relaxed);
    };
    if (scats.size() == 1 || nt == 1) {
      for (const auto& s : scats) do_scat(s);
    } else {
      std::vector<std::thread> threads;
      for (const auto& s : scats) threads.emplace_back(do_scat, s);
      for (auto& th : threads) th.join();
    }
    if (!scat_ok.load()) return -2;  // id out of table range: wrong plan
  }
  lap("scat");

  // window-plan post-pass (ops/scatter.make_window_plan /
  // make_sharded_window_plan parity): remap weight-0 pool padding to an
  // out-of-range sentinel, sort, tile by fixed row windows; on a
  // hot-window overflow emit ok=0 and zero tiles (consumer falls back)
  for (const auto& s : wscats) {
    int64_t g = s.group;
    int64_t n = capacity * plan.group_packed[g];
    int64_t rows = plan.group_rows[g];
    const int64_t n_shards = plan.scatter_shards;
    const int32_t* gids = o.g_ids[g];
    const float* gwts = o.g_wts[g];
    if (n_shards <= 1) {
      int64_t nt_w = window_n_tiles(rows);
      int64_t sentinel = nt_w * kMaxr;
      if (!stable_radix_argsort_keyed(gids, gwts,
                                      static_cast<int32_t>(sentinel), n,
                                      s.perm, s.ids))
        return -2;  // id out of table range: wrong plan
      const int64_t cap = window_cap(n, rows);
      int32_t* starts = s.tiles;
      int32_t* offs = s.tiles + nt_w;
      int32_t* counts = s.tiles + 2 * nt_w;
      // first pass: window counts only (tiles must stay zero on overflow)
      bool fits = true;
      int64_t i = 0;
      std::vector<int64_t> bound(nt_w + 1, 0);
      for (int64_t t = 0; t < nt_w; ++t) {
        const int64_t hi_row = (t + 1) * kMaxr;
        while (i < n && s.ids[i] < hi_row) ++i;
        bound[t + 1] = i;
        if (i - bound[t] > cap) { fits = false; break; }
      }
      s.ok[0] = fits ? 1 : 0;
      if (!fits) continue;
      for (int64_t t = 0; t < nt_w; ++t) {
        starts[t] = static_cast<int32_t>(bound[t] / kAlignIds * kAlignIds);
        offs[t] = static_cast<int32_t>(bound[t] - starts[t]);
        counts[t] = static_cast<int32_t>(bound[t + 1] - bound[t]);
      }
      continue;
    }
    // sharded window plans: per-shard localized streams + window tiles
    if (rows % n_shards) return -2;  // same loud guard as the scat pass
    const int64_t shard_rows = rows / n_shards;
    const int64_t cap = shard_cap(n, n_shards);
    const int64_t nt_w = window_n_tiles(shard_rows);
    const int64_t wcap = window_cap(cap, shard_rows);
    std::vector<int32_t> gperm(n), gsort(n);
    if (!stable_radix_argsort_keyed(gids, gwts, static_cast<int32_t>(rows),
                                    n, gperm.data(), gsort.data()))
      return -2;  // id out of table range: wrong plan

    int64_t lo = 0;
    for (int64_t sh = 0; sh < n_shards; ++sh) {
      const int64_t bnd = (sh + 1) * shard_rows;
      int64_t hi = std::lower_bound(gsort.begin() + lo, gsort.end(),
                                    static_cast<int32_t>(bnd))
                   - gsort.begin();
      const int64_t cnt = hi - lo;
      int32_t* sid = s.ids + sh * cap;
      int32_t* spm = s.perm + sh * cap;
      int32_t* stl = s.tiles + sh * 3 * nt_w;
      s.live[sh] = static_cast<int32_t>(cnt);
      if (cnt > cap) { lo = hi; continue; }  // ok stays 0
      const int32_t base = static_cast<int32_t>(sh * shard_rows);
      // window counts before committing (tiles stay zero on overflow)
      bool fits = true;
      std::vector<int64_t> bound(nt_w + 1, 0);
      int64_t i = lo;
      for (int64_t t = 0; t < nt_w; ++t) {
        const int64_t hi_row = base + (t + 1) * kMaxr;
        while (i < hi && gsort[i] < hi_row) ++i;
        bound[t + 1] = i - lo;
        if (bound[t + 1] - bound[t] > wcap) { fits = false; break; }
      }
      if (!fits) { lo = hi; continue; }  // ok stays 0
      s.ok[sh] = 1;
      if (cnt == 0) { lo = hi; continue; }  // valid empty plan
      for (int64_t k = 0; k < cnt; ++k) {
        sid[k] = gsort[lo + k] - base;
        spm[k] = gperm[lo + k];
      }
      for (int64_t t = 0; t < nt_w; ++t) {
        stl[t] = static_cast<int32_t>(bound[t] / kAlignIds * kAlignIds);
        stl[nt_w + t] = static_cast<int32_t>(bound[t] - stl[t]);
        stl[2 * nt_w + t] = static_cast<int32_t>(bound[t + 1] - bound[t]);
      }
      lo = hi;
    }
  }

  lap("window");
  // compact (sopt) plan post-pass (ops/scatter.make_compact_plan /
  // make_sharded_compact_plan parity): dedup ranks over the sorted
  // stream + sentinel-padded unique rows + range tiles in compact space
  for (const auto& s : sopts) {
    int64_t g = s.group;
    int64_t n = capacity * plan.group_packed[g];
    int64_t rows = plan.group_rows[g];
    const int64_t n_shards = plan.scatter_shards;
    if (n_shards <= 1) {
      stable_radix_argsort(o.g_ids[g], n, s.perm, s.uids);  // uids = sorted
      // compact ranks into s.ids; unique rows into s.uids prefix
      int64_t u = 0;
      int32_t prev = -1;
      for (int64_t i = 0; i < n; ++i) {
        int32_t v = s.uids[i];
        if (i == 0 || v != prev) { s.uids[u] = v; ++u; prev = v; }
        s.ids[i] = static_cast<int32_t>(u - 1);
      }
      for (int64_t i = u; i < n; ++i)  // distinct ascending sentinels
        s.uids[i] = static_cast<int32_t>(rows + i);
      if (!build_tiles(s.ids, n, n, s.tiles, n_tiles_for(n, n)))
        return -3;  // compact ranks out of range: impossible unless bug
      continue;
    }
    if (rows % n_shards) return -2;  // same loud guard as the scat pass
    const int64_t shard_rows = rows / n_shards;
    const int64_t cap = shard_cap(n, n_shards);
    const int64_t nt = n_tiles_for(cap, cap);
    // sentinel-prefill uids (distinct ascending >= shard_rows)
    for (int64_t sh = 0; sh < n_shards; ++sh)
      for (int64_t i = 0; i < cap; ++i)
        s.uids[sh * cap + i] = static_cast<int32_t>(shard_rows + i);
    std::vector<int32_t> gperm(n), gsort(n);
    stable_radix_argsort(o.g_ids[g], n, gperm.data(), gsort.data());
    int64_t lo = 0;
    for (int64_t sh = 0; sh < n_shards; ++sh) {
      const int64_t bnd = (sh + 1) * shard_rows;
      int64_t hi = std::lower_bound(gsort.begin() + lo, gsort.end(),
                                    static_cast<int32_t>(bnd))
                   - gsort.begin();
      const int64_t cnt = hi - lo;
      s.live[sh] = static_cast<int32_t>(cnt);
      if (cnt > cap) { lo = hi; continue; }  // ok stays 0
      s.ok[sh] = 1;
      if (cnt == 0) { lo = hi; continue; }  // valid empty plan
      int32_t* su = s.uids + sh * cap;
      int32_t* sid = s.ids + sh * cap;
      int32_t* spm = s.perm + sh * cap;
      const int32_t base = static_cast<int32_t>(sh * shard_rows);
      int64_t u = 0;
      int32_t prev = -1;
      for (int64_t i = 0; i < cnt; ++i) {
        int32_t v = gsort[lo + i] - base;
        if (i == 0 || v != prev) { su[u] = v; ++u; prev = v; }
        sid[i] = static_cast<int32_t>(u - 1);
        spm[i] = gperm[lo + i];
      }
      for (int64_t i = u; i < cap; ++i)
        su[i] = static_cast<int32_t>(shard_rows + i);
      if (!build_tiles(sid, cnt, cap, s.tiles + sh * 4 * nt, nt))
        return -3;
      lo = hi;
    }
  }

  lap("sopt");
  // dedup-exchange post-pass (ops/scatter.make_dedup_plan parity):
  // per-shard unique LOCAL ids (sentinel shard_rows past the unique
  // count) + each entry's flat slot (shard*cap + unique position)
  for (const auto& s : dedups) {
    int64_t g = s.group;
    int64_t n = capacity * plan.group_packed[g];
    int64_t rows = plan.group_rows[g];
    const int64_t n_shards = std::max<int64_t>(plan.scatter_shards, 1);
    if (rows % n_shards) return -4;
    const int64_t shard_rows = rows / n_shards;
    const int64_t cap = s.cap;  // caller-computed (ops/scatter.dedup_cap)
    for (int64_t i = 0; i < n_shards * cap; ++i)
      s.uids[i] = static_cast<int32_t>(shard_rows);  // sentinel prefill
    std::vector<int32_t> gperm(n), gsort(n);
    stable_radix_argsort(o.g_ids[g], n, gperm.data(), gsort.data());
    int64_t sh = 0, u_in_shard = 0;
    int32_t cur_slot = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int32_t v = gsort[i];
      if (v < 0 || v >= rows) return -2;  // id out of range: wrong plan
      if (i == 0 || v != gsort[i - 1]) {
        while (v >= (sh + 1) * shard_rows) { ++sh; u_in_shard = 0; }
        if (u_in_shard >= cap) return -4;  // unique count > static cap
        s.uids[sh * cap + u_in_shard] =
            static_cast<int32_t>(v - sh * shard_rows);
        cur_slot = static_cast<int32_t>(sh * cap + u_in_shard);
        ++u_in_shard;
      }
      s.slots[gperm[i]] = cur_slot;
    }
  }
  lap("dedup");
  return n_rows;
}

}  // extern "C"
