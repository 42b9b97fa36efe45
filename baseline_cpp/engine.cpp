// Single-core baseline engine: a faithful stand-in for the Rust reference's
// architecture (SURVEY.md §3.1), used as the measured denominator of the
// engine-vs-single-core comparison (BASELINE.json north_star; the Rust
// toolchain is not available to the build, SURVEY.md §7.7).
//
// Architecture mirrors the reference deliberately:
//   for each segment:            (tantivy Searcher::segment_readers)
//     for each doc:              (Scorer docset iteration)
//       if deleted: continue     (DeleteBitSet)
//       if !matches(query): continue
//       collect(doc)             (SegmentAgg::collect: per-doc fast-field
//                                 reads, hashmap bucket upserts)
//   merge per-segment fruits     (PreparedAgg::merge, keyed by term BYTES
//                                 for terms apps — segment ordinals are
//                                 segment-local, SURVEY.md §A.6)
//
// Reads the engine's on-disk segment format via a manifest generated by
// bench.py. Emits raw integer fruits as JSON (mono-domain bit patterns for
// f64 order statistics, decimal strings for 128-bit sums); bench.py
// finalizes both engines' fruits with the same exact-arithmetic helpers, so
// equality is bit-exact.
//
// Build: make (g++ -O2). Usage: engine <manifest> <config 1..5> <reps>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

using std::string;
using std::vector;

typedef unsigned __int128 u128;
typedef __int128 i128;

static string dec(u128 v) {
  if (v == 0) return "0";
  string s;
  while (v > 0) { s.push_back('0' + (int)(v % 10)); v /= 10; }
  std::reverse(s.begin(), s.end());
  return s;
}

// order-preserving f64 -> int64 (mono domain; matches utils/mono.py)
static int64_t f64_mono(double d) {
  uint64_t bits;
  memcpy(&bits, &d, 8);
  uint64_t m = (bits & 0x8000000000000000ULL)
                   ? (~bits ^ 0x8000000000000000ULL)
                   : bits;
  return (int64_t)m;
}

struct Field {
  string name, type;  // u64|i64|f64|date|keyword
  bool multi = false, csr = false;
  vector<uint64_t> u64v;
  vector<int64_t> i64v;
  vector<double> f64v;
  vector<uint32_t> kwv;      // keyword local ords
  vector<uint32_t> offsets;  // csr
  vector<string> terms;      // keyword, segment-local sorted
};

struct Segment {
  uint32_t max_doc = 0;
  vector<uint8_t> alive;  // empty = all alive
  std::map<string, Field> fields;
  bool is_alive(uint32_t d) const { return alive.empty() || alive[d]; }
};

template <typename T>
static void read_bin(const string& path, vector<T>& out) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) { fprintf(stderr, "missing %s\n", path.c_str()); exit(2); }
  size_t n = (size_t)f.tellg() / sizeof(T);
  out.resize(n);
  f.seekg(0);
  f.read((char*)out.data(), n * sizeof(T));
}

static vector<string> read_lines(const string& path) {
  std::ifstream f(path);
  vector<string> out;
  string line;
  while (std::getline(f, line)) out.push_back(line);
  return out;
}

struct Index {
  vector<Segment> segs;
};

static Index load(const string& manifest) {
  std::ifstream f(manifest);
  if (!f) { fprintf(stderr, "no manifest\n"); exit(2); }
  Index idx;
  string kind, base;
  {
    string line;
    std::getline(f, line);  // "base <dir>"
    std::istringstream is(line);
    is >> kind >> base;
  }
  string line;
  Segment* seg = nullptr;
  string segdir;
  while (std::getline(f, line)) {
    std::istringstream is(line);
    is >> kind;
    if (kind == "segment") {
      idx.segs.emplace_back();
      seg = &idx.segs.back();
      int has_alive;
      is >> segdir >> seg->max_doc >> has_alive;
      if (has_alive)
        read_bin(base + "/" + segdir + "/alive.bin", seg->alive);
    } else if (kind == "field") {
      string name, type;
      int multi, csr;
      is >> name >> type >> multi >> csr;
      Field& fl = seg->fields[name];
      fl.name = name; fl.type = type;
      fl.multi = multi; fl.csr = csr;
      string vp = base + "/" + segdir + "/" + name + ".values.bin";
      if (type == "keyword") {
        read_bin(vp, fl.kwv);
        fl.terms = read_lines(base + "/" + segdir + "/" + name + ".terms.txt");
      } else if (type == "f64") {
        read_bin(vp, fl.f64v);
      } else if (type == "i64") {
        read_bin(vp, fl.i64v);
      } else {
        read_bin(vp, fl.u64v);
      }
      if (csr)
        read_bin(base + "/" + segdir + "/" + name + ".offsets.bin", fl.offsets);
    }
  }
  return idx;
}

static int kw_ord(const Field& f, const string& term) {
  auto it = std::lower_bound(f.terms.begin(), f.terms.end(), term);
  if (it != f.terms.end() && *it == term) return (int)(it - f.terms.begin());
  return -1;
}

// ---------------------------------------------------------------------------
// per-doc "scorers" (match predicates over fast fields)
// ---------------------------------------------------------------------------

struct TermKwPred {  // keyword term query (single- or multi-valued via CSR)
  const Field* f;
  int ord;
  bool operator()(uint32_t d) const {
    if (ord < 0) return false;
    uint32_t lo = f->offsets[d], hi = f->offsets[d + 1];
    for (uint32_t i = lo; i < hi; i++)
      if (f->kwv[i] == (uint32_t)ord) return true;
    return false;
  }
};

struct RangeU64Pred {  // inclusive-lower / inclusive-upper u64 range
  const Field* f;
  uint64_t lo, hi;
  bool operator()(uint32_t d) const {
    uint64_t v = f->u64v[d];
    return v >= lo && v <= hi;
  }
};

// ---------------------------------------------------------------------------
// configs (BASELINE.json): each returns its raw-fruit JSON
// ---------------------------------------------------------------------------

static string config1(const Index& idx) {  // count + sum(amount), match-all
  u128 sum = 0;
  uint64_t n = 0;
  for (auto& s : idx.segs) {
    const Field& amount = s.fields.at("amount");
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d)) continue;
      n++;
      sum += amount.u64v[d];
    }
  }
  std::ostringstream o;
  o << "{\"n\":" << n << ",\"s\":\"" << dec(sum) << "\"}";
  return o.str();
}

static string config2(const Index& idx) {  // min/max(price), avg(weights) | status=active
  uint64_t cnt = 0;            // matched price values (single-valued: docs)
  int64_t mn = INT64_MAX, mx = INT64_MIN;
  u128 wsum = 0;
  uint64_t wcnt = 0;
  for (auto& s : idx.segs) {
    const Field& status = s.fields.at("status");
    const Field& price = s.fields.at("price");
    const Field& weights = s.fields.at("weights");
    TermKwPred match{&status, kw_ord(status, "active")};
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d) || !match(d)) continue;
      int64_t pm = f64_mono(price.f64v[d]);
      cnt++;
      if (pm < mn) mn = pm;
      if (pm > mx) mx = pm;
      for (uint32_t i = weights.offsets[d]; i < weights.offsets[d + 1]; i++) {
        wsum += weights.u64v[i];
        wcnt++;
      }
    }
  }
  std::ostringstream o;
  o << "{\"cnt\":" << cnt << ",\"lo_bits\":" << mn << ",\"hi_bits\":" << mx
    << ",\"w_sum\":\"" << dec(wsum) << "\",\"w_cnt\":" << wcnt << "}";
  return o.str();
}

static string config3(const Index& idx) {  // date histogram(ts, 1d) + sum(amount)
  const int64_t interval = 86400000000LL;
  struct B { uint64_t cnt = 0; u128 sum = 0; };
  std::map<int64_t, B> buckets;  // ordered => ascending keys
  for (auto& s : idx.segs) {
    const Field& ts = s.fields.at("ts");
    const Field& amount = s.fields.at("amount");
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d)) continue;
      int64_t k = (int64_t)(ts.u64v[d] / (uint64_t)interval);
      B& b = buckets[k];
      b.cnt++;
      b.sum += amount.u64v[d];
    }
  }
  std::ostringstream o;
  o << "{\"buckets\":[";
  bool first = true;
  for (auto& kv : buckets) {
    if (!first) o << ",";
    first = false;
    o << "[" << kv.first * interval << "," << kv.second.cnt << ",\""
      << dec(kv.second.sum) << "\"]";
  }
  o << "]}";
  return o.str();
}

struct TB { uint64_t cnt = 0; u128 sum = 0; uint64_t cnt2 = 0; };

// order_by_sum: top-k by (sum desc, key asc) — config 6's sub-metric
// ordering (SURVEY.md §A.6); default is (count desc, key asc)
static string terms_out(std::map<string, TB>& merged, size_t size,
                        bool order_by_sum = false) {
  vector<std::pair<string, TB>> v(merged.begin(), merged.end());
  if (order_by_sum)
    std::sort(v.begin(), v.end(), [](auto& a, auto& b) {
      if (a.second.sum != b.second.sum) return a.second.sum > b.second.sum;
      return a.first < b.first;
    });
  else
    std::sort(v.begin(), v.end(), [](auto& a, auto& b) {
      if (a.second.cnt != b.second.cnt) return a.second.cnt > b.second.cnt;
      return a.first < b.first;
    });
  u128 total = 0;
  for (auto& kv : v) total += kv.second.cnt;
  u128 shown = 0;
  std::ostringstream o;
  o << "{\"buckets\":[";
  for (size_t i = 0; i < v.size() && i < size; i++) {
    if (i) o << ",";
    shown += v[i].second.cnt;
    o << "[\"" << v[i].first << "\"," << v[i].second.cnt << ",\""
      << dec(v[i].second.sum) << "\"," << v[i].second.cnt2 << "]";
  }
  o << "],\"other\":\"" << dec(total - shown) << "\"}";
  return o.str();
}

static string terms_sku(const Index& idx, bool order_by_sum) {
  // per-segment hashmap on LOCAL ordinals, merged by term bytes (§A.6)
  std::map<string, TB> merged;
  for (auto& s : idx.segs) {
    const Field& sku = s.fields.at("sku");
    const Field& amount = s.fields.at("amount");
    std::unordered_map<uint32_t, TB> local;
    local.reserve(1024);
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d)) continue;
      for (uint32_t i = sku.offsets[d]; i < sku.offsets[d + 1]; i++) {
        TB& b = local[sku.kwv[i]];
        b.cnt++;
        b.sum += amount.u64v[d];
        b.cnt2++;
      }
    }
    for (auto& kv : local) {
      TB& m = merged[sku.terms[kv.first]];
      m.cnt += kv.second.cnt;
      m.sum += kv.second.sum;
      m.cnt2 += kv.second.cnt2;
    }
  }
  return terms_out(merged, 10, order_by_sum);
}

static string config4(const Index& idx) {  // terms(sku, 10) {sum(amount), count}
  return terms_sku(idx, false);
}

static string config6(const Index& idx) {  // terms(sku, 10, order=sum desc)
  return terms_sku(idx, true);
}

struct TermU64CsrPred {  // u64 term query over a multi-valued (CSR) field
  const Field* f;
  uint64_t v;
  bool operator()(uint32_t d) const {
    for (uint32_t i = f->offsets[d]; i < f->offsets[d + 1]; i++)
      if (f->u64v[i] == v) return true;
    return false;
  }
};

static string config7(const Index& idx) {
  // terms(sku, 10) {sum(amount), count} | weights contains 500
  std::map<string, TB> merged;
  for (auto& s : idx.segs) {
    const Field& sku = s.fields.at("sku");
    const Field& amount = s.fields.at("amount");
    const Field& weights = s.fields.at("weights");
    TermU64CsrPred match{&weights, 500};
    std::unordered_map<uint32_t, TB> local;
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d) || !match(d)) continue;
      for (uint32_t i = sku.offsets[d]; i < sku.offsets[d + 1]; i++) {
        TB& b = local[sku.kwv[i]];
        b.cnt++;
        b.sum += amount.u64v[d];
        b.cnt2++;
      }
    }
    for (auto& kv : local) {
      TB& m = merged[sku.terms[kv.first]];
      m.cnt += kv.second.cnt;
      m.sum += kv.second.sum;
      m.cnt2 += kv.second.cnt2;
    }
  }
  return terms_out(merged, 10);
}

// proleptic-Gregorian civil-date math (Hinnant's algorithm) — the shared
// calendar_interval spec (see tantivy_aggregations_tpu/utils/calendar.py);
// independent C++ implementation, bit-compared via the bench identity gate
static void civil_from_days(int64_t z, int64_t& y, int64_t& m) {
  z += 719468;
  int64_t era = (z >= 0 ? z : z - 146096) / 146097;
  int64_t doe = z - era * 146097;
  int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  int64_t yy = yoe + era * 400;
  int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  int64_t mp = (5 * doy + 2) / 153;
  m = mp < 10 ? mp + 3 : mp - 9;
  y = (m <= 2) ? yy + 1 : yy;
}

static int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  int64_t era = (y >= 0 ? y : y - 399) / 400;
  int64_t yoe = y - era * 400;
  int64_t mp = m >= 3 ? m - 3 : m + 9;
  int64_t doy = (153 * mp + 2) / 5 + d - 1;
  int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

static int64_t month_start_micros(uint64_t v) {
  const int64_t DAY = 86400000000LL;
  int64_t day = (int64_t)(v / (uint64_t)DAY);
  int64_t y, m;
  civil_from_days(day, y, m);
  return days_from_civil(y, m, 1) * DAY;
}

static string config8(const Index& idx) {
  // count + calendar-month histogram(ts){sum(amount)} | sku prefix "sku000"
  const string prefix = "sku000";
  struct B { uint64_t cnt = 0; u128 sum = 0; };
  std::map<int64_t, B> buckets;
  uint64_t n = 0;
  for (auto& s : idx.segs) {
    const Field& sku = s.fields.at("sku");
    const Field& ts = s.fields.at("ts");
    const Field& amount = s.fields.at("amount");
    // terms are sorted: prefix-matching ordinals form one contiguous run
    vector<uint8_t> tmask(sku.terms.size(), 0);
    for (size_t t = 0; t < sku.terms.size(); t++)
      tmask[t] = sku.terms[t].compare(0, prefix.size(), prefix) == 0;
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d)) continue;
      bool hit = false;
      for (uint32_t i = sku.offsets[d]; i < sku.offsets[d + 1] && !hit; i++)
        hit = tmask[sku.kwv[i]];
      if (!hit) continue;
      n++;
      B& b = buckets[month_start_micros(ts.u64v[d])];
      b.cnt++;
      b.sum += amount.u64v[d];
    }
  }
  std::ostringstream o;
  o << "{\"n\":" << n << ",\"buckets\":[";
  bool first = true;
  for (auto& kv : buckets) {
    if (!first) o << ",";
    first = false;
    o << "[" << kv.first << "," << kv.second.cnt << ",\""
      << dec(kv.second.sum) << "\"]";
  }
  o << "]}";
  return o.str();
}

static string config9(const Index& idx) {
  // terms(status,4){percentiles(price,[25,50,75])} | 100 <= amount <= 9000
  // — mirrors the engine's per-bucket slot_rank percentile device path
  // (SURVEY.md §2.1 C8 nested)
  struct SB {
    uint64_t cnt = 0;
    vector<int64_t> prices;  // f64 monos
  };
  std::map<string, SB> merged;
  for (auto& s : idx.segs) {
    const Field& amount = s.fields.at("amount");
    const Field& price = s.fields.at("price");
    const Field& status = s.fields.at("status");
    RangeU64Pred match{&amount, 100, 9000};
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d) || !match(d)) continue;
      for (uint32_t i = status.offsets[d]; i < status.offsets[d + 1]; i++) {
        SB& b = merged[status.terms[status.kwv[i]]];
        b.cnt++;
        b.prices.push_back(f64_mono(price.f64v[d]));
      }
    }
  }
  // (count desc, key asc) over all 4 status buckets
  vector<std::pair<string, SB*>> order;
  for (auto& kv : merged) order.emplace_back(kv.first, &kv.second);
  std::sort(order.begin(), order.end(), [](auto& a, auto& b) {
    if (a.second->cnt != b.second->cnt) return a.second->cnt > b.second->cnt;
    return a.first < b.first;
  });
  static const int PCTS[] = {25, 50, 75};
  std::ostringstream o;
  o << "{\"buckets\":[";
  bool first = true;
  for (auto& kv : order) {
    SB& b = *kv.second;
    std::sort(b.prices.begin(), b.prices.end());
    if (!first) o << ",";
    first = false;
    o << "[\"" << kv.first << "\"," << b.cnt << ",[";
    uint64_t m = b.prices.size();
    for (int i = 0; i < 3; i++) {
      if (i) o << ",";
      if (m == 0) { o << "[0,0]"; continue; }
      uint64_t num = (uint64_t)PCTS[i] * (m - 1);
      uint64_t lo = num / 100;
      uint64_t hi = std::min(lo + 1, m - 1);
      o << "[" << b.prices[lo] << "," << b.prices[hi] << "]";
    }
    o << "]]";
  }
  o << "],\"other\":0}";
  return o.str();
}

static string config5(const Index& idx) {
  // percentiles(price) + post_filter(status=active){count,sum(qty),
  // histogram(qty,10)} + terms(status,4){sum(amount)} | 100<=amount<=9000
  vector<int64_t> prices;
  uint64_t pf_n = 0;
  u128 pf_sum = 0;
  std::map<int64_t, uint64_t> pf_hist;
  std::map<string, TB> st_merged;
  for (auto& s : idx.segs) {
    const Field& amount = s.fields.at("amount");
    const Field& price = s.fields.at("price");
    const Field& qty = s.fields.at("qty");
    const Field& status = s.fields.at("status");
    RangeU64Pred match{&amount, 100, 9000};
    TermKwPred active{&status, kw_ord(status, "active")};
    std::unordered_map<uint32_t, TB> st_local;
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d) || !match(d)) continue;
      prices.push_back(f64_mono(price.f64v[d]));
      if (active(d)) {
        pf_n++;
        pf_sum += qty.u64v[d];
        pf_hist[(int64_t)(qty.u64v[d] / 10)]++;
      }
      for (uint32_t i = status.offsets[d]; i < status.offsets[d + 1]; i++) {
        TB& b = st_local[status.kwv[i]];
        b.cnt++;
        b.sum += amount.u64v[d];
      }
    }
    for (auto& kv : st_local) {
      TB& m = st_merged[status.terms[kv.first]];
      m.cnt += kv.second.cnt;
      m.sum += kv.second.sum;
    }
  }
  std::sort(prices.begin(), prices.end());
  uint64_t m = prices.size();
  static const int PCTS[] = {1, 5, 25, 50, 75, 95, 99};
  std::ostringstream o;
  o << "{\"m\":" << m << ",\"ranks\":[";
  for (int i = 0; i < 7; i++) {
    if (i) o << ",";
    if (m == 0) { o << "[0,0]"; continue; }
    // exact integer rank arithmetic (percents are integers; matches
    // utils/exact.py percentile_rank for integer p)
    uint64_t num = (uint64_t)PCTS[i] * (m - 1);
    uint64_t lo = num / 100;
    uint64_t hi = std::min(lo + 1, m - 1);
    o << "[" << prices[lo] << "," << prices[hi] << "]";
  }
  o << "],\"pf_n\":" << pf_n << ",\"pf_sum\":\"" << dec(pf_sum)
    << "\",\"pf_hist\":[";
  bool first = true;
  for (auto& kv : pf_hist) {
    if (!first) o << ",";
    first = false;
    o << "[" << kv.first * 10 << "," << kv.second << "]";
  }
  o << "],\"st\":" << terms_out(st_merged, 4) << "}";
  return o.str();
}

static string config10(const Index& idx) {
  // count + sum(amount) + histogram(amount, 500) | sku IN {8-term set}
  // (TermSetQuery canonical set — models/flagship.py::c10_values(0))
  vector<string> set_terms;
  for (int i = 0; i < 8; i++) {
    char buf[16];
    snprintf(buf, sizeof buf, "sku%07d", (101 * i) % 100000);
    set_terms.push_back(buf);
  }
  std::map<int64_t, uint64_t> buckets;
  uint64_t n = 0;
  u128 sum = 0;
  for (auto& s : idx.segs) {
    const Field& sku = s.fields.at("sku");
    const Field& amount = s.fields.at("amount");
    vector<uint8_t> tmask(sku.terms.size(), 0);
    for (auto& t : set_terms) {
      int o = kw_ord(sku, t);
      if (o >= 0) tmask[o] = 1;
    }
    for (uint32_t d = 0; d < s.max_doc; d++) {
      if (!s.is_alive(d)) continue;
      bool hit = false;
      for (uint32_t i = sku.offsets[d]; i < sku.offsets[d + 1] && !hit; i++)
        hit = tmask[sku.kwv[i]];
      if (!hit) continue;
      n++;
      uint64_t v = amount.u64v[d];
      sum += v;
      buckets[(int64_t)(v / 500 * 500)]++;
    }
  }
  std::ostringstream o;
  o << "{\"n\":" << n << ",\"s\":\"" << dec(sum) << "\",\"buckets\":[";
  bool first = true;
  for (auto& kv : buckets) {
    if (!first) o << ",";
    first = false;
    o << "[" << kv.first << "," << kv.second << "]";
  }
  o << "]}";
  return o.str();
}

int main(int argc, char** argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: engine <manifest> <config 1..10> <reps>\n");
    return 2;
  }
  Index idx = load(argv[1]);
  int cfg = atoi(argv[2]);
  int reps = atoi(argv[3]);
  string (*fns[])(const Index&) = {config1, config2, config3, config4,
                                   config5, config6, config7, config8,
                                   config9, config10};
  if (cfg < 1 || cfg > 10) return 2;
  string result = fns[cfg - 1](idx);  // warmup + canonical result
  double best = 1e30;
  for (int r = 0; r < reps; r++) {
    auto t0 = std::chrono::steady_clock::now();
    string res = fns[cfg - 1](idx);
    auto t1 = std::chrono::steady_clock::now();
    double dt = std::chrono::duration<double>(t1 - t0).count();
    if (dt < best) best = dt;
    if (res != result) { fprintf(stderr, "nondeterministic!\n"); return 3; }
  }
  printf("{\"config\":%d,\"seconds\":%.6f,\"result\":%s}\n", cfg, best,
         result.c_str());
  return 0;
}
