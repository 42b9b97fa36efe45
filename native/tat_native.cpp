// Native ingestion kernels for tantivy_aggregations_tpu.
//
// The device consumes immutable columns; building them is host work, and its
// hot spot is term-dictionary construction + ordinal encoding for
// keyword/text fields (SURVEY.md §2.2 T3/T5: tantivy's FST term dict and
// fast-field serialization are native Rust — this is the rebuild's native
// equivalent, exposed to Python via ctypes).
//
// encode_terms: given N strings (concatenated UTF-8 bytes + offsets),
// produce the sorted unique dictionary and the ordinal of each input
// string. Two-phase API so Python owns all allocations:
//   phase 1 (out_ords == ords, dict buffers null): writes ords against a
//     temporary dict, returns dict size and required dict byte length.
//   phase 2: fills dict bytes + offsets.
// A stateful handle keeps the dictionary between phases.
//
// Build: make -C native  ->  libtat_native.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Encoder {
  std::vector<std::string_view> uniq_sorted;
  std::vector<uint32_t> ords;      // per input string, into uniq_sorted
  std::vector<char> storage;       // owns the bytes backing the views
  uint64_t dict_bytes = 0;
};

}  // namespace

extern "C" {

// Returns an opaque handle. n strings; bytes/offsets describe them
// (offsets has n+1 entries). The input buffers only need to live for this
// call — bytes are copied into the handle.
void* tat_encode_terms(const char* bytes, const uint64_t* offsets,
                       uint64_t n) {
  auto* e = new Encoder();
  e->storage.assign(bytes, bytes + offsets[n]);
  const char* base = e->storage.data();

  std::unordered_map<std::string_view, uint32_t> first_seen;
  first_seen.reserve(n * 2 + 16);
  std::vector<uint32_t> tmp_ord(n);
  std::vector<std::string_view> uniq;
  uniq.reserve(1024);
  for (uint64_t i = 0; i < n; i++) {
    std::string_view s(base + offsets[i], offsets[i + 1] - offsets[i]);
    auto it = first_seen.find(s);
    if (it == first_seen.end()) {
      uint32_t id = (uint32_t)uniq.size();
      first_seen.emplace(s, id);
      uniq.push_back(s);
      tmp_ord[i] = id;
    } else {
      tmp_ord[i] = it->second;
    }
  }
  // sort dictionary, remap ordinals
  std::vector<uint32_t> order(uniq.size());
  for (uint32_t i = 0; i < order.size(); i++) order[i] = i;
  std::sort(order.begin(), order.end(), [&](uint32_t a, uint32_t b) {
    return uniq[a] < uniq[b];
  });
  std::vector<uint32_t> rank(uniq.size());
  e->uniq_sorted.resize(uniq.size());
  for (uint32_t i = 0; i < order.size(); i++) {
    rank[order[i]] = i;
    e->uniq_sorted[i] = uniq[order[i]];
  }
  e->ords.resize(n);
  for (uint64_t i = 0; i < n; i++) e->ords[i] = rank[tmp_ord[i]];
  for (auto& s : e->uniq_sorted) e->dict_bytes += s.size();
  return e;
}

uint64_t tat_dict_size(void* h) {
  return ((Encoder*)h)->uniq_sorted.size();
}

uint64_t tat_dict_bytes(void* h) {
  return ((Encoder*)h)->dict_bytes;
}

// Copy results out. ords: uint32[n]; dict_bytes: char[tat_dict_bytes];
// dict_offsets: uint64[dict_size + 1].
void tat_fill(void* h, uint32_t* out_ords, char* out_dict_bytes,
              uint64_t* out_dict_offsets) {
  Encoder* e = (Encoder*)h;
  memcpy(out_ords, e->ords.data(), e->ords.size() * sizeof(uint32_t));
  uint64_t pos = 0;
  out_dict_offsets[0] = 0;
  for (size_t i = 0; i < e->uniq_sorted.size(); i++) {
    memcpy(out_dict_bytes + pos, e->uniq_sorted[i].data(),
           e->uniq_sorted[i].size());
    pos += e->uniq_sorted[i].size();
    out_dict_offsets[i + 1] = pos;
  }
}

void tat_free(void* h) { delete (Encoder*)h; }

}  // extern "C"
