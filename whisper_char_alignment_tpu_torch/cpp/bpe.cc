// Copy of cpp/bpe.cc for the PyTorch port, unchanged.
// Byte-pair encoding core: rank-table lookup + greedy lowest-rank merging.
// Native replacement for the Rust tiktoken core the reference depends on
// (SURVEY.md §2b #13). Exposed via ctypes (text/_bpe_native.py).
//
// The rank table is passed as one serialized blob:
//   [n_entries: int64] then per entry [len: int32][bytes...][rank: int32]

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
  std::unordered_map<std::string, int32_t> ranks;
};

}  // namespace

extern "C" {

// Returns the table handle, or nullptr on ANY inconsistency (short blob,
// negative entry length, fewer entries than the header claims, allocation
// failure). Failing loudly matters: a silently truncated table would encode
// differently from the Python fallback with no signal.
void* bpe_new(const uint8_t* blob, int64_t blob_len) {
  try {
    if (blob_len < 8) return nullptr;
    int64_t n;
    std::memcpy(&n, blob, 8);
    // each entry needs >= 8 bytes, so n beyond blob_len/8 is corrupt — and
    // must not reach reserve() as a giant allocation
    if (n < 0 || n > blob_len / 8) return nullptr;
    auto* bpe = new Bpe();
    bpe->ranks.reserve((size_t)n * 2);
    int64_t pos = 8;
    for (int64_t i = 0; i < n; i++) {
      if (pos + 4 > blob_len) { delete bpe; return nullptr; }
      int32_t len;
      std::memcpy(&len, blob + pos, 4);
      pos += 4;
      if (len < 0 || pos + (int64_t)len + 4 > blob_len) {
        delete bpe;
        return nullptr;
      }
      std::string key((const char*)(blob + pos), (size_t)len);
      pos += len;
      int32_t rank;
      std::memcpy(&rank, blob + pos, 4);
      pos += 4;
      bpe->ranks.emplace(std::move(key), rank);
    }
    return bpe;
  } catch (...) {  // bad_alloc must not unwind into the ctypes frames
    return nullptr;
  }
}

void bpe_free(void* h) { delete (Bpe*)h; }

// Encode one pre-tokenized piece. Returns the number of ids written to `out`
// (capacity `out_cap`), or -1 if a byte is missing from the table / overflow.
int32_t bpe_encode(void* h, const uint8_t* piece, int32_t len, int32_t* out,
                   int32_t out_cap) {
 try {
  auto* bpe = (Bpe*)h;
  if (len <= 0) return 0;

  // whole-piece fast path
  {
    auto it = bpe->ranks.find(std::string((const char*)piece, (size_t)len));
    if (it != bpe->ranks.end()) {
      if (out_cap < 1) return -1;
      out[0] = it->second;
      return 1;
    }
  }

  // boundaries[i] = start offset of part i; parts are piece[b[i], b[i+1])
  std::vector<int32_t> bounds(len + 1);
  for (int32_t i = 0; i <= len; i++) bounds[i] = i;

  auto rank_of = [&](int32_t a, int32_t b) -> int64_t {
    auto it = bpe->ranks.find(std::string((const char*)piece + a, (size_t)(b - a)));
    return it == bpe->ranks.end() ? INT64_MAX : it->second;
  };

  while (bounds.size() > 2) {
    int64_t best_rank = INT64_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 2 < bounds.size(); i++) {
      int64_t r = rank_of(bounds[i], bounds[i + 2]);
      if (r < best_rank) {
        best_rank = r;
        best_i = i;
      }
    }
    if (best_rank == INT64_MAX) break;
    bounds.erase(bounds.begin() + (long)best_i + 1);
  }

  int32_t count = (int32_t)bounds.size() - 1;
  if (count > out_cap) return -1;
  for (int32_t i = 0; i < count; i++) {
    int64_t r = rank_of(bounds[i], bounds[i + 1]);
    if (r == INT64_MAX) return -1;  // missing single byte: malformed table
    out[i] = (int32_t)r;
  }
  return count;
 } catch (...) {  // allocation failure -> caller's per-piece Python fallback
  return -1;
 }
}

}  // extern "C"
