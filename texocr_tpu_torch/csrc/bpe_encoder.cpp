// Native BPE encoder: the merge loop of RegexBPETokenizer._encode_text
// (see ../tokenizer/bpe.py), bit-exact, in C++ for the host-side tokenization hot path
// (the reference re-encodes every label each __getitem__, and dataset builds
// encode 100k labels; reference tokenizer/tokenizer.py:202-220).
//
// Semantics replicated exactly:
//   repeat:
//     among adjacent pairs present in the sequence, pick the one with the
//     LOWEST merge id (training order); if none is a known merge, stop;
//     replace every non-overlapping left-to-right occurrence.
//
// Exposed via a C ABI for ctypes; one handle per loaded merge table.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Encoder {
  // pair (a, b) -> merge id; ids fit in int32.
  std::unordered_map<uint64_t, int32_t> merges;
};

inline uint64_t key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

// One split: apply lowest-id eligible merge until none applies.
// `buf` is modified in place; returns the new length.
int encode_inplace(const Encoder& enc, std::vector<int32_t>& buf) {
  while (buf.size() >= 2) {
    // Find the present pair with the lowest merge id.
    int32_t best_id = INT32_MAX;
    int32_t best_a = 0, best_b = 0;
    for (size_t i = 0; i + 1 < buf.size(); ++i) {
      auto it = enc.merges.find(key(buf[i], buf[i + 1]));
      if (it != enc.merges.end() && it->second < best_id) {
        best_id = it->second;
        best_a = buf[i];
        best_b = buf[i + 1];
      }
    }
    if (best_id == INT32_MAX) break;

    // Replace left-to-right, non-overlapping.
    size_t w = 0;
    for (size_t r = 0; r < buf.size();) {
      if (r + 1 < buf.size() && buf[r] == best_a && buf[r + 1] == best_b) {
        buf[w++] = best_id;
        r += 2;
      } else {
        buf[w++] = buf[r++];
      }
    }
    buf.resize(w);
  }
  return static_cast<int>(buf.size());
}

}  // namespace

extern "C" {

void* bpe_create(const int32_t* pair_a, const int32_t* pair_b,
                 const int32_t* ids, int32_t n) {
  auto* enc = new Encoder();
  enc->merges.reserve(static_cast<size_t>(n) * 2);
  for (int32_t i = 0; i < n; ++i) {
    enc->merges.emplace(key(pair_a[i], pair_b[i]), ids[i]);
  }
  return enc;
}

void bpe_destroy(void* handle) { delete static_cast<Encoder*>(handle); }

// Encode many splits in one call (amortizes the FFI boundary).
//   ids_in:      concatenated byte ids of all splits
//   offsets:     n_splits+1 prefix offsets into ids_in
//   ids_out:     output buffer, at least offsets[n_splits] ints
//   out_offsets: n_splits+1 prefix offsets into ids_out (written)
// Returns total output length.
int32_t bpe_encode_many(void* handle, const int32_t* ids_in,
                        const int32_t* offsets, int32_t n_splits,
                        int32_t* ids_out, int32_t* out_offsets) {
  const auto& enc = *static_cast<Encoder*>(handle);
  std::vector<int32_t> buf;
  int32_t w = 0;
  out_offsets[0] = 0;
  for (int32_t s = 0; s < n_splits; ++s) {
    const int32_t lo = offsets[s], hi = offsets[s + 1];
    buf.assign(ids_in + lo, ids_in + hi);
    const int n = encode_inplace(enc, buf);
    std::memcpy(ids_out + w, buf.data(), sizeof(int32_t) * n);
    w += n;
    out_offsets[s + 1] = w;
  }
  return w;
}

}  // extern "C"
