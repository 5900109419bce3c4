// Canonical bit walks over an MSB-first u32 stream: B1 (gap_decode.cu)
// reads through BitWindow and takes canon_len from shared memory, as C1
// does where its count table decides nothing; C2 (selfsync.cu), A1
// (ils_decode.cu) and C1's table kernel take the compare chain with its
// limits in registers (CanonRegs).  Words outside [0, n_words) read as
// zeros.
#pragma once

#include <cstdint>

// A 64-bit window over the stream, its top `nbits` bits valid.  nbits >= 33
// before every codeword, so the top 32 bits are always stream bits.
struct BitWindow {
  const uint32_t* words;
  long long n_words;
  long long next;  // the word that the next refill loads
  uint64_t buf;
  int nbits;

  __device__ __forceinline__ uint64_t word(long long i) const {
    return (i >= 0 && i < n_words) ? words[i] : 0u;
  }

  __device__ __forceinline__ BitWindow(const uint32_t* w, long long n,
                                       long long pos)
      : words(w), n_words(n) {
    const long long w0 = pos >> 5;
    const int off = (int)(pos & 31);
    buf = ((word(w0) << 32) | word(w0 + 1)) << off;
    nbits = 64 - off;
    next = w0 + 2;
  }

  // the 32 stream bits at the current position
  __device__ __forceinline__ uint32_t peek() const {
    return (uint32_t)(buf >> 32);
  }

  // drop ln in [1, 16] bits, then refill to nbits >= 33
  __device__ __forceinline__ void skip(int ln) {
    buf <<= ln;
    nbits -= ln;
    if (nbits <= 32) {
      buf |= word(next++) << (32 - nbits);
      nbits += 32;
    }
  }
};

// canonical length: min_len + #{l in [min_len, max_len) : win >= lim[l]}
__device__ __forceinline__ int canon_len(uint32_t win, const uint32_t* lim,
                                         int min_len, int max_len) {
  int ln = min_len;
  for (int l = min_len; l < max_len; ++l) ln += (win >= lim[l]);
  return ln;
}

// canon_len with the limits held in registers, no loads per codeword:
// lim[l - 1] holds lim[l] for l in [min_len, max_len) and 0 elsewhere, so
// canon_len = max_len - #{l : win < lim[l - 1]} (win < 0 is never true).
// `src` may be global or shared memory.
struct CanonRegs {
  uint32_t lim[15];
  int max_len;

  __device__ __forceinline__ CanonRegs(const uint32_t* src, int min_len,
                                       int max_len_)
      : max_len(max_len_) {
#pragma unroll
    for (int l = 1; l < 16; ++l)
      lim[l - 1] = (l >= min_len && l < max_len_) ? src[l] : 0u;
  }

  __device__ __forceinline__ int len(uint32_t win) const {
    int ln = max_len;
#pragma unroll
    for (int l = 0; l < 15; ++l) ln -= (win < lim[l]);
    return ln;
  }
};
