// Canonical code lengths of a window over an MSB-first u32 stream: B1
// (gap_decode.cu) takes canon_len with its limits in shared memory, as C1
// does where its count table decides nothing; C2 (selfsync.cu), A1
// (ils_decode.cu) and C1's table kernel take the compare chain with its
// limits in registers (CanonRegs).  Each kernel keeps its own bit window
// (B1's StagedWindow, C2's SubWindow), in which words outside [0, n_words)
// read as zeros.
#pragma once

#include <cstdint>

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
