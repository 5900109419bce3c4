// HTC1 gap-array encode for Hopper: row pack (B4b), row metadata (B4c) and
// bit placement (B4d).  Replaces the kernels of
// huffman_tpu/ops/pallas/gap_encode_kernel.py (wrapper encode_blocks_pallas).
// Blocks are cut into rows of ROW_BYTES = 128 input bytes; a row is one
// thread in every kernel here.
//
// gap_row_pack_kernel replaces _row_pack_kernel (B4b), with the input
// relayout _relayout_kernel (B4a) and the encode use of
// compact_kernel.py:_assemble_kernel (B3) folded into its addressing: the
// thread loads its row's 32 words in natural order (eight 16-byte loads)
// instead of the TPU's lane-per-row transpose, and writes its packed words
// row-major.  Bytes are little-endian within a word, codes come from a
// shared-memory table of (len << 20) | code, and are packed MSB-first
// through a 64-bit accumulator into cap_words words (zero past the row's
// bits).  It also writes the row's bit count and each symbol's start bit
// within the row (< 128 * 16, an int16).  The TPU's static flush windows
// (_flush_bounds / _flush_window) bounded VMEM writes and do not survive.
//
// gap_row_meta_kernel replaces _row_meta_kernel (B4c) and the sorted
// segment_sum / segment_min after it.  Each row walks its 128 absolute
// start bits (monotone), and for each run of starts in one segment adds
// the run length to that segment's count (atomicAdd) and its first start
// to the segment's first start (atomicMin): integer operations whose
// order does not change the result, so the metadata is deterministic.  A
// 2048-bit row touches at most a few segments, so a row issues a few
// atomics, not 128.  (The unique-straddler rule would avoid atomics; the
// atomics are the simpler first form.)
//
// gap_place_bits_kernel replaces _place_bits_kernel (B4d): row r's words,
// masked to its bit count, shifted right by s & 31 and written at word
// s >> 5 of its block's output, s being the row's block-local start bit
// (64-bit).  Output words wholly inside the row are stored; the first and
// the last, which the neighbouring rows share, are atomicOr'ed into the
// zeroed output, as the reference encoder writes its boundary words.
//
// Bounds on this card: bytes.  The pack reads the input once and writes
// cap_words words, 2 bytes of start per symbol and the bit counts; the
// metadata reads the starts; the placement reads the rows and writes the
// payload.  One thread per 128-byte row gives n/128 threads: 524,288 for a
// 64 MiB block.

#include <cstdint>
#include <cuda_runtime.h>

#define ROW_BYTES 128
#define ROW_WORDS 32
#define ENC_THREADS 128

__global__ void __launch_bounds__(ENC_THREADS) gap_row_pack_kernel(
    const uint32_t* __restrict__ data, const int* __restrict__ enc,
    uint32_t* __restrict__ pay, int* __restrict__ row_bits,
    int16_t* __restrict__ starts, long long n_rows, int cap_words) {
  __shared__ int s_enc[256];
  for (int j = threadIdx.x; j < 256; j += ENC_THREADS) s_enc[j] = enc[j];
  __syncthreads();

  const long long r = (long long)blockIdx.x * ENC_THREADS + threadIdx.x;
  if (r >= n_rows) return;
  const uint4* in = reinterpret_cast<const uint4*>(data + r * ROW_WORDS);
  uint32_t* out = pay + r * cap_words;
  int16_t* st = starts + r * ROW_BYTES;
  uint64_t acc = 0;  // top `nacc` bits pending, nacc < 32 between symbols
  int nacc = 0, tot = 0, nw = 0;
  for (int q = 0; q < ROW_WORDS / 4; ++q) {
    const uint4 v = in[q];
    const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = s_enc[(ws[j] >> (8 * b)) & 255];
        const int ln = e >> 20;
        st[16 * q + 4 * j + b] = (int16_t)tot;
        tot += ln;
        // ln == 0 (a symbol absent from the table) adds nothing
        if (ln) acc |= (uint64_t)(e & 0xFFFF) << (64 - nacc - ln);
        nacc += ln;
        if (nacc >= 32) {
          if (nw < cap_words) out[nw] = (uint32_t)(acc >> 32);
          ++nw;
          acc <<= 32;
          nacc -= 32;
        }
      }
    }
  }
  if (nacc > 0) {
    if (nw < cap_words) out[nw] = (uint32_t)(acc >> 32);
    ++nw;
  }
  for (; nw < cap_words; ++nw) out[nw] = 0;
  row_bits[r] = tot;
}

__global__ void __launch_bounds__(ENC_THREADS) gap_row_meta_kernel(
    const int16_t* __restrict__ starts, const long long* __restrict__ s_local,
    int* __restrict__ counts, int* __restrict__ firsts, long long n_rows,
    int rows_per_block, int n_segs, int seg_shift) {
  const long long r = (long long)blockIdx.x * ENC_THREADS + threadIdx.x;
  if (r >= n_rows) return;
  const long long g = r / rows_per_block;
  int* cnt = counts + g * n_segs;
  int* fst = firsts + g * n_segs;
  const int16_t* st = starts + r * ROW_BYTES;
  const long long base = s_local[r];
  long long seg = -1;
  int run = 0, first = 0;
  auto flush = [&]() {
    if (run && seg >= 0 && seg < n_segs) {
      atomicAdd(cnt + seg, run);
      atomicMin(fst + seg, first);
    }
  };
  for (int i = 0; i < ROW_BYTES; ++i) {
    const long long a = base + st[i];
    const long long sg = a >> seg_shift;
    if (sg != seg) {
      flush();
      seg = sg;
      run = 0;
      first = (int)a;
    }
    ++run;
  }
  flush();
}

__global__ void __launch_bounds__(ENC_THREADS) gap_place_bits_kernel(
    const uint32_t* __restrict__ pay, const int* __restrict__ row_bits,
    const long long* __restrict__ s_local, uint32_t* __restrict__ out,
    long long n_rows, int rows_per_block, int cap_words,
    long long out_words) {
  const long long r = (long long)blockIdx.x * ENC_THREADS + threadIdx.x;
  if (r >= n_rows) return;
  const int bits = min(max(row_bits[r], 0), 32 * cap_words);
  if (bits == 0) return;
  const long long g = r / rows_per_block;
  uint32_t* o = out + g * out_words;
  const uint32_t* p = pay + r * cap_words;
  const long long s = s_local[r];
  const long long w0 = s >> 5;
  const int sh = (int)(s & 31);
  const int nw = (bits + 31) >> 5;         // the row's own words
  const int last = (sh + bits - 1) >> 5;   // its last output word, from w0
  uint32_t prev = 0;
  for (int k = 0; k <= last; ++k) {
    uint32_t cur = 0;
    if (k < nw) {
      cur = p[k];
      const int keep = bits - 32 * k;  // bits of word k inside the row
      if (keep < 32) cur &= ~0u << (32 - keep);
    }
    const uint32_t v = (cur >> sh) | (sh ? prev << (32 - sh) : 0u);
    prev = cur;
    const long long d = w0 + k;
    if (d < 0 || d >= out_words) continue;
    if (k == 0 || k == last) {
      atomicOr(o + d, v);
    } else {
      o[d] = v;
    }
  }
}

extern "C" int gap_row_pack_launch(const void* data, const void* enc,
                                   void* pay, void* row_bits, void* starts,
                                   long long n_rows, int cap_words,
                                   void* stream) {
  const long long blocks = (n_rows + ENC_THREADS - 1) / ENC_THREADS;
  gap_row_pack_kernel<<<(unsigned)blocks, ENC_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)data, (const int*)enc, (uint32_t*)pay, (int*)row_bits,
      (int16_t*)starts, n_rows, cap_words);
  return (int)cudaGetLastError();
}

extern "C" int gap_row_meta_launch(const void* starts, const void* s_local,
                                   void* counts, void* firsts,
                                   long long n_rows, int rows_per_block,
                                   int n_segs, int seg_shift, void* stream) {
  const long long blocks = (n_rows + ENC_THREADS - 1) / ENC_THREADS;
  gap_row_meta_kernel<<<(unsigned)blocks, ENC_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const int16_t*)starts, (const long long*)s_local, (int*)counts,
      (int*)firsts, n_rows, rows_per_block, n_segs, seg_shift);
  return (int)cudaGetLastError();
}

extern "C" int gap_place_bits_launch(const void* pay, const void* row_bits,
                                     const void* s_local, void* out,
                                     long long n_rows, int rows_per_block,
                                     int cap_words, long long out_words,
                                     void* stream) {
  const long long blocks = (n_rows + ENC_THREADS - 1) / ENC_THREADS;
  gap_place_bits_kernel<<<(unsigned)blocks, ENC_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)pay, (const int*)row_bits, (const long long*)s_local,
      (uint32_t*)out, n_rows, rows_per_block, cap_words, out_words);
  return (int)cudaGetLastError();
}
