// HTC1 gap-array encode for Hopper: row pack (B4b), row metadata (B4c) and
// bit placement (B4d).  Replaces the kernels of
// huffman_tpu/ops/pallas/gap_encode_kernel.py (wrapper encode_blocks_pallas).
// Blocks are cut into rows of ROW_BYTES = 128 input bytes; a row is one
// thread in every kernel here.
//
// gap_row_pack_kernel replaces _row_pack_kernel (B4b), with the input
// relayout _relayout_kernel (B4a) and the encode use of
// compact_kernel.py:_assemble_kernel (B3) folded into its addressing.  A
// row is still one thread: bytes little-endian within a word, codes from a
// shared-memory table of (len << 20) | code, packed MSB-first through a
// 64-bit accumulator into cap_words words (zero past the row's bits), with
// the row's bit count and each symbol's start bit within the row (< 128 *
// 16, an int16).  The TPU's static flush windows (_flush_bounds /
// _flush_window) bounded VMEM writes and do not survive.
//
// Its stores go through shared-memory tiles.  A block takes R consecutive
// rows (R threads; the wrapper picks R and the tile bytes), so each of its
// outputs is one contiguous range of device memory.  The block loads its R
// * 128 input bytes with coalesced 16-byte loads into a tile of pitch 33
// words, each thread packs its row from there into a pay tile of pitch
// cap_words + 1 words and, 32 symbols at a time, a starts tile of pitch 34
// int16 (17 words); after a barrier the block copies the starts chunk (64
// bytes a row, four 16-byte stores) and, at the end, the whole pay range
// (16-byte stores; the range starts at row0 * cap_words words, row0 a
// multiple of 32) to device memory.  The odd pitches put the 32 threads of
// a warp, each on its own row, in 32 banks.  (Stored from each thread at
// its row's stride, every warp store of a word or a start would touch 32
// sectors, and its 16-byte loads would sit 128 bytes apart.)
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
// 64 MiB block.  With its stores tiled, the pack is held by its serial
// chain (a table lookup and the accumulator per symbol, 128 symbols a
// thread) and by the occupancy its tiles allow (R * (33 + cap_words + 1 +
// 17) * 4 bytes a block: 50,688 at cap_words 48).

#include <cstdint>
#include <cuda_runtime.h>

#define ROW_BYTES 128
#define ROW_WORDS 32
#define ENC_THREADS 128

#define IN_PITCH (ROW_WORDS + 1)  // words of a row in the input tile
#define ST_CHUNK 32                // starts staged per pass, symbols
#define ST_PITCH (ST_CHUNK + 2)    // int16 of a row in the starts tile
#define PACK_MAX_ROWS 256

__global__ void __launch_bounds__(PACK_MAX_ROWS) gap_row_pack_kernel(
    const uint32_t* __restrict__ data, const int* __restrict__ enc,
    uint32_t* __restrict__ pay, int* __restrict__ row_bits,
    int16_t* __restrict__ starts, long long n_rows, int cap_words) {
  extern __shared__ uint4 smem[];
  __shared__ int s_enc[256];
  const int R = blockDim.x;
  const int tid = threadIdx.x;
  const int pay_pitch = cap_words + 1;
  uint32_t* s_in = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_pay = s_in + R * IN_PITCH;
  int16_t* s_st = reinterpret_cast<int16_t*>(s_pay + R * pay_pitch);
  for (int j = tid; j < 256; j += R) s_enc[j] = enc[j];

  // the block's rows [row0, row0 + nv): every thread reaches every barrier,
  // those past the last row skip only their own row's work
  const long long row0 = (long long)blockIdx.x * R;
  const int nv = (int)min((long long)R, n_rows - row0);
  const uint4* src = reinterpret_cast<const uint4*>(data + row0 * ROW_WORDS);
  for (int k = tid; k < nv * (ROW_WORDS / 4); k += R) {
    const uint4 v = src[k];
    uint32_t* d = s_in + (k >> 3) * IN_PITCH + 4 * (k & 7);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();

  const bool active = tid < nv;
  const uint32_t* in = s_in + tid * IN_PITCH;
  uint32_t* out = s_pay + tid * pay_pitch;
  int16_t* st = s_st + tid * ST_PITCH;
  uint64_t acc = 0;  // top `nacc` bits pending, nacc < 32 between symbols
  int nacc = 0, tot = 0, nw = 0;
  for (int c = 0; c < ROW_BYTES / ST_CHUNK; ++c) {
    if (active) {
      for (int q = 0; q < ST_CHUNK / 4; ++q) {
        const uint32_t w = in[c * (ST_CHUNK / 4) + q];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int e = s_enc[(w >> (8 * b)) & 255];
          const int ln = e >> 20;
          st[4 * q + b] = (int16_t)tot;
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
    __syncthreads();
    // the chunk's 64 bytes of each row: four 16-byte stores (R % 4 == 0)
    const int part = tid & 3;
    for (int r = tid >> 2; r < nv; r += R >> 2) {
      const uint32_t* s =
          reinterpret_cast<const uint32_t*>(s_st + r * ST_PITCH) + 4 * part;
      reinterpret_cast<uint4*>(starts + (row0 + r) * ROW_BYTES +
                               c * ST_CHUNK)[part] =
          make_uint4(s[0], s[1], s[2], s[3]);
    }
    __syncthreads();
  }
  if (active) {
    if (nacc > 0) {
      if (nw < cap_words) out[nw] = (uint32_t)(acc >> 32);
      ++nw;
    }
    for (; nw < cap_words; ++nw) out[nw] = 0;
    row_bits[row0 + tid] = tot;
  }
  __syncthreads();

  // the block's pay words, one contiguous range from word row0 * cap_words
  // (16-byte aligned: row0 is a multiple of 32)
  uint32_t* dst = pay + row0 * cap_words;
  const int n_words = nv * cap_words;
  for (int k = tid; k < n_words / 4; k += R) {
    int r = 4 * k / cap_words;
    int col = 4 * k - r * cap_words;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = s_pay[r * pay_pitch + col];
      if (++col == cap_words) {
        col = 0;
        ++r;
      }
    }
    reinterpret_cast<uint4*>(dst)[k] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int f = (n_words & ~3) + tid; f < n_words; f += R) {
    const int r = f / cap_words;
    dst[f] = s_pay[r * pay_pitch + f - r * cap_words];
  }
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

// The tile bytes a block of `rows` rows needs (the wrapper's
// `row_pack_tile` computes the same).
static long long row_pack_smem(int rows, int cap_words) {
  return 4LL * rows * (IN_PITCH + cap_words + 1 + ST_PITCH / 2);
}

extern "C" int gap_row_pack_launch(const void* data, const void* enc,
                                   void* pay, void* row_bits, void* starts,
                                   long long n_rows, int cap_words,
                                   int rows_per_block, int smem_bytes,
                                   void* stream) {
  if (rows_per_block < 32 || rows_per_block > PACK_MAX_ROWS ||
      rows_per_block % 32 || cap_words < 0 ||
      smem_bytes != row_pack_smem(rows_per_block, cap_words))
    return (int)cudaErrorInvalidValue;
  // above 48 KB only after this; a refusal is returned, and cleared so
  // that it does not surface at a later launch's check
  cudaError_t err = cudaFuncSetAttribute(
      gap_row_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  gap_row_pack_kernel<<<(unsigned)blocks, rows_per_block, smem_bytes,
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
