// Gap-array decode for Hopper: segment ranks (kernel B1), the ragged
// placement of the symbols (kernel B2) and, for gap-only Yamamoto
// streams, the per-segment symbol counts (kernel C1).
//
// gap_decode_ranks_kernel replaces huffman_tpu/ops/pallas/decode_kernel.py:
// _kernel (wrapper decode_ranks_pallas) together with the decode use of
// compact_kernel.py:_assemble_kernel (B3).  One thread per segment: it
// starts at bit s*seg_bits + gap[s] of its block, decodes count[s]
// canonical codewords and writes their ranks (rank & 255) as bytes into
// row s of a (segments, max_count) matrix, zero past count[s].  The TPU's
// relayout of segment words into lanes (_segw_planes), its one-hot pair
// refill and the rows transpose of B3 all exist for the vector layout; a
// thread here loads its own words, so none survives.  Words past the
// block's end read as zeros (the JAX package pads each block to the
// segment grid instead).
//
// The ranks go through a shared-memory tile.  A block takes R consecutive
// segments (flat index t, R threads), so its R rows of the matrix are one
// contiguous range.  A row can hold ~8,200 ranks (seg_bits=8192, 1-bit
// codes), so the block walks the columns in chunks of C (a multiple of 8,
// at most 64; the wrapper picks R and C): each thread decodes up to C
// codewords into its row of a tile [R][C + 4] bytes, zeros past its count,
// then after a barrier the block stores the tile, consecutive lanes on
// consecutive 4-byte words (bytes where max_count % 4 != 0) of each row's
// chunk, so a warp store fills whole sectors.  The pitch (C + 4) / 4 words
// is odd, so the threads of a warp, each on its own row, write 32 banks.
// The bit window stays in registers across chunks; shared memory does not
// depend on max_count.  (Stored from each thread at its row's stride, every
// warp store of a rank would touch 32 sectors.)
//
// gap_place_bytes_kernel replaces compact_kernel.py:_kernel (wrapper
// ragged_concat_pallas): out[off[s] + i] = symtab[rank[s, i]] for
// i < count[s], with off the exclusive prefix sum of the counts.  The
// extents are disjoint, so there are no atomics, and no band plan
// (plan_compact / plan_tiles) is needed: one warp per segment, its lanes
// striding over the row, so reads and writes are coalesced.
//
// gap_count_segments_kernel replaces decode_kernel.py:_count_kernel
// (wrapper count_segments_pallas), the counting pass of gap-only
// (Yamamoto) streams: one thread per segment walks the canonical compare
// chain, lengths only, from bit s*seg_bits + gap[s] and counts the
// codewords that start before the next segment's entry (the last segment:
// before total_bits), at most max_count of them.  Bit positions are 64-bit
// (the JAX kernel's int32 arithmetic is a TPU limit; the format's u32
// word count allows more).  The TPU kernel's lane relayout, its one-hot
// pair refill and its 2x counting granularity with the fold all serve the
// vector layout; a thread here loads its own words.
//
// B1 and C1 read the stream through the window and walk of bitwalk.cuh,
// which the self-sync kernel C2 shares.
//
// Bounds on this card.  B1 reads the payload once and writes the rank
// matrix (~1 byte per symbol); with its stores tiled, its time is the
// serial bit chain of each segment (length compare -> shift -> next
// window), ~200 symbols at seg_bits=1024, with one thread per segment.
// B2 is bytes-bound: rank matrix in, output out.  C1 reads the payload
// once and writes one int
// per segment; at 128-bit segments a thread's chain is ~20 codewords, so
// it has many more threads than B1 at 1024 bits for the same payload.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitwalk.cuh"

#define RANK_MAX_ROWS 256
#define RANK_PAD 4  // tile pitch chunk + 4 bytes: odd words for chunk % 8 == 0
#define COUNT_THREADS 256
#define PLACE_THREADS 256
#define PLACE_WARPS (PLACE_THREADS / 32)

// Rows [0, nv) of a tile of `pitch` bytes a row to rows of `dst_pitch`
// bytes from dst: `width` bytes each, in units U (width and the addresses
// multiples of sizeof(U)); consecutive threads on consecutive units.
template <typename U>
__device__ __forceinline__ void store_rows(const uint8_t* tile, int pitch,
                                           uint8_t* dst, long long dst_pitch,
                                           int nv, int width) {
  const int units = width / (int)sizeof(U);  // <= blockDim.x
  const int per = blockDim.x / units;        // rows a pass
  const int r0 = threadIdx.x / units;
  if (r0 >= per) return;
  const int c = threadIdx.x - r0 * units;
  for (int r = r0; r < nv; r += per)
    reinterpret_cast<U*>(dst + r * dst_pitch)[c] =
        reinterpret_cast<const U*>(tile + r * pitch)[c];
}

__global__ void __launch_bounds__(RANK_MAX_ROWS) gap_decode_ranks_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ gaps,
    const int* __restrict__ counts, const uint32_t* __restrict__ lim,
    const int* __restrict__ bias, uint8_t* __restrict__ ranks,
    long long n_segs_all, int n_segs, long long n_words, int seg_bits,
    int max_count, int min_len, int max_len, int chunk) {
  extern __shared__ uint4 smem[];
  __shared__ uint32_t s_lim[32];
  __shared__ int s_bias[32];
  if (threadIdx.x < 32) {
    s_lim[threadIdx.x] = lim[threadIdx.x];
    s_bias[threadIdx.x] = bias[threadIdx.x];
  }
  __syncthreads();

  // the block's segments [t0, t0 + nv): every thread reaches every barrier,
  // those past the last segment decode nothing
  const long long t0 = (long long)blockIdx.x * blockDim.x;
  const long long t = t0 + threadIdx.x;
  const int nv = (int)min((long long)blockDim.x, n_segs_all - t0);
  long long g = 0, pos = 0;
  int n = 0;
  if (threadIdx.x < nv) {
    g = t / n_segs;
    pos = (t - g * n_segs) * seg_bits + gaps[t];
    n = min(max(counts[t], 0), max_count);
  }
  // the words of this block; zero outside it
  BitWindow bw(words + g * n_words, n_words, pos);
  const int pitch = chunk + RANK_PAD;
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem);
  uint8_t* row = tile + threadIdx.x * pitch;
  uint8_t* dst = ranks + t0 * max_count;
  for (int lo = 0; lo < max_count; lo += chunk) {
    const int width = min(chunk, max_count - lo);
    const int m = min(max(n - lo, 0), width);  // codewords in this chunk
    for (int i = 0; i < m; ++i) {
      const uint32_t win = bw.peek();
      const int ln = canon_len(win, s_lim, min_len, max_len);
      // ln is in [1, 16], so the shift is in range
      row[i] = (uint8_t)(s_bias[ln] + (int)(win >> (32 - ln)));
      bw.skip(ln);
    }
    for (int i = m; i < width; ++i) row[i] = 0;
    __syncthreads();
    if (max_count % 4 == 0) {
      store_rows<uint32_t>(tile, pitch, dst + lo, max_count, nv, width);
    } else {
      store_rows<uint8_t>(tile, pitch, dst + lo, max_count, nv, width);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(PLACE_THREADS) gap_place_bytes_kernel(
    const uint8_t* __restrict__ ranks, const int* __restrict__ counts,
    const long long* __restrict__ offsets, const int* __restrict__ symtab,
    uint8_t* __restrict__ out, long long n_segs_all, int max_count,
    long long n_out) {
  __shared__ uint8_t s_sym[256];
  for (int j = threadIdx.x; j < 256; j += PLACE_THREADS) s_sym[j] = (uint8_t)symtab[j];
  __syncthreads();

  const long long seg = (long long)blockIdx.x * PLACE_WARPS + (threadIdx.x >> 5);
  if (seg >= n_segs_all) return;
  const int n = min(max(counts[seg], 0), max_count);
  const long long o = offsets[seg];
  const uint8_t* row = ranks + seg * max_count;
  // a corrupt count or offset stays inside the output
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    const long long d = o + i;
    if (d >= 0 && d < n_out) out[d] = s_sym[row[i]];
  }
}

__global__ void __launch_bounds__(COUNT_THREADS) gap_count_segments_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ gaps,
    const uint32_t* __restrict__ lim, int* __restrict__ counts,
    long long n_segs, long long n_words, long long total_bits, int seg_bits,
    int max_count, int min_len, int max_len) {
  __shared__ uint32_t s_lim[32];
  if (threadIdx.x < 32) s_lim[threadIdx.x] = lim[threadIdx.x];
  __syncthreads();

  const long long s = (long long)blockIdx.x * COUNT_THREADS + threadIdx.x;
  if (s >= n_segs) return;
  long long pos = s * seg_bits + gaps[s];
  long long end = total_bits;
  if (s + 1 < n_segs) end = min(end, (s + 1) * seg_bits + gaps[s + 1]);
  counts[s] = walk_count(words, n_words, pos, end, max_count, s_lim, min_len,
                         max_len);
}

extern "C" int gap_count_segments_launch(const void* words, const void* gaps,
                                         const void* lim, void* counts,
                                         long long n_segs, long long n_words,
                                         long long total_bits, int seg_bits,
                                         int max_count, int min_len,
                                         int max_len, void* stream) {
  const long long blocks = (n_segs + COUNT_THREADS - 1) / COUNT_THREADS;
  gap_count_segments_kernel<<<(unsigned)blocks, COUNT_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)gaps, (const uint32_t*)lim,
      (int*)counts, n_segs, n_words, total_bits, seg_bits, max_count, min_len,
      max_len);
  return (int)cudaGetLastError();
}

extern "C" int gap_decode_ranks_launch(const void* words, const void* gaps,
                                       const void* counts, const void* lim,
                                       const void* bias, void* ranks,
                                       long long n_segs_all, int n_segs,
                                       long long n_words, int seg_bits,
                                       int max_count, int min_len,
                                       int max_len, int rows_per_block,
                                       int chunk, int smem_bytes,
                                       void* stream) {
  // the wrapper's `ranks_tile` computes the same geometry
  if (rows_per_block < 32 || rows_per_block > RANK_MAX_ROWS ||
      rows_per_block % 32 || chunk < 8 || chunk % 8 ||
      chunk > rows_per_block ||
      smem_bytes != rows_per_block * (chunk + RANK_PAD))
    return (int)cudaErrorInvalidValue;
  // a refusal is returned, and cleared so that it does not surface at a
  // later launch's check
  cudaError_t err = cudaFuncSetAttribute(
      gap_decode_ranks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const long long blocks = (n_segs_all + rows_per_block - 1) / rows_per_block;
  gap_decode_ranks_kernel<<<(unsigned)blocks, rows_per_block, smem_bytes,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)gaps, (const int*)counts,
      (const uint32_t*)lim, (const int*)bias, (uint8_t*)ranks, n_segs_all,
      n_segs, n_words, seg_bits, max_count, min_len, max_len, chunk);
  return (int)cudaGetLastError();
}

extern "C" int gap_place_bytes_launch(const void* ranks, const void* counts,
                                      const void* offsets, const void* symtab,
                                      void* out, long long n_segs_all,
                                      int max_count, long long n_out,
                                      void* stream) {
  const long long blocks = (n_segs_all + PLACE_WARPS - 1) / PLACE_WARPS;
  gap_place_bytes_kernel<<<(unsigned)blocks, PLACE_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)ranks, (const int*)counts, (const long long*)offsets,
      (const int*)symtab, (uint8_t*)out, n_segs_all, max_count, n_out);
  return (int)cudaGetLastError();
}
