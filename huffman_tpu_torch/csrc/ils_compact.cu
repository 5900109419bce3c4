// ILS compaction (kernel A3) for Hopper.
//
// Replaces huffman_tpu/ops/pallas/ils_kernels.py:_compact_kernel (wrapper
// ils_compact): copies each tile's w_tiles[t] payload rows of 4 KB from its
// worst-case-stride region (row t*stride_rows) to its compact row offset
// row_starts[t], then zeroes the w_cap slack rows after the last tile.  The
// tiles' rows cover [0, total_rows) exactly, so no other row needs a fill.
//
// Bound on this card: bytes.  It reads total_rows * 4 KB once and writes
// (total_rows + w_cap) * 4 KB once; ~0.12 ms for the ~200 MB payload of a
// 256 MiB section at 3.35 TB/s.
//
// Design: a grid of (tile + 1, 32) blocks of 256 threads; each block strides
// over its tile's rows in 16-byte vectors, so consecutive threads move
// consecutive 16-byte words (fully coalesced reads and writes); the extra
// grid column writes the zero slack.  The TPU's staged w_cap-row DMA and its
// tile-ordered overwrite of the over-read rows are not needed: exactly the
// tile's own rows move.

#include "ils_common.cuh"

#define COMPACT_THREADS 256
#define COMPACT_BLOCKS_PER_TILE 32
#define VEC_PER_ROW (ILS_LANES * 4 / 16)

__global__ void __launch_bounds__(COMPACT_THREADS) ils_compact_kernel(
    const int4* __restrict__ src, const int* __restrict__ row_starts,
    int4* __restrict__ dst, int n_tiles, long long stride_rows,
    long long total_rows, int w_cap) {
  const int t = blockIdx.x;
  if (t == n_tiles) {
    int4* d = dst + (size_t)total_rows * VEC_PER_ROW;
    const long long n = (long long)w_cap * VEC_PER_ROW;
    for (long long x = (long long)blockIdx.y * COMPACT_THREADS + threadIdx.x;
         x < n; x += (long long)COMPACT_BLOCKS_PER_TILE * COMPACT_THREADS) {
      d[x] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  // row starts are taken on trust (no host check): clamp the tile's copy
  // into [0, total_rows) and to its stride region, so bad offsets can
  // never leave either buffer
  const long long start = min(max((long long)row_starts[t], 0LL), total_rows);
  long long end = (t + 1 < n_tiles) ? (long long)row_starts[t + 1] : total_rows;
  end = min(max(end, start), min(total_rows, start + stride_rows));
  const long long n = (end - start) * VEC_PER_ROW;
  const int4* s = src + (size_t)t * stride_rows * VEC_PER_ROW;
  int4* d = dst + (size_t)start * VEC_PER_ROW;
  for (long long x = (long long)blockIdx.y * COMPACT_THREADS + threadIdx.x;
       x < n; x += (long long)COMPACT_BLOCKS_PER_TILE * COMPACT_THREADS) {
    d[x] = s[x];
  }
}

extern "C" int ils_compact_launch(const void* src, const void* row_starts,
                                  void* dst, int n_tiles,
                                  long long stride_rows, long long total_rows,
                                  int w_cap, void* stream) {
  dim3 grid(n_tiles + 1, COMPACT_BLOCKS_PER_TILE);
  ils_compact_kernel<<<grid, COMPACT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)src, (const int*)row_starts, (int4*)dst, n_tiles,
      stride_rows, total_rows, w_cap);
  return (int)cudaGetLastError();
}
