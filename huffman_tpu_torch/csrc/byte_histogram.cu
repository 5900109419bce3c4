// Byte histogram for Hopper: the (256,) int64 count of n bytes.
//
// byte_histogram_kernel replaces no Pallas kernel.  The JAX package counts
// bytes with an XLA scatter-add (huffman_tpu/ops/encode.py::histogram, the
// role of the reference encoder's warp-privatised histogram kernels).  It
// takes the place of torch.bincount, whose one shared-memory histogram per
// block serialises its atomics on the few bins that skewed data fills (at
// redundancy 0.9 nine tenths of the bytes fall on 'A'-'D').  The ILS encode
// counts every section with it (IlsCodec._avg_bits), the codecs' fit too.
//
// Bound on this card: bytes, each read once: 10^9 B / 3.35 TB/s = 0.299 ms.
//
// Skew: no two threads ever share a counter, so an increment is a plain
// shared-memory load, add and store, never an atomic, whatever the data.
// Each thread owns one 8-bit counter per bin.  The counters of bin b form
// row b, 256 bytes, one a thread; thread t's byte is column
// 4 * (t % 64) + t / 64, so the 32 lanes of a warp always touch 32 words in
// 32 distinct banks: a constant stream costs what a random one costs.
// Every HIST_ROUNDS rounds, at most 224 bytes a thread, before a counter can
// wrap, the block drains: thread b sums row b with __dp4a and zeroes it,
// walking the row's 16-byte words in a rotation by b that keeps each
// quarter-warp's loads on distinct banks.  A block's totals are 64-bit, and
// at the end each thread adds its bin's total to the output with one 64-bit
// atomic add (the launch zeroes the output first), so a count is exact for
// any n.
//
// Loads are 16 B a thread, coalesced, grid-strided in rounds of HIST_VECS a
// thread (28 KiB a block, three blocks an SM); a round's loads are issued
// before the drain and the barriers, so they overlap them.  The unaligned head and the ragged tail (under 16 bytes each)
// are counted by block 0 before its first round.  Integer sums in any
// order: the counts are exact and deterministic.
//
// Measured on an H100 at 10^9 B (`tools/bench_histogram_torch.py`): the
// shared-memory pipe bounds it (a load and a store a byte, a drain's 128 KiB
// every 56 KiB a block); 15 loads a round spilled at three blocks an SM and
// lost a third, and shared atomics (one a byte) or 16-bit counters (no
// drains, but 12 warps an SM) ran slower.

#include <cstdint>
#include <cuda_runtime.h>

#define HIST_THREADS 256
#define HIST_VECS 7    // 16-byte loads a thread a round
#define HIST_ROUNDS 2  // rounds between drains: 224 B a thread, under 256
#define HIST_CHUNK (HIST_THREADS * HIST_VECS)  // 16-byte words a round
#define HIST_SMEM (256 * HIST_THREADS)         // one byte a (bin, thread)

// add one to the counters of the four bytes of w; col = this thread's
// column, rows 256 bytes apart (the bin shifted left by 8)
__device__ __forceinline__ void count_word(uint8_t* col, uint32_t w) {
  col[__byte_perm(w, 0, 0x4404)] += 1;
  col[w & 0xFF00u] += 1;
  col[__byte_perm(w, 0, 0x4424)] += 1;
  col[__byte_perm(w, 0, 0x4434)] += 1;
}

__device__ __forceinline__ void count_vec(uint8_t* col, uint4 v) {
  count_word(col, v.x);
  count_word(col, v.y);
  count_word(col, v.z);
  count_word(col, v.w);
}

// thread b's sum of row b, which it leaves zeroed
__device__ __forceinline__ uint32_t drain_row(uint8_t* s, int b) {
  uint4* row = reinterpret_cast<uint4*>(s + (b << 8));
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = (i + b) & 15;
    const uint4 w = row[j];
    row[j] = make_uint4(0u, 0u, 0u, 0u);
    sum = __dp4a(w.x, 0x01010101u, sum);
    sum = __dp4a(w.y, 0x01010101u, sum);
    sum = __dp4a(w.z, 0x01010101u, sum);
    sum = __dp4a(w.w, 0x01010101u, sum);
  }
  return sum;
}

__global__ void __launch_bounds__(HIST_THREADS, 3) byte_histogram_kernel(
    const uint8_t* __restrict__ data, int head, long long n_vec, int tail,
    unsigned long long* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem);
  const int t = threadIdx.x;
  uint8_t* col = s + (((t & 63) << 2) | (t >> 6));
  {
    uint4* row = reinterpret_cast<uint4*>(s + (t << 8));
#pragma unroll
    for (int i = 0; i < 16; ++i) row[(i + t) & 15] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const uint4* body = reinterpret_cast<const uint4*>(data + head);
  if (blockIdx.x == 0) {
    if (t < head) col[data[t] << 8] += 1;
    if (t < tail) col[data[head + 16 * n_vec + t] << 8] += 1;
  }
  unsigned long long total = 0;
  const long long n_chunks = (n_vec + HIST_CHUNK - 1) / HIST_CHUNK;
  long long c = blockIdx.x;
  uint4 v[HIST_VECS];
  if (c < n_chunks) {
#pragma unroll
    for (int k = 0; k < HIST_VECS; ++k) {
      const long long i = c * HIST_CHUNK + k * HIST_THREADS + t;
      if (i < n_vec) v[k] = body[i];
    }
  }
  int rounds = 0;
  while (c < n_chunks) {
#pragma unroll
    for (int k = 0; k < HIST_VECS; ++k) {
      if (c * HIST_CHUNK + k * HIST_THREADS + t < n_vec) count_vec(col, v[k]);
    }
    const long long next = c + gridDim.x;
    if (next < n_chunks) {
#pragma unroll
      for (int k = 0; k < HIST_VECS; ++k) {
        const long long i = next * HIST_CHUNK + k * HIST_THREADS + t;
        if (i < n_vec) v[k] = body[i];
      }
    }
    if (++rounds == HIST_ROUNDS) {
      rounds = 0;
      __syncthreads();
      total += drain_row(s, t);
      __syncthreads();
    }
    c = next;
  }
  // what the last rounds (or block 0's head and tail alone) left
  __syncthreads();
  total += drain_row(s, t);
  if (total) atomicAdd(out + t, total);
}

extern "C" int byte_histogram_launch(const void* data, long long n, void* out,
                                     void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, 256 * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  // a refusal is returned, and cleared so that it does not surface at a
  // later launch's check
  err = cudaFuncSetAttribute(byte_histogram_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             HIST_SMEM);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, byte_histogram_kernel, HIST_THREADS, HIST_SMEM);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const uintptr_t addr = (uintptr_t)data;
  long long head = (long long)((16 - (addr & 15)) & 15);
  if (head > n) head = n;
  const long long n_vec = (n - head) / 16;
  const long long tail = n - head - 16 * n_vec;
  // one block an SM slot at most; a grid-stride loop covers the rest
  long long blocks = (n_vec + HIST_CHUNK - 1) / HIST_CHUNK;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > slots) blocks = slots;
  if (blocks < 1) blocks = 1;
  byte_histogram_kernel<<<(unsigned)blocks, HIST_THREADS, HIST_SMEM, st>>>(
      (const uint8_t*)data, (int)head, n_vec, (int)tail,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
