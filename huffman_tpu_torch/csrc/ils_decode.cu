// ILS decode (kernel A1) for Hopper.
//
// Replaces huffman_tpu/ops/pallas/ils_kernels.py:_decode_kernel (wrapper
// ils_decode).  Every stream of every tile decodes its k canonical
// codewords; four symbols make one output u32, which IS the original data
// word (with the inverse lane rotation when the section is rotated).
//
// Bound on this card: bytes.  The kernel reads the payload once (~ratio x
// the data) and writes the data once; at 3.35 TB/s a 256 MiB section at a
// 60% ratio needs ~0.13 ms.  The serial dependence of each stream (length ->
// shift -> next window) makes it latency-bound in practice: one thread per
// stream, so only n_tiles*1024 threads exist (65,536 for 256 MiB at
// k=4096).
//
// Design: one thread per stream, the grid is (tile, 1024/threads-per-block).
// The decode tables (lim_left <= 17 u32, bias <= 17 i32, symtab 256 B) live
// in shared memory.  The 128-bit register is two uint64_t.  A refill loads
// pair pptr straight from its own column of the payload (two coalesced
// 32-bit loads) instead of the TPU's banded one-hot window: the certified
// band guarantees every refill the TPU kernel could serve lies at pptr <
// w_cap/2, and pairs at or past it are read as zeros exactly as the TPU
// window clamp does.  Rows outside the payload (n_rows of them) read as
// zeros too: the host appends no slack rows and checks no row offsets, and a
// corrupt container still stays inside the buffer (the host checks the band
// before launching, ops/ils.py).

#include "ils_common.cuh"

#define DEC_THREADS 256

__global__ void __launch_bounds__(DEC_THREADS) ils_decode_kernel(
    const uint32_t* __restrict__ payload, const int* __restrict__ row_starts,
    const uint32_t* __restrict__ lim, const int* __restrict__ bias,
    const int* __restrict__ symtab, uint32_t* __restrict__ out, int k,
    int w_cap, int min_len, int max_len, int rot, long long n_rows) {
  __shared__ uint32_t s_lim[32];
  __shared__ int s_bias[32];
  __shared__ uint8_t s_sym[256];
  for (int j = threadIdx.x; j < 256; j += blockDim.x) {
    s_sym[j] = (uint8_t)symtab[j];
    if (j < 32) {
      s_lim[j] = lim[j];
      s_bias[j] = bias[j];
    }
  }
  __syncthreads();

  const int t = blockIdx.x;
  const int s = blockIdx.y * DEC_THREADS + threadIdx.x;
  const int nb = k >> 2;
  const int cap_pairs = w_cap >> 1;
  // 64-bit offsets: a 1 GiB section holds ~2.7e8 payload words
  const long long row0 = row_starts[t];
  const uint32_t* col = payload + s;
  uint32_t* out_t = out + (size_t)t * nb * ILS_LANES;
  // word of this stream in tile row r; zero outside the payload
  auto word = [&](long long r) -> uint64_t {
    r += row0;
    return (r >= 0 && r < n_rows) ? col[(size_t)r * ILS_LANES] : 0u;
  };

  uint64_t hi = (word(0) << 32) | word(1);
  uint64_t lo = (word(2) << 32) | word(3);
  int valid = 128;
  int pptr = 2;

  for (int i = 0; i < nb; ++i) {
    uint32_t pack = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t win = (uint32_t)(hi >> 32);
      // canonical length: min_len + #{l in [min_len, max_len) : win >= lim}
      int ln = min_len;
      for (int l = min_len; l < max_len; ++l) ln += (win >= s_lim[l]);
      // ln is in [1, 16], so every shift below is in range
      const int rank = s_bias[ln] + (int)(win >> (32 - ln));
      pack |= (uint32_t)s_sym[rank & 255] << (8 * j);
      hi = (hi << ln) | (lo >> (64 - ln));
      lo <<= ln;
      valid -= ln;
    }
    if (valid <= 64) {
      // valid is in [1, 64]: insert the pair at bit offset `valid`
      uint64_t pair = 0;
      if (pptr < cap_pairs) pair = (word(2 * pptr) << 32) | word(2 * pptr + 1);
      if (valid < 64) hi |= pair >> valid;  // pair >> 64 is undefined
      lo |= pair << (64 - valid);
      ++pptr;
      valid += 64;
    }
    out_t[(size_t)i * ILS_LANES + (rot ? ils_rot_src(s, i) : s)] = pack;
  }
}

extern "C" int ils_decode_launch(const void* payload, const void* row_starts,
                                 const void* lim, const void* bias,
                                 const void* symtab, void* out, int n_tiles,
                                 int k, int w_cap, int min_len, int max_len,
                                 int rot, long long n_rows, void* stream) {
  dim3 grid(n_tiles, ILS_LANES / DEC_THREADS);
  ils_decode_kernel<<<grid, DEC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)payload, (const int*)row_starts, (const uint32_t*)lim,
      (const int*)bias, (const int*)symtab, (uint32_t*)out, k, w_cap, min_len,
      max_len, rot, n_rows);
  return (int)cudaGetLastError();
}
