// HTC1 encode map for Hopper: each aligned group of 4 input bytes to its
// codewords, packed left-justified into 64 bits (kernel B5).
//
// encode_map_kernel replaces huffman_tpu/ops/pallas/encode_kernel.py:
// _map_kernel (wrapper encode_map_pallas).  The TPU kernel swaps the
// per-byte table gathers for lane-table lookups and runs the group pack on
// (8, 128) word rows in 1 MiB grid chunks; here the 256-entry table of
// (len << 20) | code sits in shared memory and one thread packs one group.
//
// A thread loads its 4 bytes as one little-endian word, so byte 0 (the
// first codeword) is the lowest byte, and accumulates
//   acc = (acc << len) | code, tl += len, meta = (meta << 5) | len
// in 64 bits, then left-justifies: acc << (64 - tl).  tl == 0 only when no
// byte of the group is in the table (invalid input); a 64-bit shift by 64
// is undefined, and the TPU kernel's guarded shifts give acc << 32 there
// (0 for a table whose absent symbols have code 0), which is taken.
// Outputs, four (n_groups,) int32 arrays: hi and lo words of the packed
// group, lens4 = tl and lens_p = meta (byte 0's length in bits 15..19).
//
// Bounds on this card: one 4-byte load and four 4-byte stores per group,
// all coalesced, a few integer operations per byte; the bytes bound it
// (each input byte read once, 4 output bytes written per input byte).

#include <cstdint>
#include <cuda_runtime.h>

#define MAP_THREADS 256

__global__ void __launch_bounds__(MAP_THREADS) encode_map_kernel(
    const uint32_t* __restrict__ data, const int* __restrict__ enc,
    int* __restrict__ hi, int* __restrict__ lo, int* __restrict__ lens4,
    int* __restrict__ lens_p, long long n_groups) {
  __shared__ int s_enc[256];
  for (int i = threadIdx.x; i < 256; i += MAP_THREADS) s_enc[i] = enc[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * MAP_THREADS;
  for (long long g = (long long)blockIdx.x * MAP_THREADS + threadIdx.x;
       g < n_groups; g += stride) {
    const uint32_t w = data[g];
    uint64_t acc = 0;
    int tl = 0;
    int meta = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int e = s_enc[(w >> (8 * b)) & 255];
      const int ln = e >> 20;
      acc = (acc << ln) | (uint64_t)(e & 0xFFFFF);
      tl += ln;
      meta = (meta << 5) | ln;
    }
    const uint64_t lj = tl ? acc << (64 - tl) : acc << 32;
    hi[g] = (int)(uint32_t)(lj >> 32);
    lo[g] = (int)(uint32_t)lj;
    lens4[g] = tl;
    lens_p[g] = meta & 0xFFFFF;
  }
}

extern "C" int encode_map_launch(const void* data, const void* enc, void* hi,
                                 void* lo, void* lens4, void* lens_p,
                                 long long n_groups, void* stream) {
  if (n_groups <= 0) return 0;
  long long blocks = (n_groups + MAP_THREADS - 1) / MAP_THREADS;
  // a grid-stride loop covers the rest
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  encode_map_kernel<<<(unsigned)blocks, MAP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)data, (const int*)enc, (int*)hi, (int*)lo, (int*)lens4,
      (int*)lens_p, n_groups);
  return (int)cudaGetLastError();
}
