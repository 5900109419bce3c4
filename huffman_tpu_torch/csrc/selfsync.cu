// Self-synchronising decode for Hopper: the transition of every
// subsequence of a raw canonical stream from each of its 16 entry states
// (kernel C2).
//
// sync_transitions_kernel replaces huffman_tpu/ops/pallas/
// selfsync_kernels.py:_transition_kernel (wrapper sync_transitions).  A
// codeword crosses a subsequence edge by fewer than max_len <= 16 bits, so
// a subsequence is a function of its entry offset e in [0, 16).  For each
// (subsequence i, entry e) a thread starts at bit i*seg_bits + e, walks
// the canonical compare chain (lengths only, `walk_count` of bitwalk.cuh,
// as C1 does) and counts the codewords that
// start below end = clip(total_bits - i*seg_bits, 0, seg_bits); the exit
// is clip(pos - seg_bits, 0, 15).  Codewords that straddle into the next
// subsequence read its words directly; words past the stream read as
// zeros.  Output (16, n_subseq) int32 (exit << 16) | count, the JAX
// layout.
//
// Thread layout: a block holds 16 subsequences x 16 entries, the 16
// entries of one subsequence in neighbouring lanes, so a half-warp's word
// loads hit the same one or two lines (coalesced loads).  The results are
// transposed through shared memory so that each row e is stored as 16
// consecutive ints (coalesced stores too).  The TPU kernel's lane layout
// of segment words and its one-hot row refill serve the vector unit; a
// thread here loads its own words.
//
// Bounds on this card.  The kernel reads the payload (once from memory,
// 16 times from L1/L2) and writes 64 bytes per subsequence.  The function
// needs little more than one walk of the stream, since the 16 walks of a
// subsequence merge after a few codewords, so its bound is those bytes;
// this kernel walks every entry to the end, 16 serial compare chains per
// codeword.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitwalk.cuh"

#define SYNC_STATES 16
#define SUBSEQ_PER_BLOCK 16
#define SYNC_THREADS (SYNC_STATES * SUBSEQ_PER_BLOCK)

__global__ void __launch_bounds__(SYNC_THREADS) sync_transitions_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ lim,
    int* __restrict__ out, long long n_subseq, long long n_words,
    long long total_bits, int seg_bits, int min_len, int max_len) {
  __shared__ uint32_t s_lim[32];
  __shared__ int s_out[SYNC_STATES][SUBSEQ_PER_BLOCK];
  if (threadIdx.x < 32) s_lim[threadIdx.x] = lim[threadIdx.x];
  __syncthreads();

  const int e = threadIdx.x & (SYNC_STATES - 1);
  const int j = threadIdx.x / SYNC_STATES;
  const long long i = (long long)blockIdx.x * SUBSEQ_PER_BLOCK + j;
  int result = 0;
  if (i < n_subseq) {
    const long long base = i * seg_bits;
    const long long end = base + max(0LL, min(total_bits - base,
                                              (long long)seg_bits));
    long long pos = base + e;
    // the walk ends at `end`, at most seg_bits codewords in: the cap never
    // binds
    const int count = walk_count(words, n_words, pos, end, seg_bits, s_lim,
                                 min_len, max_len);
    const int exit_state =
        (int)min(max(pos - base - seg_bits, 0LL), (long long)SYNC_STATES - 1);
    result = (exit_state << 16) | count;
  }
  s_out[e][j] = result;
  __syncthreads();
  // thread t stores entry row t / 16, subsequence t % 16 of this block
  const int row = threadIdx.x / SUBSEQ_PER_BLOCK;
  const int col = threadIdx.x & (SUBSEQ_PER_BLOCK - 1);
  const long long i_out = (long long)blockIdx.x * SUBSEQ_PER_BLOCK + col;
  if (i_out < n_subseq) out[row * n_subseq + i_out] = s_out[row][col];
}

extern "C" int sync_transitions_launch(const void* words, const void* lim,
                                       void* out, long long n_subseq,
                                       long long n_words, long long total_bits,
                                       int seg_bits, int min_len, int max_len,
                                       void* stream) {
  const long long blocks = (n_subseq + SUBSEQ_PER_BLOCK - 1) / SUBSEQ_PER_BLOCK;
  sync_transitions_kernel<<<(unsigned)blocks, SYNC_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint32_t*)lim, (int*)out, n_subseq,
      n_words, total_bits, seg_bits, min_len, max_len);
  return (int)cudaGetLastError();
}
