// Self-synchronising decode for Hopper: the transition of every
// subsequence of a raw canonical stream from each of its 16 entry states
// (kernel C2).
//
// sync_transitions_kernel replaces huffman_tpu/ops/pallas/
// selfsync_kernels.py:_transition_kernel (wrapper sync_transitions).  A
// codeword crosses a subsequence edge by fewer than max_len <= 16 bits, so
// a subsequence is a function of its entry offset e in [0, 16).  For each
// (subsequence i, entry e) the function walks the canonical compare chain
// from bit i*seg_bits + e and counts the codewords that start below
// end = clip(total_bits - i*seg_bits, 0, seg_bits); the exit is
// clip(pos - seg_bits, 0, 15).  Codewords that straddle into the next
// subsequence read its words; words past the stream read as zeros.
// Output (16, n_subseq) int32 (exit << 16) | count, the JAX layout.
//
// Bounds on this card.  The kernel reads the payload once and writes 64
// bytes per subsequence.  The 16 walks of a subsequence merge, so the
// function needs little more than one walk of the stream; its bound is
// those bytes.
//
// Design: one thread per subsequence, consecutive threads on consecutive
// subsequences, so each output row e is stored by consecutive lanes.
//  - Merges.  Walks that reach one start go on together, so entry e stops
//    at the first start that an earlier entry's walk has reached: its
//    count is then steps + count_r - (walk r's starts below that point),
//    and its exit walk r's.  Walk 0 marks its starts in a bitmap of the
//    subsequence's first SYNC_MAP_WORDS words; entries 1..15 mark theirs
//    in an owner map (4 bits an offset) of the first SYNC_OWN_BITS bits,
//    where walks meet each other (on the main input's code an entry meets
//    walk 0 at a median 110 bits and another entry much sooner:
//    tools/selfsync_merge_stats.py).  An entry that meets no marked start
//    walks to the end.  The bitmap's width trades merges found late
//    against blocks an SM: 16 words measured faster than 32 or 8.
//  - Walk 0 first, then one loop for entries 1..15: a lane goes on to its
//    next entry as soon as its current one stops, so a warp waits for its
//    slowest lane once, not once per entry.  A stop stores (walk met,
//    offset, steps); the counts are resolved after the loop.
//  - One code length (min_len == max_len) makes every walk arithmetic:
//    count = ceil((end - e) / len), no walk at all.
//  - The length: one shared load from a table on the top SYNC_LEN_BITS
//    bits of the window, which each block builds (`LenTable`); where a
//    prefix does not decide the length, the compare chain against the
//    limits held in registers (`CanonRegs`, bitwalk.cuh).
//  - The stream: each thread reads its subsequence's words through L1.
//    Staging the block's words in shared memory by coalesced 16-byte loads
//    measured slower (fewer blocks an SM).
// The wrapper (ops/selfsync_kernels.py:sync_tile) computes the shared
// memory a block takes; the launcher checks it against the same formula.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitwalk.cuh"

#define SYNC_STATES 16
#define SYNC_ROWS 128      // subsequences (threads) a block
#define SYNC_MAP_WORDS 16  // walk 0's bitmap: a subsequence's first 512 bits
#define SYNC_OWN_BITS 64   // owner map of entries 1..15: the first 64 bits
#define SYNC_OWN_WORDS (SYNC_OWN_BITS / 8)
#define SYNC_LEN_BITS 10   // window bits of the length table

// A bit window over one subsequence's words (word j is
// words[first + j], zero past the stream).  Every entry starts in the
// first 16 bits, so the first two words stay in registers and a start
// loads nothing; each refill's word is loaded one refill ahead.
struct SubWindow {
  const uint32_t* words;
  long long first;
  long long n_words;
  uint64_t head;  // the subsequence's first two words
  uint64_t buf;
  uint32_t ahead;  // word `next`, in flight
  int next;
  int nbits;

  __device__ __forceinline__ uint32_t word(int j) const {
    const long long g = first + j;
    return g < n_words ? __ldg(words + g) : 0u;
  }
  __device__ __forceinline__ void load_head() {
    head = ((uint64_t)word(0) << 32) | word(1);
  }
  // the window at bit offset e < 32
  __device__ __forceinline__ void start(int e) {
    buf = head << e;
    nbits = 64 - e;
    next = 2;
    ahead = word(2);
  }
  __device__ __forceinline__ uint32_t peek() const {
    return (uint32_t)(buf >> 32);
  }
  __device__ __forceinline__ void skip(int ln) {
    buf <<= ln;
    nbits -= ln;
    if (nbits <= 32) {
      buf |= (uint64_t)ahead << (32 - nbits);
      nbits += 32;
      ahead = word(++next);
    }
  }
};

// The codeword length of a window: entry x of `tab` is the compare chain's
// length on every window with top bits x, or 0 where the prefix does not
// decide it.  The chain counts the limits a window reaches, so it never
// falls as the window grows: equal lengths on the lowest and the highest
// window of a prefix decide the prefix.
struct LenTable {
  const uint8_t* tab;
  CanonRegs cr;

  __device__ __forceinline__ void build(uint8_t* s_tab) const {
    const uint32_t span = 0xFFFFFFFFu >> SYNC_LEN_BITS;
    for (int x = threadIdx.x; x < (1 << SYNC_LEN_BITS); x += blockDim.x) {
      const uint32_t lo = (uint32_t)x << (32 - SYNC_LEN_BITS);
      const int ln = cr.len(lo);
      s_tab[x] = (uint8_t)(cr.len(lo | span) == ln ? ln : 0);
    }
  }
  __device__ __forceinline__ int len(uint32_t win) const {
    const int ln = tab[win >> (32 - SYNC_LEN_BITS)];
    return ln ? ln : cr.len(win);
  }
};

// A thread's marks in shared memory, word w at [w * SYNC_ROWS].
struct Marks {
  uint32_t* map;  // walk 0's starts: bit b of word w is offset 32 w + b
  uint32_t* own;  // owner (1..15, 0 none) of offset q: nibble q & 7 of
                  // word q >> 3

  // walk 0's starts below offset q
  __device__ __forceinline__ int walk0_below(int q) const {
    int n = __popc(map[(q >> 5) * SYNC_ROWS] & ((1u << (q & 31)) - 1u));
    for (int w = 0; w < (q >> 5); ++w) n += __popc(map[w * SYNC_ROWS]);
    return n;
  }
  // entry r's starts below offset q < SYNC_OWN_BITS: the nibbles below q
  // that hold r
  __device__ __forceinline__ int own_below(int r, int q) const {
    int n = 0;
    for (int w = 0; w <= (q >> 3); ++w) {
      // x has a zero nibble where the owner is r; bit 0 of each nibble of
      // y is set where it is not, and for the nibbles at or past q
      const uint32_t x = own[w * SYNC_ROWS] ^ (0x11111111u * r);
      uint32_t y = x | (x >> 1);
      y = (y | (y >> 2)) & 0x11111111u;
      const int below = w < (q >> 3) ? 8 : (q & 7);
      if (below < 8) y |= 0x11111111u << (4 * below);
      n += 8 - __popc(y);
    }
    return n;
  }
};

// A stopped entry that met walk r at offset q after `steps` codewords:
// (1 << 31) | r << 26 | q << 16 | steps.  One that met none stores its
// result (exit << 16) | count, which is not negative.
__device__ __forceinline__ int merge_record(int r, int q, int steps) {
  return (int)(0x80000000u | ((uint32_t)r << 26) | ((uint32_t)q << 16) |
               (uint32_t)steps);
}

__device__ __forceinline__ void walk_entries(SubWindow bw,
                                             const LenTable& lens, Marks mk,
                                             int* rec, int q_end, int seg_bits,
                                             int map_words) {
  const int map_bits = map_words * 32;
  for (int w = 0; w < map_words; ++w) mk.map[w * SYNC_ROWS] = 0;
  for (int w = 0; w < SYNC_OWN_WORDS; ++w) mk.own[w * SYNC_ROWS] = 0;
  // walk 0, marking its starts below map_bits; a walk ends at q_end, at
  // most seg_bits codewords in
  int q = 0, steps = 0;
  int cw = 0;  // the bitmap word being built, in `cur`
  uint32_t cur = 0;
  bw.load_head();
  bw.start(0);
  for (; q < q_end; ++steps) {
    if ((q >> 5) != cw) {  // a codeword is shorter than a word
      if (cw < map_words) mk.map[cw * SYNC_ROWS] = cur;
      cw = q >> 5;
      cur = 0;
    }
    cur |= 1u << (q & 31);
    const int ln = lens.len(bw.peek());
    q += ln;
    bw.skip(ln);
  }
  if (cw < map_words) mk.map[cw * SYNC_ROWS] = cur;
  rec[0] = (min(max(q - seg_bits, 0), SYNC_STATES - 1) << 16) | steps;
  // entries 1..15 in one loop
  int e = 1;
  q = 1;
  steps = 0;
  bw.start(1);
  for (;;) {
    // the walk that reached offset q before entry e: 0, or r in 1..e-1
    int met = -1;
    if (q < q_end) {
      if (q < map_bits && ((mk.map[(q >> 5) * SYNC_ROWS] >> (q & 31)) & 1u)) {
        met = 0;
      } else if (q < SYNC_OWN_BITS) {
        const int r = (mk.own[(q >> 3) * SYNC_ROWS] >> (4 * (q & 7))) & 15;
        if (r) met = r;
      }
    }
    if (met >= 0 || q >= q_end) {
      rec[e * SYNC_ROWS] =
          met >= 0 ? merge_record(met, q, steps)
                   : (min(max(q - seg_bits, 0), SYNC_STATES - 1) << 16) | steps;
      if (++e == SYNC_STATES) break;
      q = e;
      steps = 0;
      bw.start(q);
      continue;
    }
    if (q < SYNC_OWN_BITS)
      mk.own[(q >> 3) * SYNC_ROWS] |= (uint32_t)e << (4 * (q & 7));
    const int ln = lens.len(bw.peek());
    q += ln;
    bw.skip(ln);
    ++steps;
  }
}

__global__ void __launch_bounds__(SYNC_ROWS) sync_transitions_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ lim,
    int* __restrict__ out, long long n_subseq, long long n_words,
    long long total_bits, int seg_bits, int min_len, int max_len,
    int map_words) {
  extern __shared__ uint32_t smem[];
  __shared__ uint8_t s_len[1 << SYNC_LEN_BITS];
  uint32_t* s_map = smem;                                   // [map_words][R]
  uint32_t* s_own = s_map + map_words * SYNC_ROWS;          // [8][R]
  int* s_rec = (int*)(s_own + SYNC_OWN_WORDS * SYNC_ROWS);  // [16][R]

  // one code length needs no table (nor a walk); else every thread builds
  // its share and reaches the barrier, those past the last subsequence
  // included
  const LenTable lens{s_len, CanonRegs(lim, min_len, max_len)};
  if (min_len != max_len) {
    lens.build(s_len);
    __syncthreads();
  }

  const long long i = (long long)blockIdx.x * SYNC_ROWS + threadIdx.x;
  if (i >= n_subseq) return;
  const long long base = i * seg_bits;
  const int q_end = (int)max(0LL, min(total_bits - base, (long long)seg_bits));
  if (min_len == max_len) {
    // every codeword is max_len bits long: the walks are arithmetic
    for (int e = 0; e < SYNC_STATES; ++e) {
      const int count = e < q_end ? (q_end - e + max_len - 1) / max_len : 0;
      const int q = e + count * max_len;
      out[e * n_subseq + i] =
          (min(max(q - seg_bits, 0), SYNC_STATES - 1) << 16) | count;
    }
    return;
  }
  const Marks mk{s_map + threadIdx.x, s_own + threadIdx.x};
  int* rec = s_rec + threadIdx.x;
  SubWindow bw;
  bw.words = words;
  bw.first = i * (seg_bits >> 5);
  bw.n_words = n_words;
  walk_entries(bw, lens, mk, rec, q_end, seg_bits, map_words);
  // resolve the merges in entry order: the walk an entry met is an
  // earlier entry's, resolved already
  for (int e = 0; e < SYNC_STATES; ++e) {
    int r = rec[e * SYNC_ROWS];
    if (r < 0) {
      const int met = (r >> 26) & 15, q = (r >> 16) & 1023;
      const int t = rec[met * SYNC_ROWS];
      const int below = met ? mk.own_below(met, q) : mk.walk0_below(q);
      r = (t & ~0xFFFF) | ((r & 0xFFFF) + (t & 0xFFFF) - below);
      rec[e * SYNC_ROWS] = r;
    }
    out[e * n_subseq + i] = r;
  }
}

extern "C" int sync_transitions_launch(const void* words, const void* lim,
                                       void* out, long long n_subseq,
                                       long long n_words, long long total_bits,
                                       int seg_bits, int min_len, int max_len,
                                       int rows_per_block, int map_words,
                                       int smem_bytes, void* stream) {
  // the wrapper's `sync_tile` computes the same geometry
  if (seg_bits <= 0 || seg_bits % 32 || seg_bits >= 65536 ||
      rows_per_block != SYNC_ROWS ||
      map_words != min(seg_bits / 32, SYNC_MAP_WORDS) ||
      smem_bytes !=
          (map_words + SYNC_OWN_WORDS + SYNC_STATES) * SYNC_ROWS * 4)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_subseq + SYNC_ROWS - 1) / SYNC_ROWS;
  sync_transitions_kernel<<<(unsigned)blocks, SYNC_ROWS, smem_bytes,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint32_t*)lim, (int*)out, n_subseq,
      n_words, total_bits, seg_bits, min_len, max_len, map_words);
  return (int)cudaGetLastError();
}
