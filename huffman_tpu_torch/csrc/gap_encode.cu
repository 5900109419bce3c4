// HTC1 gap-array encode for Hopper: row pack (B4b), row metadata (B4c) and
// bit placement (B4d).  Replaces the kernels of
// huffman_tpu/ops/pallas/gap_encode_kernel.py (wrapper encode_blocks_pallas).
// Blocks are cut into rows of ROW_BYTES = 128 input bytes.  B4b and B4c
// take an optional byte count per HTC1 block (a block of any size is
// padded to whole rows): bytes at or past it are no symbols, so they add no
// bits and no codeword start; the block's last row may be partial and rows
// past the count give 0 bits.  (Padding alone cannot do it: every byte of
// a row is a start, and a table may hold all 256 symbols.)  Each kernel is
// instantiated twice and the launcher picks by whether counts are given:
// blocks without them compare no byte against a count, which costs B4b
// and B4c about 3% on full blocks (PERF.md).
//
// gap_row_pack_kernel replaces _row_pack_kernel (B4b), with the input
// relayout _relayout_kernel (B4a) and the encode use of
// compact_kernel.py:_assemble_kernel (B3) folded into its addressing.  A
// row is one thread: bytes little-endian within a word, codes from a
// shared-memory table of (len << 20) | code, packed MSB-first through a
// 64-bit accumulator into cap_words words (zero past the row's bits), with
// the row's bit count.  The TPU's static flush windows (_flush_bounds /
// _flush_window) bounded VMEM writes and do not survive.
//
// Its stores go through shared-memory tiles.  A block takes R consecutive
// rows (R threads; the wrapper picks R and the tile bytes), so each of its
// outputs is one contiguous range of device memory.  The block loads its R
// * 128 input bytes with coalesced 16-byte loads into a tile of pitch 33
// words, each thread packs its row from there into a pay tile of pitch
// cap_words + 1 words; after a barrier the block copies the whole pay range
// (16-byte stores; the range starts at row0 * cap_words words, row0 a
// multiple of 32) to device memory.  The odd pitches put the 32 threads of
// a warp, each on its own row, in 32 banks.  (Stored from each thread at
// its row's stride, every warp store of a word would touch 32 sectors, and
// its 16-byte loads would sit 128 bytes apart.)
//
// gap_row_meta_kernel replaces _row_meta_kernel (B4c) and the sorted
// segment_sum / segment_min after it.  It reads the input bytes, not
// per-symbol starts: 8 lanes take a row, each lane one 16-byte load (16
// symbols), their lengths from a shared-memory table, kept a byte each;
// an exclusive scan over the 8 lanes (__shfl_up_sync) gives each symbol's
// start in the row, plus s_local[r] its start bit in the HTC1 block.  The
// starts rise along a block's rows (s_local is the prefix sum of the row
// bits), so a segment's codewords are one run of consecutive symbols.
// The lane that holds a run's head (its first symbol) adds the run's
// length (the next head's position minus its own; the lanes above by a
// suffix minimum) to the segment's count and its start to the segment's
// first start: a few shared-memory atomics a row, not 128.  A lane whose
// 16 starts cross at most one segment boundary (every lane where seg_bits
// >= 16 * max_len) finds its head by counting the starts below the
// boundary, in 32 bits and without a branch a symbol; other lanes walk
// their starts.  A CUDA block takes `meta_tile`'s R consecutive rows (up
// to 512) of one HTC1 block and keeps the counts and firsts of the window
// of segments that R rows of max_len-bit codes can span in shared memory.
// After a barrier the segments strictly inside the tile's span, which no
// other tile touches, are stored plainly; the first and the last, which a
// neighbouring tile may share, go through global atomicAdd / atomicMin
// (integer operations: the result does not depend on their order).  A
// start outside the window (a max_len below the table's, or an s_local
// that is not a prefix sum) goes to the global atomics at once, and one
// outside [0, n_segs) is dropped, so every input stays inside the buffers.
//
// gap_place_bits_kernel replaces _place_bits_kernel (B4d): row r's words,
// masked to its bit count, shifted right by s & 31 and written at word
// s >> 5 of its block's output, s being the row's block-local start bit
// (64-bit).  8 lanes place a row, 4 rows a warp at a time, each group 4
// rows in turn, every row's bit count, start and first input quad loaded
// before the first is placed.  Lane j loads input quad j (16 bytes, only
// the row's ceil(bits / 32) words, the last masked to the bit count),
// takes quad j - 1 from the lane below (__shfl_up_sync; lane 0 from the
// step before) and makes output quad j, 4 words aligned to 16 bytes of the
// output, each a funnel shift of two input words: one 16-byte store where
// the quad lies inside the row.  The row's first and last output words,
// which the neighbouring rows share, are atomicOr'ed into the zeroed
// output, as the reference encoder writes its boundary words; the other
// words of a partial quad are stored one by one.
//
// Bounds on this card: bytes.  The pack reads the input once and writes
// cap_words words and the bit counts; the metadata reads the input again,
// s_local and writes two ints a segment; the placement reads the rows'
// bits and writes the payload.  With its stores tiled, the pack is held by
// its serial chain (a table lookup and the accumulator per symbol, 128
// symbols a thread) and by the occupancy its tiles allow (R * (33 +
// cap_words + 1) * 4 bytes a block: 41,984 at cap_words 48).  The metadata
// and the placement take about 3x their byte bounds (PERF.md): each does
// a few dozen instructions per 16 bytes (a table lookup, the scan and the
// head count per symbol; the shuffles and a quad's word selection).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define ROW_BYTES 128
#define ROW_WORDS 32
#define FULL_MASK 0xffffffffu

#define IN_PITCH (ROW_WORDS + 1)  // words of a row in the input tile
#define PACK_MAX_ROWS 256

// The bytes of row r that are symbols: its HTC1 block's count past the
// row's first byte, clamped to [0, 128] (the block's last row may be
// partial; rows past the count hold none).
__device__ __forceinline__ int row_valid(const int* n_bytes, long long r,
                                         int block_rows) {
  const long long g = r / block_rows;
  const long long rest =
      (long long)n_bytes[g] - (r - g * block_rows) * ROW_BYTES;
  return (int)min(max(rest, 0LL), (long long)ROW_BYTES);
}

// kCounts: the launch has byte counts (else every byte is a symbol, and
// the instantiation without them keeps the full rows' code unchanged)
template <bool kCounts>
__global__ void __launch_bounds__(PACK_MAX_ROWS) gap_row_pack_kernel(
    const uint32_t* __restrict__ data, const int* __restrict__ enc,
    const int* __restrict__ n_bytes, uint32_t* __restrict__ pay,
    int* __restrict__ row_bits, long long n_rows, int cap_words,
    int block_rows) {
  extern __shared__ uint4 smem[];
  __shared__ int s_enc[256];
  const int R = blockDim.x;
  const int tid = threadIdx.x;
  const int pay_pitch = cap_words + 1;
  uint32_t* s_in = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_pay = s_in + R * IN_PITCH;
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

  if (tid < nv) {
    const int valid =
        kCounts ? row_valid(n_bytes, row0 + tid, block_rows) : ROW_BYTES;
    const uint32_t* in = s_in + tid * IN_PITCH;
    uint32_t* out = s_pay + tid * pay_pitch;
    uint64_t acc = 0;  // top `nacc` bits pending, nacc < 32 between symbols
    int nacc = 0, tot = 0, nw = 0;
    for (int q = 0; q < ROW_WORDS; ++q) {
      const uint32_t w = in[q];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // a byte past the block's count adds no bits
        const int e = !kCounts || 4 * q + b < valid
                          ? s_enc[(w >> (8 * b)) & 255]
                          : 0;
        const int ln = e >> 20;
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

// ---------------------------------------------------------------------------
// B4c
// ---------------------------------------------------------------------------
#define META_THREADS 256
#define META_MAX_ROWS 512
#define META_LANES 8                 // lanes a row, 16 symbols each
#define META_SYMS (ROW_BYTES / META_LANES)
#define META_ROWS_STEP (META_THREADS / META_LANES)  // rows a block step
// the window's bytes, at most: with the static 1 KB length table, under
// the 48 KB a block gets without opting in
#define META_MAX_SMEM 47104

// One run of `n` starts in segment `seg` from bit `first`: into the tile's
// window, else straight to the block's metadata, else dropped.
__device__ __forceinline__ void meta_put(int* cnt_s, int* fst_s, int* cnt_g,
                                         int* fst_g, long long seg,
                                         long long base, int window,
                                         int n_segs, int n, int first) {
  const long long w = seg - base;
  if (w >= 0 && w < window) {
    atomicAdd(cnt_s + w, n);
    atomicMin(fst_s + w, first);
  } else if (seg >= 0 && seg < n_segs) {
    atomicAdd(cnt_g + seg, n);
    atomicMin(fst_g + seg, first);
  }
}

template <bool kCounts>
__global__ void __launch_bounds__(META_THREADS) gap_row_meta_kernel(
    const uint4* __restrict__ rows, const int* __restrict__ enc,
    const long long* __restrict__ s_local, const int* __restrict__ n_bytes,
    int* __restrict__ counts, int* __restrict__ firsts, int rows_per_block,
    int tile_rows, int tiles_per_g, int n_segs, int seg_shift, int window) {
  extern __shared__ int meta_smem[];
  __shared__ int s_len[256];
  __shared__ long long s_hi;  // segment of the tile's last start
  int* cnt_s = meta_smem;
  int* fst_s = meta_smem + window;
  const int tid = threadIdx.x;
  const int gl = tid & (META_LANES - 1);  // the lane's 16 bytes of its row
  const long long g = blockIdx.x / tiles_per_g;
  const int row_g0 = (int)(blockIdx.x - g * tiles_per_g) * tile_rows;
  int nv = min(tile_rows, rows_per_block - row_g0);
  const long long r0 = g * rows_per_block + row_g0;
  // with byte counts, the tile's rows that hold symbols (past the block's
  // count none) and the bytes of the last of them (it may be partial)
  int last_bytes = ROW_BYTES;
  if (kCounts) {
    const long long rest =
        (long long)n_bytes[g] - (long long)row_g0 * ROW_BYTES;
    nv = (int)min((long long)nv, rest <= 0 ? 0 : (rest - 1) / ROW_BYTES + 1);
    if (nv > 0)
      last_bytes = (int)min(rest - (long long)(nv - 1) * ROW_BYTES,
                            (long long)ROW_BYTES);
  }
  int* cnt_g = counts + g * n_segs;
  int* fst_g = firsts + g * n_segs;
  for (int j = tid; j < 256; j += META_THREADS) s_len[j] = enc[j] >> 20;
  for (int j = tid; j < window; j += META_THREADS) {
    cnt_s[j] = 0;
    fst_s[j] = INT_MAX;
  }
  // the tile's first start is its first row's
  const long long base = s_local[r0] >> seg_shift;
  // a tile without symbols keeps hi = base: no segment of its own
  if (kCounts && tid == 0) s_hi = base;
  __syncthreads();

  // every lane of a warp runs every step (the shuffles); a lane past the
  // tile's rows only counts nothing.  The next step's row is loaded ahead.
  int i = tid / META_LANES;
  uint4 v = make_uint4(0, 0, 0, 0);
  long long s = 0;
  if (i < nv) {
    v = rows[(r0 + i) * META_LANES + gl];
    s = s_local[r0 + i];
  }
  for (int i0 = tid / 32 * 4; i0 < nv; i0 += META_ROWS_STEP) {
    const bool ok = i < nv;
    const bool last_row = i == nv - 1;
    // the row's symbols end at row_end, the lane holds lim of them
    const int row_end = kCounts && last_row ? last_bytes : ROW_BYTES;
    const int lim =
        kCounts ? min(max(row_end - gl * META_SYMS, 0), META_SYMS) : META_SYMS;
    const uint4 cur = v;
    const long long s_cur = s;
    i += META_ROWS_STEP;
    if (i < nv) {
      v = rows[(r0 + i) * META_LANES + gl];
      s = s_local[r0 + i];
    }
    // the 16 lengths, a byte each (4 registers, not 16)
    const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
    uint32_t lp[4] = {0, 0, 0, 0};
    int sum = 0;
#pragma unroll
    for (int q = 0; q < META_SYMS; ++q) {
      const int l = s_len[(w[q >> 2] >> (8 * (q & 3))) & 255];
      lp[q >> 2] |= (uint32_t)l << (8 * (q & 3));
      sum += l;
    }
#define META_LEN(q) ((int)((lp[(q) >> 2] >> (8 * ((q) & 3))) & 255))
    int l_last = META_LEN(META_SYMS - 1);  // the lane's last symbol's length
    if (lim < META_SYMS) {
      // the block's last row: bytes past its count are no symbols (length
      // 0, so the starts before them stay; never a head)
      uint32_t m[4] = {0, 0, 0, 0};
      sum = 0;
#pragma unroll
      for (int q = 0; q < META_SYMS; ++q) {
        if (q < lim) {
          l_last = META_LEN(q);
          m[q >> 2] |= (uint32_t)l_last << (8 * (q & 3));
          sum += l_last;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) lp[j] = m[j];
    }
    // exclusive scan of the row's 8 lane sums: the lane's first start
    int incl = sum;
#pragma unroll
    for (int d = 1; d < META_LANES; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, d, META_LANES);
      if (gl >= d) incl += y;
    }
    const long long a0 = s_cur + incl - sum;
    const long long seg0 = a0 >> seg_shift;
    const long long seg_last = (a0 + sum - l_last) >> seg_shift;
    const long long prev = __shfl_up_sync(FULL_MASK, seg_last, 1, META_LANES);
    const bool head0 = gl == 0 || seg0 != prev;
    // at most one segment boundary inside the lane (always where seg_bits
    // >= 16 * max_len): its head qc and start ac in closed form, 32-bit
    const bool one = seg_last - seg0 <= 1;
    int qfirst = META_SYMS, qc = META_SYMS;
    long long ac = 0;
    if (one) {
      if (seg_last != seg0) {
        const int to_bound = (int)(((seg0 + 1) << seg_shift) - a0);
        int x = 0, c = 0, pre = 0;
#pragma unroll
        for (int q = 0; q < META_SYMS; ++q) {
          const bool lt = x < to_bound;
          c += lt;
          pre += lt ? META_LEN(q) : 0;
          x += META_LEN(q);
        }
        qc = c;
        ac = a0 + pre;
      }
      qfirst = head0 ? 0 : qc;
    } else if (head0) {
      qfirst = 0;
    } else {
      const long long bound = (seg0 + 1) << seg_shift;
      long long x = a0;
      qfirst = 0;
#pragma unroll
      for (int q = 0; q < META_SYMS; ++q) {
        qfirst += x < bound;
        x += META_LEN(q);
      }
    }
    // the first head of the lanes above: where this lane's last run ends
    // (a lane without symbols has none)
    int m =
        lim > 0 && qfirst < META_SYMS ? gl * META_SYMS + qfirst : row_end;
#pragma unroll
    for (int d = 1; d < META_LANES; d <<= 1) {
      const int y = __shfl_down_sync(FULL_MASK, m, d, META_LANES);
      if (gl + d < META_LANES) m = min(m, y);
    }
    int next = __shfl_down_sync(FULL_MASK, m, 1, META_LANES);
    if (gl == META_LANES - 1) next = row_end;
    if (!ok || lim == 0) continue;
    if (last_row && gl == (row_end - 1) / META_SYMS) s_hi = seg_last;
    const int p0 = gl * META_SYMS;
    if (one) {
      if (head0)
        meta_put(cnt_s, fst_s, cnt_g, fst_g, seg0, base, window, n_segs,
                 (qc < META_SYMS ? p0 + qc : next) - p0, (int)a0);
      if (qc < META_SYMS)
        meta_put(cnt_s, fst_s, cnt_g, fst_g, seg_last, base, window, n_segs,
                 next - p0 - qc, (int)ac);
      continue;
    }
    // several boundaries (seg_bits < 16 * max_len): a head at every change
    long long x = a0, seg_prev = prev, run_seg = 0;
    int run_p = -1, run_first = 0;
#pragma unroll
    for (int q = 0; q < META_SYMS; ++q) {
      const long long sg = x >> seg_shift;
      if (q < lim && (q == 0 ? head0 : sg != seg_prev)) {
        const int p = p0 + q;
        if (run_p >= 0)
          meta_put(cnt_s, fst_s, cnt_g, fst_g, run_seg, base, window, n_segs,
                   p - run_p, run_first);
        run_seg = sg;
        run_p = p;
        run_first = (int)x;
      }
      seg_prev = sg;
      x += META_LEN(q);
    }
    if (run_p >= 0)
      meta_put(cnt_s, fst_s, cnt_g, fst_g, run_seg, base, window, n_segs,
               next - run_p, run_first);
#undef META_LEN
  }
  __syncthreads();

  // segments strictly inside (base, hi) are this tile's alone: plain
  // stores; the rest of the window through the global atomics
  const long long hi = s_hi;
  for (int j = tid; j < window; j += META_THREADS) {
    const long long seg = base + j;
    if (seg < 0 || seg >= n_segs) continue;
    const int c = cnt_s[j];
    if (j > 0 && seg < hi) {
      cnt_g[seg] = c;
      fst_g[seg] = fst_s[j];
    } else if (c) {
      atomicAdd(cnt_g + seg, c);
      atomicMin(fst_g + seg, fst_s[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// B4d
// ---------------------------------------------------------------------------
#define PLACE_THREADS 256
#define PLACE_LANES 8  // lanes a row, an output quad (4 words) each a step
#define PLACE_ROUNDS 4  // rows an 8-lane group places, one after another
#define PLACE_ROWS (PLACE_THREADS / PLACE_LANES * PLACE_ROUNDS)  // a block

// w masked to its first `keep` bits (MSB-first; none for keep <= 0)
__device__ __forceinline__ uint32_t keep_bits(uint32_t w, int keep) {
  return keep <= 0 ? 0u : keep < 32 ? w & (~0u << (32 - keep)) : w;
}

__global__ void __launch_bounds__(PLACE_THREADS) gap_place_bits_kernel(
    const uint32_t* __restrict__ pay, const int* __restrict__ row_bits,
    const long long* __restrict__ s_local, uint32_t* __restrict__ out,
    long long n_rows, int rows_per_block, int cap_words,
    long long out_words) {
  const int gl = threadIdx.x & (PLACE_LANES - 1);
  const bool wide = (cap_words & 3) == 0;  // rows of whole 16-byte quads
  // the group's rows, the block's groups side by side in each round
  auto row_of = [&](int it) {
    return (long long)blockIdx.x * PLACE_ROWS +
           it * (PLACE_THREADS / PLACE_LANES) + threadIdx.x / PLACE_LANES;
  };
  // all rounds' bit counts, starts and first input quads loaded first
  int bits_[PLACE_ROUNDS];
  long long s_[PLACE_ROUNDS];
  uint4 q0_[PLACE_ROUNDS];
#pragma unroll
  for (int it = 0; it < PLACE_ROUNDS; ++it) {
    const long long r = row_of(it);
    bits_[it] = 0;
    s_[it] = 0;
    if (r < n_rows) {
      bits_[it] = min(max(row_bits[r], 0), 32 * cap_words);
      s_[it] = s_local[r];
    }
  }
#pragma unroll
  for (int it = 0; it < PLACE_ROUNDS; ++it) {
    q0_[it] = make_uint4(0, 0, 0, 0);
    if (wide && 4 * gl < ((bits_[it] + 31) >> 5))
      q0_[it] = *reinterpret_cast<const uint4*>(pay + row_of(it) * cap_words +
                                                4 * gl);
  }
#pragma unroll
  for (int it = 0; it < PLACE_ROUNDS; ++it) {
    const long long r = row_of(it);
    const int bits = bits_[it];
    const long long s = s_[it];
    // 32-bit division: the launcher bounds n_rows by 2^32
    const long long g = (unsigned)r / (unsigned)rows_per_block;
    uint32_t* o = out + g * out_words;
    // output quads aligned to 16 bytes of `out`: o's phase in its quad
    const int phase = (int)((g * out_words) & 3);
    const long long w0 = s >> 5;
    const int sh = (int)(s & 31);
    const int nw = (bits + 31) >> 5;
    const int last = bits ? (sh + bits - 1) >> 5 : -1;  // from w0
    const int a = (int)((w0 + phase) & 3);  // w0's place in its quad
    const int n_quads = bits ? ((a + last) >> 2) + 1 : 0;
    const int steps =
        __reduce_max_sync(FULL_MASK, n_quads + PLACE_LANES - 1) / PLACE_LANES;
    const uint32_t* p = pay + r * cap_words;
    uint32_t below[4] = {0, 0, 0, 0};  // input quad 8 st - 1, from lane 7
    for (int st = 0; st < steps; ++st) {
      // lane gl loads input quad j (words 4j..4j+3, masked to the bits)
      // and makes output quad j, from its words 4j - a - 1 .. 4j - a + 3
      const int j = PLACE_LANES * st + gl;
      const int k = 4 * j;
      uint32_t c[4] = {0, 0, 0, 0};
      if (k < nw) {
        if (wide) {
          const uint4 q = st == 0 ? q0_[it]
                                  : *reinterpret_cast<const uint4*>(p + k);
          c[0] = q.x;
          c[1] = q.y;
          c[2] = q.z;
          c[3] = q.w;
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) c[t] = k + t < nw ? p[k + t] : 0u;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) c[t] = keep_bits(c[t], bits - 32 * (k + t));
      }
      uint32_t pq[4];  // input quad j - 1
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        pq[t] = __shfl_up_sync(FULL_MASK, c[t], 1, PLACE_LANES);
        const uint32_t top =
            __shfl_sync(FULL_MASK, c[t], PLACE_LANES - 1, PLACE_LANES);
        if (gl == 0) pq[t] = below[t];
        below[t] = top;
      }
      if (j >= n_quads) continue;
      // x[i] = input word 4j - a - 1 + i: [pq0..pq3, c0..c3] from 3 - a
      uint32_t x[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const uint32_t x0 = i < 1 ? pq[3] : c[i - 1 < 0 ? 0 : i - 1];
        const uint32_t x1 = i < 2 ? pq[i + 2 > 3 ? 3 : i + 2]
                                  : c[i - 2 < 0 ? 0 : i - 2];
        const uint32_t x2 = i < 3 ? pq[i + 1 > 3 ? 3 : i + 1]
                                  : c[i - 3 < 0 ? 0 : i - 3];
        const uint32_t x3 = i < 4 ? pq[i > 3 ? 3 : i] : c[0];
        x[i] = a == 0 ? x0 : a == 1 ? x1 : a == 2 ? x2 : x3;
      }
      uint32_t v[4];  // (cur >> sh) | (prev << (32 - sh))
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = __funnelshift_r(x[t + 1], x[t], sh);
      const int kq = k - a;      // the row's output word of the quad's first
      const long long e = w0 + kq;  // its word in o
      if (kq >= 1 && kq + 3 <= last - 1 && e >= 0 && e + 3 < out_words) {
        *reinterpret_cast<uint4*>(o + e) = make_uint4(v[0], v[1], v[2], v[3]);
        continue;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int kk = kq + t;
        if (kk < 0 || kk > last || e + t < 0 || e + t >= out_words) continue;
        if (kk == 0 || kk == last)
          atomicOr(o + e + t, v[t]);
        else
          o[e + t] = v[t];
      }
    }
  }
}

// The tile bytes a block of `rows` rows needs (the wrapper's
// `row_pack_tile` computes the same).
static long long row_pack_smem(int rows, int cap_words) {
  return 4LL * rows * (IN_PITCH + cap_words + 1);
}

// n_bytes: null (every row whole) or one int per HTC1 block of block_rows
// rows
extern "C" int gap_row_pack_launch(const void* data, const void* enc,
                                   const void* n_bytes, void* pay,
                                   void* row_bits, long long n_rows,
                                   int cap_words, int block_rows,
                                   int rows_per_block, int smem_bytes,
                                   void* stream) {
  if (rows_per_block < 32 || rows_per_block > PACK_MAX_ROWS ||
      rows_per_block % 32 || cap_words < 0 ||
      smem_bytes != row_pack_smem(rows_per_block, cap_words) ||
      (n_bytes && (block_rows < 1 || n_rows % block_rows)))
    return (int)cudaErrorInvalidValue;
  // above 48 KB only after this; a refusal is returned, and cleared so
  // that it does not surface at a later launch's check
  const auto kernel =
      n_bytes ? gap_row_pack_kernel<true> : gap_row_pack_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  kernel<<<(unsigned)blocks, rows_per_block, smem_bytes,
           (cudaStream_t)stream>>>(
      (const uint32_t*)data, (const int*)enc, (const int*)n_bytes,
      (uint32_t*)pay, (int*)row_bits, n_rows, cap_words, block_rows);
  return (int)cudaGetLastError();
}

// The window of segments R rows of max_len-bit codes can span (the
// wrapper's `meta_tile` computes the same).
static long long meta_window(int rows, int max_len, int seg_shift) {
  const long long span = (long long)rows * ROW_BYTES * max_len;
  return ((span + (1LL << seg_shift) - 1) >> seg_shift) + 1;
}

// n_bytes: null (every row whole) or one int per HTC1 block
extern "C" int gap_row_meta_launch(const void* rows, const void* enc,
                                   const void* s_local, const void* n_bytes,
                                   void* counts,
                                   void* firsts, long long n_rows,
                                   int rows_per_block, int n_segs,
                                   int seg_shift, int max_len, int tile_rows,
                                   int window, int smem_bytes, void* stream) {
  if (tile_rows < 1 || tile_rows > META_MAX_ROWS ||
      (tile_rows & (tile_rows - 1)) || max_len < 1 || max_len > 16 ||
      seg_shift < 0 || seg_shift > 30 || rows_per_block < 1 ||
      n_rows % rows_per_block ||
      window != meta_window(tile_rows, max_len, seg_shift) ||
      smem_bytes != 8LL * window || smem_bytes > META_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_g = (rows_per_block + tile_rows - 1) / tile_rows;
  const long long blocks = n_rows / rows_per_block * tiles_per_g;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const auto kernel =
      n_bytes ? gap_row_meta_kernel<true> : gap_row_meta_kernel<false>;
  kernel<<<(unsigned)blocks, META_THREADS, smem_bytes,
           (cudaStream_t)stream>>>(
      (const uint4*)rows, (const int*)enc, (const long long*)s_local,
      (const int*)n_bytes, (int*)counts, (int*)firsts, rows_per_block,
      tile_rows, tiles_per_g,
      n_segs, seg_shift, window);
  return (int)cudaGetLastError();
}

extern "C" int gap_place_bits_launch(const void* pay, const void* row_bits,
                                     const void* s_local, void* out,
                                     long long n_rows, int rows_per_block,
                                     int cap_words, long long out_words,
                                     void* stream) {
  // the 32-bit block index of a row
  if (rows_per_block < 1 || n_rows % rows_per_block || cap_words < 0 ||
      n_rows > 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + PLACE_ROWS - 1) / PLACE_ROWS;
  gap_place_bits_kernel<<<(unsigned)blocks, PLACE_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)pay, (const int*)row_bits, (const long long*)s_local,
      (uint32_t*)out, n_rows, rows_per_block, cap_words, out_words);
  return (int)cudaGetLastError();
}
