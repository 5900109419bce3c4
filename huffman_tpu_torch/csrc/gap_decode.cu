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
// The payload comes in through shared memory.  A block takes R consecutive
// segments (flat index t, R threads), and each warp first stages the words
// of its 32 segments into rows of a tile: row r holds the words [base, base
// + P) of its segment's payload block, base the word of the segment's first
// bit and P the pitch (`stage_words(seg_bits)` rounded up to odd), every
// word that a valid segment's walk reads, the window's lookahead included.
// The copies are cp.async of 4 bytes, consecutive lanes on consecutive
// words: a warp's 32 rows lie one after another in the payload (but for the
// P - seg_bits/32 words each shares with the next), so a warp copy fills
// whole sectors; words past the payload block are zeros.  The walk then
// refills from its row (StagedWindow), and the odd pitch puts the threads
// of a warp, each at the same offset of its own row, on 32 banks.  A word
// outside the row, which only a corrupt gap or count reaches, is read from
// device memory, zero outside [0, n_words), so every output equals the plain
// version's for any input.  Read from device memory on the chain, the 32
// lanes of a warp each on their own 128-byte segment, 2048 threads an SM
// outgrew L1 (on an H100 at the HTC1 cell's shape, 64 blocks of 16 MiB at
// seg_bits 1024: 7.03 ms; held to 1408 threads by registers, 3.58);
// staged, the reads are coalesced at any occupancy (3.05).  The rows cost
// shared memory, so fewer threads fit an SM, and below 1024 (8 warps a
// scheduler) the walk's latency shows (there, 4 blocks of 128 an SM took
// 1.4x the time of 8; 9 to 18 no less than 8): where the tile would leave
// fewer (seg_bits above 1024), nothing is staged and every word is read
// from device memory.  (Copying each word once instead, a run of a payload
// block's words into one skewed region, took 5% longer there: the skew's
// arithmetic sits on every refill.)
//
// The ranks go out through a second shared-memory tile.  The block's R
// rows of the matrix are one contiguous range.  A row can hold ~8,200
// ranks (seg_bits=8192, 1-bit codes), so the block walks the columns in
// chunks of C (a multiple of 8, at most 64; the wrapper picks R, C and P):
// each thread decodes up to C codewords into its row of a tile [R][C + 4]
// bytes, zeros past its count, then after a barrier the block stores the
// tile, consecutive lanes on consecutive 4-byte words (bytes where
// max_count % 4 != 0) of each row's chunk, so a warp store fills whole
// sectors.  The pitch (C + 4) / 4 words is odd, so the threads of a warp,
// each on its own row, write 32 banks.  The bit window stays in registers
// across chunks.  (Stored from each thread at its row's stride, every warp
// store of a rank would touch 32 sectors.)
//
// gap_place_bytes_kernel replaces compact_kernel.py:_kernel (wrapper
// ragged_concat_pallas): out[off[s] + i] = symtab[rank[s, i]] for
// i < count[s], with off the exclusive prefix sum of the counts.  The
// extents are disjoint, so there are no atomics, and no band plan
// (plan_compact / plan_tiles) is needed.  A block takes a run of R
// consecutive segments (the wrapper's `place_tile` picks R from
// max_count, the launcher checks it): their rows are one contiguous range
// of the rank matrix, and where the offsets are the exclusive prefix sum
// their output is one contiguous range from off[s0].  The block scans the
// clamped counts, loads the range with 16-byte loads (bytes at its ragged
// ends), maps each byte it needs through symtab and writes it, compacted,
// into a shared-memory buffer at the output's phase mod 16, then stores
// the buffer with 16-byte stores at 16-byte-aligned addresses (bytes at
// the ragged head and tail, which neighbouring blocks share).  Rows wider
// than the tile go one at a time in column chunks (R = 1).  A run whose
// offsets do not follow each other (a count above max_count, corrupt
// metadata) is placed a thread per segment, byte by byte; every byte
// store stays inside [0, n_out).  The shared memory holds the compacted
// bytes only: staging the loaded rows too (cp.async) halved the blocks an
// SM and measured slower on an H100.
//
// gap_count_segments_kernel replaces decode_kernel.py:_count_kernel
// (wrapper count_segments_pallas), the counting pass of gap-only
// (Yamamoto) streams: one thread per segment counts the codewords that
// start in [s*seg_bits + gap[s], the next segment's entry) (the last
// segment: below total_bits), at most max_count of them.  Bit positions
// are 64-bit (the JAX kernel's int32 arithmetic is a TPU limit; the
// format's u32 word count allows more).  The TPU kernel's lane relayout,
// its one-hot pair refill and its 2x counting granularity with the fold
// all serve the vector layout; a thread here loads its own words.
//
// C1 only counts, so it advances several codewords a lookup.  A count
// table on the top COUNT_TAB_BITS bits of the window (built once per call
// by gap_count_table_kernel into a 16 KB buffer, copied into each block's
// shared memory) holds, for each prefix, the codewords it decides, their
// total bits and the first one's length.  A prefix decides a codeword
// when its lowest and highest completions give the same compare-chain
// length (the chain never falls as the window grows); the walk goes on
// inside the prefix and takes one codeword past its end too, so a step
// can reach T - 1 + 16 bits.  The multi-codeword step is taken only where
// pos + bits <= end and count + n <= max_count, which keeps "starts below
// end" and the cap exact; otherwise one codeword, its length the entry's
// first or, where the prefix decides nothing, the compare chain against
// the limits in shared memory (canon_len).  One code length counts in
// closed form, no walk.  The window is two words and a bit offset, read by
// a funnel shift, with the next word loaded one refill ahead, and the
// step's arithmetic is 32-bit.  Measured on an H100 at the Yamamoto path's
// 128 MiB: 12 table bits and a 64-bit window 0.200 ms, with the funnel
// window and the limits in shared memory 0.149, 13 bits 0.142, 11 bits
// 0.152; a persistent grid (one table copy a block) 0.164.  B1 takes
// canon_len (bitwalk.cuh) on its staged window; it could take the same
// table.
//
// Bounds on this card.  B1 reads the payload once and writes the rank
// matrix (~1 byte per symbol); with its loads staged and its stores tiled,
// its time is the instructions of each segment's serial bit chain (length
// compare -> shift -> next window), ~100-200 symbols at seg_bits=1024, with
// one thread per segment.
// B2 is bytes-bound: rank matrix in, output out (it reads the matrix's
// rows whole, padding past the counts included, except the last row of a
// run).  C1 reads the payload once and writes one int per segment; at
// 128-bit segments a thread's chain is ~20 codewords, ~8 table steps.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitwalk.cuh"

#define RANK_MAX_ROWS 256
#define RANK_PAD 4  // tile pitch chunk + 4 bytes: odd words for chunk % 8 == 0
#define RANK_MAX_SMEM 49152  // most dynamic shared memory of a B1 block
#define RANK_MAX_REGS 64     // registers a B1 thread may use
#define COUNT_THREADS 256
#define COUNT_TAB_BITS 13  // window bits of C1's count table
#define COUNT_TAB_SIZE (1 << COUNT_TAB_BITS)
#define PLACE_THREADS 256  // threads of a B2 block
#define PLACE_WARPS (PLACE_THREADS / 32)
#define PLACE_MAX_ROWS 1024  // most rows of a B2 block: 4 a thread
#define PLACE_RPT (PLACE_MAX_ROWS / PLACE_THREADS)
#define PLACE_MAX_TILE 32768  // most rows x chunk bytes of a B2 block

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

// Words of a staged row: every word that a valid segment's walk reads.  Its
// codewords start inside its own seg_bits bits, so the last one starts in
// word (phase + seg_bits - 1) / 32 of the row, the phase (the bit of the
// segment's start in its word) 0 where seg_bits % 32 == 0 and below 32
// otherwise; StagedWindow holds that word and the next, has loaded a third,
// and the last codeword's skip may load a fourth.  The wrapper's
// `stage_words` is the same.
__host__ __device__ inline int stage_words(int seg_bits) {
  return (seg_bits - 1 + (seg_bits % 32 ? 31 : 0)) / 32 + 4;
}

// A bit window over one segment, its words staged in a row of shared
// memory: the row holds the payload block's words [base, base + len), zeros
// past the block; a word outside it is read from device memory, zero
// outside [0, n_words).  The window is two words and a bit offset, read
// by a funnel shift, with the next word loaded one refill ahead (as C1's).
struct StagedWindow {
  const uint32_t* words;
  const uint32_t* row;
  long long n_words, base;
  int len;
  int next;  // the word, from base, that the next refill loads
  int q;     // bits of w0 already taken
  uint32_t w0, w1, w2;

  __device__ __forceinline__ StagedWindow(const uint32_t* w, long long n,
                                          const uint32_t* r, long long b,
                                          int l)
      : words(w), row(r), n_words(n), base(b), len(l), next(0), q(0), w0(0),
        w1(0), w2(0) {}

  __device__ __forceinline__ uint32_t word(int j) const {
    if ((unsigned)j < (unsigned)len) return row[j];
    const long long i = base + j;
    return (unsigned long long)i < (unsigned long long)n_words ? words[i] : 0u;
  }

  // put the window at bit pos of the payload block
  __device__ __forceinline__ void seek(long long pos) {
    next = (int)((pos >> 5) - base);
    q = (int)(pos & 31);
    w0 = word(next);
    w1 = word(next + 1);
    w2 = word(next + 2);
    next += 3;
  }

  // the 32 stream bits at the current position
  __device__ __forceinline__ uint32_t peek() const {
    return __funnelshift_l(w1, w0, q);
  }

  // drop ln in [1, 16] bits
  __device__ __forceinline__ void skip(int ln) {
    q += ln;
    if (q >= 32) {
      q -= 32;
      w0 = w1;
      w1 = w2;
      w2 = word(next++);
    }
  }
};

// Copy 4 bytes from device memory to the shared-memory address dst without
// the registers, or write 4 zero bytes there where !fill (nothing is read
// then).
__device__ __forceinline__ void copy4_async(unsigned dst, const uint32_t* src,
                                            bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

// Stage the rows of the calling warp.  Each lane passes its own row: its
// words start at `from`, `avail` of them lie inside the payload block and
// the rest of the row is zeros; -1 past the last segment, a row that is not
// staged.  The warp copies its 32 rows of `pitch` words into rows[0 ..
// 32 * pitch): item x of the 32 * pitch is word x % pitch of row x / pitch,
// lane l takes items l, l + 32, ..., so every lane takes `pitch` items and
// consecutive lanes take consecutive words.  `words`, any valid address,
// stands for the source of a zero fill.  All 32 lanes call it; the rows are
// readable by every lane on return.
__device__ __forceinline__ void stage_warp_rows(uint32_t* rows,
                                                const uint32_t* words,
                                                const uint32_t* from,
                                                int avail, int pitch) {
  const int lane = threadIdx.x & 31;
  int r = lane / pitch, j = lane - r * pitch;
  const int dr = 32 / pitch, dj = 32 - dr * pitch;
  // item lane + 32 k lies at rows[lane + 32 k]
  unsigned dst = (unsigned)__cvta_generic_to_shared(rows + lane);
  for (int k = 0; k < pitch; ++k, dst += 128) {
    const uint32_t* f = reinterpret_cast<const uint32_t*>(__shfl_sync(
        0xffffffffu, reinterpret_cast<unsigned long long>(from), r));
    const int a = __shfl_sync(0xffffffffu, avail, r);
    if (a >= 0) copy4_async(dst, j < a ? f + j : words, j < a);
    r += dr;
    j += dj;
    if (j >= pitch) {
      j -= pitch;
      ++r;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Up to RANK_MAX_REGS registers: held by __launch_bounds__ to 32, ptxas
// recomputed the walk's loop invariants at every codeword (on an H100 at
// the HTC1 cell's shape 3.48 ms against 3.05 with 64 allowed, 46 used; the
// group, Yamamoto and self-sync shapes 12-16% faster too), and 8 blocks of
// 128 still fit an SM.
__global__ void __maxnreg__(RANK_MAX_REGS) gap_decode_ranks_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ gaps,
    const int* __restrict__ counts, const uint32_t* __restrict__ lim,
    const int* __restrict__ bias, uint8_t* __restrict__ ranks,
    long long n_segs_all, int n_segs, long long n_words, int seg_bits,
    int max_count, int min_len, int max_len, int chunk, int pitch) {
  // dynamic: the staged rows, R x pitch words (none where pitch is 0),
  // then the rank tile
  extern __shared__ uint4 smem[];
  __shared__ uint32_t s_lim[32];
  __shared__ int s_bias[32];
  if (threadIdx.x < 32) {
    s_lim[threadIdx.x] = lim[threadIdx.x];
    s_bias[threadIdx.x] = bias[threadIdx.x];
  }

  // the block's segments [t0, t0 + nv): every thread reaches every barrier,
  // those past the last segment decode nothing
  const long long t0 = (long long)blockIdx.x * blockDim.x;
  const long long t = t0 + threadIdx.x;
  const int nv = (int)min((long long)blockDim.x, n_segs_all - t0);
  long long g = 0, pos = 0, base = 0;
  int n = 0;
  if (threadIdx.x < nv) {
    g = t / n_segs;
    const long long s0 = (t - g * n_segs) * seg_bits;
    pos = s0 + gaps[t];
    base = s0 >> 5;
    n = min(max(counts[t], 0), max_count);
  }
  // the words of this block; zero outside it
  const uint32_t* wb = words + g * n_words;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  if (pitch > 0) {  // uniform
    // every segment's row, so that the copies need not wait for the counts
    const int avail = threadIdx.x < nv
                          ? (int)min(max(n_words - base, 0LL), (long long)pitch)
                          : -1;
    stage_warp_rows(stage + (threadIdx.x & ~31) * pitch, words, wb + base,
                    avail, pitch);
  }
  StagedWindow sw(wb, n_words, stage + threadIdx.x * pitch, base, pitch);
  if (n > 0) sw.seek(pos);
  __syncthreads();  // s_lim, s_bias

  const int rpitch = chunk + RANK_PAD;
  uint8_t* tile = reinterpret_cast<uint8_t*>(stage + blockDim.x * pitch);
  uint8_t* row = tile + threadIdx.x * rpitch;
  uint8_t* dst = ranks + t0 * max_count;
  for (int lo = 0; lo < max_count; lo += chunk) {
    const int width = min(chunk, max_count - lo);
    const int m = min(max(n - lo, 0), width);  // codewords in this chunk
    for (int i = 0; i < m; ++i) {
      const uint32_t win = sw.peek();
      const int ln = canon_len(win, s_lim, min_len, max_len);
      // ln is in [1, 16], so the shift is in range
      row[i] = (uint8_t)(s_bias[ln] + (int)(win >> (32 - ln)));
      sw.skip(ln);
    }
    for (int i = m; i < width; ++i) row[i] = 0;
    __syncthreads();
    if (max_count % 4 == 0) {
      store_rows<uint32_t>(tile, rpitch, dst + lo, max_count, nv, width);
    } else {
      store_rows<uint8_t>(tile, rpitch, dst + lo, max_count, nv, width);
    }
    __syncthreads();
  }
}

// Exclusive prefix sum of v over the PLACE_THREADS threads of the block
// (all must call it); `total` gets the sum.  s_warp[] is read after the
// second barrier and rewritten only after the caller's next barrier.
__device__ __forceinline__ int place_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int y = lane < PLACE_WARPS ? s_warp[lane] : 0;
    int z = y;
#pragma unroll
    for (int o = 1; o < PLACE_WARPS; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += u;
    }
    if (lane < PLACE_WARPS) s_warp[lane] = z - y;
    if (lane == PLACE_WARPS - 1) s_warp[PLACE_WARPS] = z;
  }
  __syncthreads();
  total = s_warp[PLACE_WARPS];
  return s_warp[warp] + x - v;
}

// Bytes of B2's buffer for `rows` rows of `chunk` bytes: rounded up to
// 16, and 16 more for a phase of up to 15 bytes.
__host__ __device__ inline int place_buf_bytes(int rows, int chunk) {
  return 16 * ((rows * chunk + 15) / 16 + 1);
}

__global__ void __launch_bounds__(PLACE_THREADS) gap_place_bytes_kernel(
    const uint8_t* __restrict__ ranks, const int* __restrict__ counts,
    const long long* __restrict__ offsets, const int* __restrict__ symtab,
    uint8_t* __restrict__ out, long long n_segs_all, int max_count,
    long long n_out, int rows, int chunk) {
  // dynamic: the compacted bytes of a run at their phase mod 16, then the
  // bytes of each row in this chunk and their exclusive prefix sum (rows +
  // 1 each; entry `rows` stays 0 for the scatter's look past the last row)
  extern __shared__ uint4 smem[];
  __shared__ uint8_t s_sym[256];
  __shared__ int s_warp[PLACE_WARPS + 1];
  __shared__ long long s_d0;
  const int tid = threadIdx.x;
  uint8_t* dense = reinterpret_cast<uint8_t*>(smem);
  int* s_m = reinterpret_cast<int*>(dense + place_buf_bytes(rows, chunk));
  int* s_pre = s_m + rows + 1;
  for (int j = tid; j < 256; j += PLACE_THREADS) s_sym[j] = (uint8_t)symtab[j];
  if (tid == 0) s_m[rows] = s_pre[rows] = 0;

  // the run [s0, s0 + nv): rows 1 of the chunked case, where chunk <
  // max_count.  Thread tid holds rows tid + q * PLACE_THREADS.
  const long long s0 = (long long)blockIdx.x * rows;
  const int nv = (int)min((long long)rows, n_segs_all - s0);
  const int rounds = (nv + PLACE_THREADS - 1) / PLACE_THREADS;
  int n[PLACE_RPT];
  long long off[PLACE_RPT];
#pragma unroll
  for (int q = 0; q < PLACE_RPT; ++q) {
    const int r = tid + q * PLACE_THREADS;
    n[q] = 0;
    off[q] = 0;
    if (r < nv) {
      n[q] = min(max(counts[s0 + r], 0), max_count);
      off[q] = offsets[s0 + r];
    }
  }
  const uint8_t* run = ranks + s0 * max_count;
  for (int lo = 0; lo < max_count; lo += chunk) {
    // read after the scan's barriers; the last reads of the previous
    // chunk's value come before a barrier
    if (tid == 0) s_d0 = off[0] + lo;
    int m[PLACE_RPT], pre[PLACE_RPT], total = 0;
#pragma unroll
    for (int q = 0; q < PLACE_RPT; ++q) {
      m[q] = min(max(n[q] - lo, 0), chunk);
      pre[q] = total;
      if (q < rounds) {  // uniform
        int sum;
        pre[q] += place_scan(m[q], s_warp, sum);
        total += sum;
      }
      const int r = tid + q * PLACE_THREADS;
      if (r < rows) {
        s_m[r] = m[q];
        s_pre[r] = pre[q];
      }
    }
    __syncthreads();
    // a run is dense where every row that places a byte starts where the
    // rows before it end (always for one row)
    const long long d0 = s_d0;
    bool dense_rows = true;
#pragma unroll
    for (int q = 0; q < PLACE_RPT; ++q)
      dense_rows = dense_rows && (m[q] == 0 || off[q] + lo == d0 + pre[q]);
    if (!__syncthreads_and(dense_rows)) {
      // each thread its own rows, byte by byte
#pragma unroll
      for (int q = 0; q < PLACE_RPT; ++q) {
        const uint8_t* row =
            run + (long long)(tid + q * PLACE_THREADS) * max_count + lo;
        for (int i = 0; i < m[q]; ++i) {
          const long long d = off[q] + lo + i;
          if (d >= 0 && d < n_out) out[d] = s_sym[row[i]];
        }
      }
    } else if (total > 0) {
      // load: the bytes [0, L) of the run from row 0's column lo (rows at
      // stride max_count: chunk == max_count unless nv == 1), cut after
      // the last row's bytes; units of 16 at 16-byte-aligned addresses
      const uint8_t* src = run + lo;
      const int L = (nv - 1) * max_count + s_m[nv - 1];
      const int ph_in = (int)((uintptr_t)src & 15);
      const int ph_out = (int)(((uintptr_t)out + (uintptr_t)d0) & 15);
      for (int u = tid; u < (ph_in + L + 15) >> 4; u += PLACE_THREADS) {
        // run bytes [q0 + j0, q0 + j1) of the unit's 16
        const int q0 = 16 * u - ph_in;
        const int j0 = max(0, -q0), j1 = min(16, L - q0);
        uint32_t wd[4];
        if (j0 == 0 && j1 == 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + q0);
          wd[0] = v.x;
          wd[1] = v.y;
          wd[2] = v.z;
          wd[3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wd[q] = 0;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int j = 4 * q + b;
              if (j >= j0 && j < j1) wd[q] |= (uint32_t)src[q0 + j] << (8 * b);
            }
          }
        }
        // scatter: run byte q is byte i of row r
        int r = (q0 + j0) / max_count;
        int i = q0 + j0 - r * max_count;
        int mr = s_m[r], pr = ph_out + s_pre[r];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j >= j0 && j < j1) {
            if (i < mr)
              dense[pr + i] = s_sym[(wd[j >> 2] >> (8 * (j & 3))) & 255];
            if (++i == max_count) {
              i = 0;
              ++r;
              mr = s_m[r];
              pr = ph_out + s_pre[r];
            }
          }
        }
      }
      __syncthreads();
      // store: dense byte x is out[d0 - ph_out + x] for x in [ph_out,
      // ph_out + total), 16-byte units at aligned addresses
      const long long base = d0 - ph_out;
      for (int u = tid; u < (ph_out + total + 15) >> 4; u += PLACE_THREADS) {
        const int x0 = 16 * u;
        const long long d = base + x0;
        if (x0 >= ph_out && x0 + 16 <= ph_out + total && d >= 0 &&
            d + 16 <= n_out) {
          *reinterpret_cast<uint4*>(out + d) =
              *reinterpret_cast<const uint4*>(dense + x0);
        } else {
          for (int j = 0; j < 16; ++j) {
            const int xj = x0 + j;
            if (xj >= ph_out && xj < ph_out + total && d + j >= 0 &&
                d + j < n_out)
              out[d + j] = dense[xj];
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled by the next chunk
  }
}

// A count-table entry: bits [0, 5) the bits of the codewords a prefix
// decides, [5, 9) their number, [9, 13) the first one's length - 1; 0
// where the prefix decides none.
__device__ __forceinline__ int count_entry(int bits, int n, int first) {
  return n ? ((first - 1) << 9) | (n << 5) | bits : 0;
}

__global__ void __launch_bounds__(COUNT_THREADS) gap_count_table_kernel(
    const uint32_t* __restrict__ lim, uint16_t* __restrict__ tab, int min_len,
    int max_len) {
  const int x = blockIdx.x * COUNT_THREADS + threadIdx.x;
  if (x >= COUNT_TAB_SIZE) return;
  const CanonRegs cr(lim, min_len, max_len);
  const uint32_t prefix = (uint32_t)x << (32 - COUNT_TAB_BITS);
  int p = 0, n = 0, first = 0;
  while (p < COUNT_TAB_BITS) {
    // the window at bit p of the prefix: its T - p known bits, then all
    // zeros or all ones
    const uint32_t lo = prefix << p;
    const int ln = cr.len(lo);
    if (cr.len(lo | (0xFFFFFFFFu >> (COUNT_TAB_BITS - p))) != ln) break;
    if (n++ == 0) first = ln;
    p += ln;
  }
  tab[x] = (uint16_t)count_entry(p, n, first);
}

__global__ void __launch_bounds__(COUNT_THREADS) gap_count_segments_kernel(
    const uint32_t* __restrict__ words, const int* __restrict__ gaps,
    const uint32_t* __restrict__ lim, const uint16_t* __restrict__ tab,
    int* __restrict__ counts, long long n_segs, long long n_words,
    long long total_bits, int seg_bits, int max_count, int min_len,
    int max_len) {
  __shared__ uint4 s_tab4[COUNT_TAB_SIZE / 8];
  __shared__ uint32_t s_lim[32];
  const long long s = (long long)blockIdx.x * COUNT_THREADS + threadIdx.x;
  long long pos = 0, end = 0;
  if (s < n_segs) {
    pos = s * seg_bits + gaps[s];
    end = total_bits;
    if (s + 1 < n_segs) end = min(end, (s + 1) * seg_bits + gaps[s + 1]);
  }
  if (min_len == max_len) {
    // every codeword is max_len bits long
    if (s < n_segs)
      counts[s] = pos < end ? (int)min((end - pos + max_len - 1) / max_len,
                                       (long long)max_count)
                            : 0;
    return;
  }
  for (int j = threadIdx.x; j < COUNT_TAB_SIZE / 8; j += COUNT_THREADS)
    s_tab4[j] = reinterpret_cast<const uint4*>(tab)[j];
  if (threadIdx.x < 32) s_lim[threadIdx.x] = lim[threadIdx.x];
  __syncthreads();
  if (s >= n_segs) return;
  const uint16_t* s_tab = reinterpret_cast<const uint16_t*>(s_tab4);
  int count = 0;
  if (pos < end) {
    // the bits left below `end`, capped at 16 * max_count (the launcher
    // keeps that in an int): no more than max_count codewords are walked,
    // so the cap decides no step (a multi-codeword step needs count + n <=
    // max_count, and takes under 32 bits)
    int left = (int)min(end - pos, 16LL * max_count);
    // the window: bits q.. of (w0, w1), MSB first; w2 loaded one refill
    // ahead; words outside [0, n_words) read as zeros
    auto word = [&](long long i) -> uint32_t {
      return (unsigned long long)i < (unsigned long long)n_words
                 ? __ldg(words + i)
                 : 0u;
    };
    long long next = pos >> 5;
    int q = (int)(pos & 31);
    uint32_t w0 = word(next), w1 = word(next + 1), w2 = word(next + 2);
    next += 3;
    do {
      const uint32_t win = __funnelshift_l(w1, w0, q);
      const int e = s_tab[win >> (32 - COUNT_TAB_BITS)];
      int n = (e >> 5) & 15, bits = e & 31;
      if (n == 0 || bits > left || count + n > max_count) {
        bits = n ? (e >> 9) + 1 : canon_len(win, s_lim, min_len, max_len);
        n = 1;
      }
      count += n;
      left -= bits;
      q += bits;  // q < 32 and bits < 32 before: one word at most
      if (q >= 32) {
        q -= 32;
        w0 = w1;
        w1 = w2;
        w2 = word(next++);
      }
    } while (left > 0 && count < max_count);
  }
  counts[s] = count;
}

extern "C" int gap_count_segments_launch(const void* words, const void* gaps,
                                         const void* lim, void* tab,
                                         void* counts, long long n_segs,
                                         long long n_words,
                                         long long total_bits, int seg_bits,
                                         int max_count, int min_len,
                                         int max_len, void* stream) {
  if (max_count < 1 || 16LL * max_count > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  // the table of a code of one length is never read
  if (min_len != max_len) {
    gap_count_table_kernel<<<COUNT_TAB_SIZE / COUNT_THREADS, COUNT_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)lim, (uint16_t*)tab, min_len, max_len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n_segs + COUNT_THREADS - 1) / COUNT_THREADS;
  gap_count_segments_kernel<<<(unsigned)blocks, COUNT_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)gaps, (const uint32_t*)lim,
      (const uint16_t*)tab, (int*)counts, n_segs, n_words, total_bits,
      seg_bits, max_count, min_len, max_len);
  return (int)cudaGetLastError();
}

extern "C" int gap_decode_ranks_launch(const void* words, const void* gaps,
                                       const void* counts, const void* lim,
                                       const void* bias, void* ranks,
                                       long long n_segs_all, int n_segs,
                                       long long n_words, int seg_bits,
                                       int max_count, int min_len,
                                       int max_len, int rows_per_block,
                                       int chunk, int pitch, int smem_bytes,
                                       void* stream) {
  // the wrapper's `ranks_tile` computes the same geometry
  if (rows_per_block < 32 || rows_per_block > RANK_MAX_ROWS ||
      rows_per_block % 32 || chunk < 8 || chunk % 8 ||
      chunk > rows_per_block || seg_bits < 1 ||
      (pitch != 0 && pitch != (stage_words(seg_bits) | 1)) ||
      smem_bytes > RANK_MAX_SMEM ||
      smem_bytes != rows_per_block * (chunk + RANK_PAD + 4 * pitch))
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
      n_segs, n_words, seg_bits, max_count, min_len, max_len, chunk, pitch);
  return (int)cudaGetLastError();
}

extern "C" int gap_place_bytes_launch(const void* ranks, const void* counts,
                                      const void* offsets, const void* symtab,
                                      void* out, long long n_segs_all,
                                      int max_count, long long n_out,
                                      int rows_per_block, int chunk,
                                      int smem_bytes, void* stream) {
  // the wrapper's `place_tile` computes the same geometry: R whole rows,
  // or one row in column chunks
  if (max_count < 1 || rows_per_block < 1 || rows_per_block > PLACE_MAX_ROWS ||
      chunk < 1 || chunk > max_count ||
      (rows_per_block > 1 && chunk != max_count) ||
      (long long)rows_per_block * chunk > PLACE_MAX_TILE ||
      smem_bytes != place_buf_bytes(rows_per_block, chunk) +
                        8 * (rows_per_block + 1))
    return (int)cudaErrorInvalidValue;
  // a refusal is returned, and cleared so that it does not surface at a
  // later launch's check
  cudaError_t err = cudaFuncSetAttribute(
      gap_place_bytes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const long long blocks = (n_segs_all + rows_per_block - 1) / rows_per_block;
  gap_place_bytes_kernel<<<(unsigned)blocks, PLACE_THREADS, smem_bytes,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)ranks, (const int*)counts, (const long long*)offsets,
      (const int*)symtab, (uint8_t*)out, n_segs_all, max_count, n_out,
      rows_per_block, chunk);
  return (int)cudaGetLastError();
}
