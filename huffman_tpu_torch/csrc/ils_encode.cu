// ILS encode kernels for Hopper: the pack over chunked streams of the
// fused tier (A2, with its certificate) and of the two-pass tier (A5), and
// the two-pass tier's schedule pass (A4).
//
// Replaces huffman_tpu/ops/pallas/ils_kernels.py:
//   ils_certify_bits_kernel + ils_pack_certify_kernel:
//       _pack_certify_kernel (ils_pack_certify, A2; also
//       ils_pack_certify_stream, D1)
//   ils_certify_bits_kernel + ils_pack_kernel: _pack_kernel (ils_pack, A5)
//   ils_lengths_kernel: _lengths_kernel (ils_lengths_pass, A4)
//
// Bound on this card: bytes.  Each kernel reads the data once (k*1024 bytes
// per tile) and writes the payload once (~ratio x data) plus small per-lane
// outputs; at 3.35 TB/s a 256 MiB section needs ~0.13 ms.  Every stream is
// one serial bit accumulator, so one thread per stream is bound by the
// instructions of that chain and by the blocks in flight: a block per tile
// gives 256 MiB at k=4096 64 blocks of 1024 threads, half the card, and at
// k=8192 32 blocks.
//
// A2's and A5's design: each stream is cut into C chunks of whole
// ILS_WIN-body windows (`certify_chunks` in ops/ils_kernels.py picks C,
// the launcher checks it), and the grid is (tile, chunk), 1024 threads a
// block, so A2's laggard anchor's minimum still spans the whole tile.  It
// rests on one fact: a body's four codes add at most 64 bits, so at most
// one pair retires per body, and after every body a stream with `cum` code
// bits so far has e_ptr == cum >> 6 and used == cum & 63; the decoder
// refill A2 replays happens exactly in the bodies where a pair retires,
// with pptr == 2 + e_ptr (valid == 128 - used between bodies).  So:
//  - ils_certify_bits_kernel writes, for every chunk but the last, each
//    stream's code bits, and for A2 zeroes the violation flags;
//  - the pack kernel starts chunk c from the sum of the earlier chunks'
//    bits: e_ptr and used by the closed form, the accumulator seeded with
//    the last `used` code bits before the chunk (the stream's codes walked
//    back from the chunk's start: a few bodies, more over bytes the table
//    lacks).  Chunk boundaries are window and flush boundaries (G in
//    {1, 2} divides ILS_WIN).  A pair is judged in the chunk where it
//    retires against that chunk's window base, with its earlier bits from
//    the seed, so a dropped pair is dropped whole.  Only the last chunk
//    judges the final partial pair (and, in A2, writes `bits`); an A2
//    flag is set by any chunk.
//  - The window base (ROADMAP.md trap F2): A2's "mu" anchor mu + boff_est
//    at each group's first body, its "laggard" anchor the tile minimum of
//    e_ptr after the previous flush (at a chunk's start the minimum
//    there); A5's mu + boffs[t, window] at each group's first body, its
//    anchors per window from A4's exact envelope.
// The emission window only replays the TPU kernels' cadence to decide
// which pairs they would have dropped (and A2's violation flag).  A5
// writes pair e at rows row_starts[t] + 2e of the compact payload and
// skips a pair outside [0, n_rows): the row starts are taken on trust.
// Each body's data word is loaded one body ahead.  A warp stages its
// finished pairs in shared memory and stores each final pair as two rows
// of 32 consecutive columns.
//
// A4's design rests on the same fact: its state after every body is a
// closed form of the code bits so far (e_ptr == cum >> 6, used == cum &
// 63, the decoder's pptr == 2 + e_ptr), so it needs neither an
// accumulator nor a walk back.  It runs on A2's (tile, chunk) grid: the
// bits kernel above writes every chunk's code bits but the last's, then
// ils_lengths_kernel starts chunk c of each stream from the sum of the
// earlier chunks' bits and walks its bodies, four lookups a body in a
// 256-entry shared table of code lengths, writing the envelopes of its own
// whole windows; the last chunk writes `bits` and takes the final flush at
// the mu of body nb - 1.  A refill happens in exactly the bodies where a
// pair retires, at pptr == 2 + e_ptr, so a window's refill envelope is its
// emission envelope + 2 (before the final flush, which only the emission
// envelope takes), and a window without a retiring pair keeps both
// sentinels: the kernel tracks one min/max pair.  A grid of (tile, chunk)
// gives one tile at k=262,148 (the file path's first attempt on a ragged
// 256 MiB file) 257 blocks where one block a tile gave it one.  The two-pass
// tier hands A5 the chunk bits A4's bits kernel wrote (`have_cbits`), so
// that kernel runs once per tier call.
#include "ils_common.cuh"

#define COUNT_THREADS 256  // pass 1
#define CERT_RING 8  // pair slots of a warp's staging ring in pass 2

__device__ __forceinline__ uint32_t stream_word(const uint32_t* data_t, int i,
                                                int s, int rot) {
  return data_t[(size_t)i * ILS_LANES + (rot ? ils_rot_src(s, i) : s)];
}

// Minimum over the 1024 threads of the block (all threads must call it).
// red[32] is read after the second barrier and rewritten only after the
// next call's first barrier, so back-to-back calls do not race.
__device__ __forceinline__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int m = __reduce_min_sync(0xffffffffu, red[lane]);
    if (lane == 0) red[32] = m;
  }
  __syncthreads();
  return red[32];
}

// ----------------------------------------------------------------------
// A2 and A5
// ----------------------------------------------------------------------
struct CertArgs {
  const uint32_t* data;    // (n_tiles * k/4, 1024) u32 words
  const int* tab;          // (256,) (len << 20) | code
  uint32_t* pay;           // A2: strided payload; A5: compact payload
  int* bits;               // A2: (n_tiles, 1024) bits per stream
  int* dn;                 // A2: (n_tiles, n_win, 1024) refill envelope
  int* dx;
  int* viol;               // A2: (n_tiles, 1024) emission-out-of-band flag
  int* cbits;              // (n_tiles, C - 1, 1024) code bits of each chunk
  const int* boffs;        // A5: (n_tiles, n_win) emission anchors
  const int* row_starts;   // A5: (n_tiles,) compact row offsets
  int k, snum, rot;
  int G;                   // bodies per flush group (1 or 2)
  int W;                   // emission window width in pairs
  int cap_pairs;           // pair capacity the window is clamped into
  int boff_est;            // A2 "mu" anchor offset: -(e_band // 2)
  int laggard;             // A2 anchor: 0 = "mu", 1 = "laggard"
  int chunks;              // C
  int chunk_bodies;        // bodies of every chunk but the last
  long long stride_rows;   // A2: rows per tile region
  long long n_rows;        // A5: rows of the compact payload (+ slack)
};

// Pass 1: grid (tile, chunk < C - 1, 1024 / COUNT_THREADS), one thread
// per stream: the code bits of the chunk, four lookups and adds a body.
__global__ void __launch_bounds__(COUNT_THREADS) ils_certify_bits_kernel(
    const CertArgs a) {
  __shared__ int s_len[256];
  for (int j = threadIdx.x; j < 256; j += COUNT_THREADS)
    s_len[j] = a.tab[j] >> 20;
  __syncthreads();

  constexpr int per = ILS_LANES / COUNT_THREADS;
  const int tc = blockIdx.x / per;  // t * (C - 1) + c
  const int c = tc % (a.chunks - 1);
  const int t = tc / (a.chunks - 1);
  const int s = (blockIdx.x % per) * COUNT_THREADS + threadIdx.x;
  const int nb = a.k >> 2;
  const uint32_t* data_t = a.data + (size_t)t * nb * ILS_LANES;
  // chunks before the last are whole: b1 <= nb
  const int b0 = c * a.chunk_bodies, b1 = b0 + a.chunk_bodies;
  int bits = 0;
#pragma unroll 8
  for (int i = b0; i < b1; ++i) {
    const uint32_t w = stream_word(data_t, i, s, a.rot);
    bits += s_len[w & 255] + s_len[(w >> 8) & 255] + s_len[(w >> 16) & 255] +
            s_len[w >> 24];
  }
  a.cbits[(size_t)tc * ILS_LANES + s] = bits;
  if (c == 0 && a.viol) a.viol[t * ILS_LANES + s] = 0;
}

// Pass 2, one chunk of every stream of a tile; COMPACT is A5.  A warp's
// finished pairs go through a ring of CERT_RING pair slots in shared
// memory, [slot][lane] (dynamic, 64 KB a block): pair e of a lane sits in
// slot e % CERT_RING while e is within CERT_RING pairs of the warp's
// `flushed` pair, else it is stored straight away.  A pair is final, and
// the warp stores its two rows, 32 consecutive columns each, for the
// lanes whose slot holds it, once every lane has passed it; in A2 also
// once it lies below the window base, since A2's base never falls and a
// pair below it is dropped.  A5's base can fall (A4's anchors are the
// per-window minimum of e_ptr - mu, which can drop from one window to the
// next): a pair below an earlier base can still retire, so A5 flushes to
// the warp's minimum e_ptr alone, and every retiring pair lies at or past
// `flushed`.  Stored from each thread, every warp store of a pair would
// touch up to 32 rows.  A body's four codes (at most 64 bits) are first
// joined into one word and then put into the accumulator once.
// Registers: two blocks of 1024 threads an SM leave 32 a thread; ptxas
// reports whether the kernels hold to it (chip_smoke.py phase 1).
template <bool COMPACT>
__device__ __forceinline__ void pack_chunk(const CertArgs& a) {
  extern __shared__ uint64_t s_ring[];
  __shared__ int s_tab[256];
  __shared__ int s_red[33];
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int c = blockIdx.x % a.chunks;
  const int t = blockIdx.x / a.chunks;
  if (s < 256) s_tab[s] = a.tab[s];
  __syncthreads();

  const bool laggard = !COMPACT && a.laggard;
  const int nb = a.k >> 2;
  const int n_win = (nb + ILS_WIN - 1) / ILS_WIN;
  const int base_hi = a.cap_pairs - a.W;
  const int b0 = c * a.chunk_bodies;
  const int b1 = min(nb, b0 + a.chunk_bodies);

  // the stream's state at body b0, from the earlier chunks' bits
  const size_t cb = (size_t)t * (a.chunks - 1) * ILS_LANES + s;
  int cum = 0;
  for (int j = 0; j < c; ++j) cum += a.cbits[cb + (size_t)j * ILS_LANES];
  int used = cum & 63, e_ptr = cum >> 6;
  const uint32_t* data_t = a.data + (size_t)t * nb * ILS_LANES;
  uint64_t hi = 0;  // MSB-first accumulator, `used` < 64 bits valid
  {
    // the last `used` code bits before b0, the stream's codes walked back
    // from body b0 - 1 (a few bodies; further over bytes the table lacks)
    uint64_t seed = 0;
    int n = 0;
    for (int i = b0 - 1; i >= 0 && n < used; --i) {
      const uint32_t w = stream_word(data_t, i, s, a.rot);
      for (int j = 3; j >= 0 && n < used; --j) {
        const int e = s_tab[(w >> (8 * j)) & 255];
        // n < used <= 63 here
        seed |= (uint64_t)(e & 0xFFFF) << n;
        n += e >> 20;
      }
    }
    if (used) hi = seed << (64 - used);
  }

  // pair e of stream s goes to rows row0 + 2e: A2's stride region, always
  // in its buffer; A5's compact rows, a pair outside them skipped
  const long long row0 =
      COMPACT ? (long long)a.row_starts[t] : (long long)t * a.stride_rows;
  auto store = [&](int e, uint64_t v) {
    const long long r = row0 + 2 * (long long)e;
    if (COMPACT && (r < 0 || r + 1 >= a.n_rows)) return;
    uint32_t* p = a.pay + (size_t)r * ILS_LANES + s;
    p[0] = (uint32_t)(v >> 32);
    p[ILS_LANES] = (uint32_t)v;
  };
  uint64_t* ring = s_ring + (s >> 5) * CERT_RING * 32 + lane;
  int flushed = __reduce_min_sync(0xffffffffu, e_ptr);
  unsigned held = 0;  // the ring slots that hold a pair of this lane
  auto retire = [&](uint64_t v) {
    if (e_ptr - flushed < CERT_RING) {
      ring[(e_ptr & (CERT_RING - 1)) * 32] = v;
      held |= 1u << (e_ptr & (CERT_RING - 1));
    } else {
      store(e_ptr, v);
    }
  };
  // store the final pairs [flushed, upto) (warp-uniform)
  auto flush = [&](int upto) {
    for (int e = flushed; e < min(upto, flushed + CERT_RING); ++e) {
      const int sl = e & (CERT_RING - 1);
      if (held >> sl & 1) {
        store(e, ring[sl * 32]);
        held &= ~(1u << sl);
      }
    }
    flushed = max(flushed, upto);
  };

  const size_t env0 = (size_t)t * n_win * ILS_LANES + s;
  int viol = 0;
  int dmin = ILS_BIG, dmax = -ILS_BIG;
  // the emission window base: "mu" and A5 recompute it at each group's
  // first body; "laggard" uses the tile minimum of e_ptr after the
  // PREVIOUS flush (stale by one flush, as in the TPU kernel): at b0 that
  // is the minimum at b0 (0 in chunk 0)
  int base = 0;
  if (laggard) base = ils_clip(block_min(e_ptr, s_red), 0, base_hi);
  const int* boffs_t = COMPACT ? a.boffs + (size_t)t * n_win : nullptr;
  int boff = a.boff_est;  // A5: the anchor of the current window

  uint32_t w_next = stream_word(data_t, b0, s, a.rot);
  for (int i = b0; i < b1; ++i) {
    const uint32_t w = w_next;
    if (i + 1 < b1) w_next = stream_word(data_t, i + 1, s, a.rot);
    const int mu = ils_mu(i, a.snum);
    if (COMPACT && i % ILS_WIN == 0) boff = boffs_t[i / ILS_WIN];
    if (!laggard && (i & (a.G - 1)) == 0)
      base = ils_clip(mu + boff, 0, base_hi);
    // the body's codes joined, right-aligned: l4 <= 64 bits (absent
    // symbols have ln == 0 and add nothing)
    uint64_t v = 0;
    int l4 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = s_tab[(w >> (8 * j)) & 255];
      const int ln = e >> 20;
      v = (v << ln) | (uint64_t)(ln ? e & 0xFFFF : 0);
      l4 += ln;
    }
    // left-justified at bit `used` of the 128-bit (hi, lo); lo is empty
    // between bodies, and used < 64 keeps both shifts in range
    const uint64_t vl = l4 ? v << (64 - l4) : 0;
    hi |= vl >> used;
    const uint64_t lo = used ? vl << (64 - used) : 0;
    used += l4;
    if (used >= 64) {  // at most one pair per body: used <= 63 + 64
      if (!COMPACT) {
        // the decoder refills in this body, at pptr == 2 + e_ptr
        const int dev = 2 + e_ptr - mu;
        dmin = min(dmin, dev);
        dmax = max(dmax, dev);
      }
      // the TPU kernel retires this pair at its group's flush into the
      // window [base, base + W); a pair outside it is dropped there (and
      // flags a violation in A2), so it is dropped here too
      const int rel = e_ptr - base;
      if (rel >= 0 && rel < a.W) {
        retire(hi);
      } else {
        viol = 1;
      }
      hi = lo;
      ++e_ptr;
      used -= 64;
    }
    // a flush ends every G bodies (G = 2 when the TPU unroll is even)
    if (laggard && ((i + 1) & (a.G - 1)) == 0)
      base = ils_clip(block_min(e_ptr, s_red), 0, base_hi);
    const int warp_min = __reduce_min_sync(0xffffffffu, e_ptr);
    flush(COMPACT ? warp_min : max(base, warp_min));
    if (!COMPACT && (i + 1) % ILS_WIN == 0 && i + 1 < nb) {
      const size_t o = env0 + (size_t)(i / ILS_WIN) * ILS_LANES;
      a.dn[o] = dmin;
      a.dx[o] = dmax;
      dmin = ILS_BIG;
      dmax = -ILS_BIG;
    }
  }

  if (c == a.chunks - 1) {
    if (!COMPACT) a.bits[t * ILS_LANES + s] = 64 * e_ptr + used;
    // the final flush of the zero-padded partial pair is judged too, at
    // the last body's mu (or the stale laggard base)
    if (used > 0) {
      const int fbase =
          laggard ? base
                  : ils_clip(ils_mu(nb - 1, a.snum) +
                                 (COMPACT ? boffs_t[n_win - 1] : a.boff_est),
                             0, base_hi);
      const int rel = e_ptr - fbase;
      if (rel >= 0 && rel < a.W) {
        retire(hi);
      } else {
        viol = 1;
      }
    }
    if (!COMPACT) {
      const size_t o = env0 + (size_t)(n_win - 1) * ILS_LANES;
      a.dn[o] = dmin;
      a.dx[o] = dmax;
    }
  }
  flush(flushed + CERT_RING);
  if (COMPACT) return;
  // one chunk writes its flag; several OR theirs into the zeroed flags
  if (a.chunks == 1) {
    a.viol[t * ILS_LANES + s] = viol;
  } else if (viol) {
    a.viol[t * ILS_LANES + s] = 1;
  }
}

__global__ void __launch_bounds__(ILS_LANES, 2) ils_pack_certify_kernel(
    const CertArgs a) {
  pack_chunk<false>(a);
}

__global__ void __launch_bounds__(ILS_LANES, 2) ils_pack_kernel(
    const CertArgs a) {
  pack_chunk<true>(a);
}

// The geometry `certify_chunks` computes in the wrapper: C chunks of
// chunk_win windows a stream, the last one possibly shorter.
static inline bool chunks_ok(int k, int chunks, int chunk_win) {
  const int n_win = ((k >> 2) + ILS_WIN - 1) / ILS_WIN;
  return chunk_win >= 1 && chunks == (n_win + chunk_win - 1) / chunk_win;
}

// The bits kernel over every chunk but the last (C > 1).
static int launch_bits(const CertArgs& a, int n_tiles, cudaStream_t stream) {
  ils_certify_bits_kernel<<<n_tiles * (a.chunks - 1) *
                                (ILS_LANES / COUNT_THREADS),
                            COUNT_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The chunks' bits kernel where a stream has more than one chunk (unless
// A5 was handed A4's, `have_cbits`), then the pack kernel over (tile,
// chunk).
template <bool COMPACT>
int launch_chunks(CertArgs& a, int n_tiles, int chunk_win, int have_cbits,
                  cudaStream_t stream) {
  if (!chunks_ok(a.k, a.chunks, chunk_win) || (a.G != 1 && a.G != 2))
    return (int)cudaErrorInvalidValue;
  a.chunk_bodies = chunk_win * ILS_WIN;
  if (a.chunks > 1 && !have_cbits) {
    const int err = launch_bits(a, n_tiles, stream);
    if (err != cudaSuccess) return err;
  }
  // a refusal of the shared-memory size is returned, and cleared so that
  // it does not surface at a later launch's check
  const auto kernel = COMPACT ? ils_pack_kernel : ils_pack_certify_kernel;
  const int smem = CERT_RING * ILS_LANES * (int)sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<n_tiles * a.chunks, ILS_LANES, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// A4
// ----------------------------------------------------------------------
struct EncArgs {
  const uint32_t* data;    // (n_tiles * k/4, 1024) u32 words
  const int* tab;          // (256,) (len << 20) | code
  const int* cbits;        // (n_tiles, C - 1, 1024) code bits of each chunk
  int* bits;               // (n_tiles, 1024) bits per stream
  int* dn;                 // (n_tiles, n_win, 1024) refill envelope
  int* dx;
  int* en;                 // (n_tiles, n_win, 1024) emission envelope
  int* ex;
  int k, snum, rot;
  int chunks;              // C
  int chunk_bodies;        // bodies of every chunk but the last
};

// The refill envelope of a window from its emission envelope before the
// final flush: +2, or the sentinels where no pair retired.
__device__ __forceinline__ void put_refill(const EncArgs& a, size_t o,
                                          int emin, int emax) {
  a.dn[o] = emin == ILS_BIG ? ILS_BIG : emin + 2;
  a.dx[o] = emax == -ILS_BIG ? -ILS_BIG : emax + 2;
}

// One chunk of every stream of a tile, thread s = stream s.  Registers:
// two blocks of 1024 threads an SM leave 32 a thread; ptxas reports
// whether the kernel holds to it (chip_smoke.py phase 1).
__global__ void __launch_bounds__(ILS_LANES, 2) ils_lengths_kernel(
    const EncArgs a) {
  __shared__ int s_len[256];
  const int s = threadIdx.x;
  const int c = blockIdx.x % a.chunks;
  const int t = blockIdx.x / a.chunks;
  if (s < 256) s_len[s] = a.tab[s] >> 20;
  __syncthreads();

  const int nb = a.k >> 2;
  const int n_win = (nb + ILS_WIN - 1) / ILS_WIN;
  const int b0 = c * a.chunk_bodies;
  const int b1 = min(nb, b0 + a.chunk_bodies);
  // the stream's state at body b0, from the earlier chunks' bits
  const int* cb = a.cbits + (size_t)t * (a.chunks - 1) * ILS_LANES + s;
  int cum = 0;
  for (int j = 0; j < c; ++j) cum += cb[(size_t)j * ILS_LANES];
  int used = cum & 63, e_ptr = cum >> 6;
  // 64-bit offsets: a 1 GiB section holds ~2.7e8 words
  const uint32_t* data_t = a.data + (size_t)t * nb * ILS_LANES;
  const size_t env0 = (size_t)t * n_win * ILS_LANES + s;

  int emin = ILS_BIG, emax = -ILS_BIG;
  for (int w0 = b0; w0 < b1; w0 += ILS_WIN) {
    const int w1 = min(b1, w0 + ILS_WIN);
#pragma unroll 4
    for (int i = w0; i < w1; ++i) {
      const uint32_t w = stream_word(data_t, i, s, a.rot);
      used += s_len[w & 255] + s_len[(w >> 8) & 255] +
              s_len[(w >> 16) & 255] + s_len[w >> 24];
      if (used >= 64) {  // at most one pair per body: used <= 63 + 64
        const int dev = e_ptr - ils_mu(i, a.snum);
        emin = min(emin, dev);
        emax = max(emax, dev);
        ++e_ptr;
        used -= 64;
      }
    }
    if (w1 < nb) {  // a whole window; the last one is the last chunk's
      const size_t o = env0 + (size_t)(w0 / ILS_WIN) * ILS_LANES;
      a.en[o] = emin;
      a.ex[o] = emax;
      put_refill(a, o, emin, emax);
      emin = ILS_BIG;
      emax = -ILS_BIG;
    }
  }
  if (c != a.chunks - 1) return;

  a.bits[t * ILS_LANES + s] = 64 * e_ptr + used;
  const size_t o = env0 + (size_t)(n_win - 1) * ILS_LANES;
  put_refill(a, o, emin, emax);
  // the final flush of the zero-padded partial pair, at the last body's
  // mu: the emission envelope only
  if (used > 0) {
    const int dev = e_ptr - ils_mu(nb - 1, a.snum);
    emin = min(emin, dev);
    emax = max(emax, dev);
  }
  a.en[o] = emin;
  a.ex[o] = emax;
}

// The chunks' bits kernel where a stream has more than one chunk, then
// the lengths kernel over (tile, chunk); `cbits` keeps the chunk bits for
// A5 (`ils_pack_launch`'s have_cbits).
extern "C" int ils_lengths_launch(const void* data, const void* tab,
                                  void* bits, void* dn, void* dx, void* en,
                                  void* ex, void* cbits, int n_tiles, int k,
                                  int snum, int rot, int chunks,
                                  int chunk_win, void* stream) {
  if (!chunks_ok(k, chunks, chunk_win)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (chunks > 1) {
    CertArgs b = {};
    b.data = (const uint32_t*)data;
    b.tab = (const int*)tab;
    b.cbits = (int*)cbits;
    b.k = k;
    b.rot = rot;
    b.chunks = chunks;
    b.chunk_bodies = chunk_win * ILS_WIN;
    const int err = launch_bits(b, n_tiles, st);
    if (err != cudaSuccess) return err;
  }
  EncArgs a = {};
  a.data = (const uint32_t*)data;
  a.tab = (const int*)tab;
  a.cbits = (const int*)cbits;
  a.bits = (int*)bits;
  a.dn = (int*)dn;
  a.dx = (int*)dx;
  a.en = (int*)en;
  a.ex = (int*)ex;
  a.k = k;
  a.snum = snum;
  a.rot = rot;
  a.chunks = chunks;
  a.chunk_bodies = chunk_win * ILS_WIN;
  ils_lengths_kernel<<<n_tiles * chunks, ILS_LANES, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ils_pack_certify_launch(
    const void* data, const void* tab, void* pay, void* bits, void* dn,
    void* dx, void* viol, void* cbits, int n_tiles, int k,
    int snum, int rot, int G, int W, int cap_pairs, int boff_est, int laggard,
    long long stride_rows, int chunks, int chunk_win, void* stream) {
  CertArgs a = {};
  a.data = (const uint32_t*)data;
  a.tab = (const int*)tab;
  a.pay = (uint32_t*)pay;
  a.bits = (int*)bits;
  a.dn = (int*)dn;
  a.dx = (int*)dx;
  a.viol = (int*)viol;
  a.cbits = (int*)cbits;
  a.k = k;
  a.snum = snum;
  a.rot = rot;
  a.G = G;
  a.W = W;
  a.cap_pairs = cap_pairs;
  a.boff_est = boff_est;
  a.laggard = laggard;
  a.chunks = chunks;
  a.stride_rows = stride_rows;
  return launch_chunks<false>(a, n_tiles, chunk_win, 0, (cudaStream_t)stream);
}

extern "C" int ils_pack_launch(const void* data, const void* tab,
                               const void* boffs, const void* row_starts,
                               void* pay, void* cbits, int n_tiles, int k,
                               int snum, int rot, int G, int W, int cap_pairs,
                               long long n_rows, int chunks, int chunk_win,
                               int have_cbits, void* stream) {
  CertArgs a = {};
  a.data = (const uint32_t*)data;
  a.tab = (const int*)tab;
  a.boffs = (const int*)boffs;
  a.row_starts = (const int*)row_starts;
  a.pay = (uint32_t*)pay;
  a.cbits = (int*)cbits;
  a.k = k;
  a.snum = snum;
  a.rot = rot;
  a.G = G;
  a.W = W;
  a.cap_pairs = cap_pairs;
  a.chunks = chunks;
  a.n_rows = n_rows;
  return launch_chunks<true>(a, n_tiles, chunk_win, have_cbits,
                             (cudaStream_t)stream);
}
