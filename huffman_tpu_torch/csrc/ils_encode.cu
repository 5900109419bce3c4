// ILS encode kernels A2, A4 and A5 for Hopper: one per-stream encoder step
// under three template flags.
//
// Replaces huffman_tpu/ops/pallas/ils_kernels.py:
//   <false, false, false>  _lengths_kernel       (ils_lengths_pass, A4)
//   <true,  true,  false>  _pack_certify_kernel  (ils_pack_certify, A2)
//   <true,  false, true>   _pack_kernel          (ils_pack, A5)
//
// Bound on this card: bytes.  Each kernel reads the data once (k*1024 bytes
// per tile) and writes the payload once (~ratio x data) plus small per-lane
// outputs; at 3.35 TB/s a 256 MiB section needs ~0.13 ms.  One thread per
// stream runs a serial bit accumulator, so in practice the kernels are bound
// by the latency of that chain and by the few blocks in flight (one
// 1024-thread block per tile: 64 blocks for 256 MiB at k=4096).
//
// Design: one block of 1024 threads per tile, thread s = stream s, because
// the laggard anchor needs the minimum of e_ptr over the whole tile at every
// flush.  A thread does four lookups per body in a 256-entry shared table
// of (len << 20) | code, keeps a 128-bit accumulator (two uint64_t) and
// writes every finished pair straight to its own column: in the strided
// region (A2) or at the certified row start (A5).  No emission window is
// needed for the write itself; it only replays the TPU kernel's window
// cadence to decide which pairs the TPU kernel would have dropped, and with
// them the violation flag (ROADMAP.md trap F2).  It simulates the decoder refill
// per body (A2, A4) and gives the per-(tile, window) envelopes per lane, in
// the same form as the plain version (ops/ils_kernels.py).

#include "ils_common.cuh"

struct EncArgs {
  const uint32_t* data;    // (n_tiles * k/4, 1024) u32 words
  const int* tab;          // (256,) (len << 20) | code
  const int* boffs;        // A5: (n_tiles, n_win) emission anchors
  const int* row_starts;   // A5: (n_tiles,) compact row offsets
  uint32_t* pay;           // A2: strided payload; A5: compact payload
  int* bits;               // A2, A4: (n_tiles, 1024) bits per stream
  int* dn;                 // A2, A4: (n_tiles, n_win, 1024) refill envelope
  int* dx;
  int* en;                 // A4: (n_tiles, n_win, 1024) emission envelope
  int* ex;
  int* viol;               // A2: (n_tiles, 1024) emission-out-of-band flag
  int k, snum, rot;
  int G;                   // bodies per flush group (1 or 2)
  int W;                   // emission window width in pairs
  int cap_pairs;           // pair capacity the window is clamped into
  int boff_est;            // A2 "mu" anchor offset: -(e_band // 2)
  int laggard;             // A2 anchor: 0 = "mu", 1 = "laggard"
  long long stride_rows;   // A2: rows per tile region
  long long n_rows;        // A5: rows of the compact payload (+ slack)
};

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

// Registers: a 1024-thread block may use at most 64 registers per thread;
// the launch bound makes the compiler hold to it, and a launch that still
// asks for more fails and surfaces through cudaGetLastError().
template <bool PACK, bool CERTIFY, bool COMPACT_DST>
__global__ void __launch_bounds__(ILS_LANES) ils_encode_kernel(const EncArgs a) {
  constexpr bool SIM_DEC = !COMPACT_DST;  // decoder refill simulation
  __shared__ int s_tab[256];
  __shared__ int s_red[33];
  const int s = threadIdx.x;
  const int t = blockIdx.x;
  if (s < 256) s_tab[s] = a.tab[s];
  __syncthreads();

  const int nb = a.k >> 2;
  const int n_win = (nb + ILS_WIN - 1) / ILS_WIN;
  const int base_hi = a.cap_pairs - a.W;
  // 64-bit offsets: a 1 GiB section holds ~2.7e8 words
  const uint32_t* data_t = a.data + (size_t)t * nb * ILS_LANES;
  // A2 writes pair e_ptr < cap_pairs of its own stride region, always in
  // the buffer.  A5 takes the row starts on trust (no host check), so a
  // pair the compact payload cannot hold is skipped, never written.
  long long row0 = 0;
  if (PACK) row0 = COMPACT_DST ? (long long)a.row_starts[t]
                               : (long long)t * a.stride_rows;
  auto store_pair = [&](int pair_idx, uint64_t v) {
    const long long r = row0 + 2 * (long long)pair_idx;
    if (COMPACT_DST && (r < 0 || r + 1 >= a.n_rows)) return;
    uint32_t* p = a.pay + (size_t)r * ILS_LANES + s;
    p[0] = (uint32_t)(v >> 32);
    p[ILS_LANES] = (uint32_t)v;
  };
  const size_t env0 = (size_t)t * n_win * ILS_LANES + s;

  uint64_t hi = 0, lo = 0;  // MSB-first accumulator, `used` bits valid
  int used = 0, e_ptr = 0, valid = 128, pptr = 2, viol = 0;
  // The emission window base (ROADMAP.md trap F2).  "mu" and A5 recompute
  // it at each group's first body; "laggard" uses the tile minimum of e_ptr
  // after the PREVIOUS flush (stale by one flush, as in the TPU kernel),
  // starting at 0 and carried across the whole tile.
  int base = 0;
  int dmin = ILS_BIG, dmax = -ILS_BIG, emin = ILS_BIG, emax = -ILS_BIG;

  for (int i = 0; i < nb; ++i) {
    const int mu = ils_mu(i, a.snum);
    if (PACK && !a.laggard && i % a.G == 0) {
      const int boff =
          COMPACT_DST ? a.boffs[t * n_win + i / ILS_WIN] : a.boff_est;
      base = ils_clip(mu + boff, 0, base_hi);
    }
    const uint32_t w =
        data_t[(size_t)i * ILS_LANES + (a.rot ? ils_rot_src(s, i) : s)];
    int l4 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = s_tab[(w >> (8 * j)) & 255];
      const int ln = e >> 20;
      // absent symbols have ln == 0 and insert nothing; ln in [1, 16] and
      // used <= 111 here keep every shift below in range
      if (PACK && ln) {
        const uint64_t c = (uint64_t)(e & 0xFFFF) << (64 - ln);
        if (used < 64) {
          hi |= c >> used;
          if (used) lo |= c << (64 - used);
        } else {
          lo |= c >> (used - 64);
        }
      }
      used += ln;
      l4 += ln;
    }
    if (SIM_DEC) {
      valid -= l4;
      if (valid <= 64) {
        const int dev = pptr - mu;
        dmin = min(dmin, dev);
        dmax = max(dmax, dev);
        ++pptr;
        valid += 64;
      }
    }
    if (used >= 64) {  // at most one pair per body: used <= 63 + 64
      if (!PACK) {
        const int dev = e_ptr - mu;
        emin = min(emin, dev);
        emax = max(emax, dev);
      } else {
        // the TPU kernel retires this pair at its group's flush into the
        // window [base, base + W); a pair outside it is dropped there (and
        // flags a violation in A2), so it is dropped here too
        const int rel = e_ptr - base;
        if (rel >= 0 && rel < a.W) {
          store_pair(e_ptr, hi);
        } else if (CERTIFY) {
          viol = 1;
        }
        hi = lo;
        lo = 0;
      }
      ++e_ptr;
      used -= 64;
    }
    // a flush ends every G bodies (G = 2 when the TPU unroll is even)
    if (CERTIFY && a.laggard && (i + 1) % a.G == 0) {
      base = ils_clip(block_min(e_ptr, s_red), 0, base_hi);
    }
    if (SIM_DEC && (i + 1) % ILS_WIN == 0 && i + 1 < nb) {
      const size_t o = env0 + (size_t)(i / ILS_WIN) * ILS_LANES;
      a.dn[o] = dmin;
      a.dx[o] = dmax;
      dmin = ILS_BIG;
      dmax = -ILS_BIG;
      if (!PACK) {
        a.en[o] = emin;
        a.ex[o] = emax;
        emin = ILS_BIG;
        emax = -ILS_BIG;
      }
    }
  }

  if (SIM_DEC) a.bits[t * ILS_LANES + s] = 64 * e_ptr + used;
  // the final flush of the zero-padded partial pair is judged too, at the
  // last body's mu (or the stale laggard base)
  if (used > 0) {
    if (!PACK) {
      const int dev = e_ptr - ils_mu(nb - 1, a.snum);
      emin = min(emin, dev);
      emax = max(emax, dev);
    } else {
      int fbase = base;
      if (!a.laggard) {
        const int boff =
            COMPACT_DST ? a.boffs[t * n_win + n_win - 1] : a.boff_est;
        fbase = ils_clip(ils_mu(nb - 1, a.snum) + boff, 0, base_hi);
      }
      const int rel = e_ptr - fbase;
      if (rel >= 0 && rel < a.W) {
        store_pair(e_ptr, hi);
      } else if (CERTIFY) {
        viol = 1;
      }
    }
  }
  if (SIM_DEC) {
    const size_t o = env0 + (size_t)(n_win - 1) * ILS_LANES;
    a.dn[o] = dmin;
    a.dx[o] = dmax;
    if (!PACK) {
      a.en[o] = emin;
      a.ex[o] = emax;
    }
  }
  if (CERTIFY) a.viol[t * ILS_LANES + s] = viol;
}

extern "C" int ils_lengths_launch(const void* data, const void* tab,
                                  void* bits, void* dn, void* dx, void* en,
                                  void* ex, int n_tiles, int k, int snum,
                                  int rot, void* stream) {
  EncArgs a = {};
  a.data = (const uint32_t*)data;
  a.tab = (const int*)tab;
  a.bits = (int*)bits;
  a.dn = (int*)dn;
  a.dx = (int*)dx;
  a.en = (int*)en;
  a.ex = (int*)ex;
  a.k = k;
  a.snum = snum;
  a.rot = rot;
  a.G = 1;
  ils_encode_kernel<false, false, false>
      <<<n_tiles, ILS_LANES, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ils_pack_certify_launch(
    const void* data, const void* tab, void* pay, void* bits, void* dn,
    void* dx, void* viol, int n_tiles, int k, int snum, int rot, int G, int W,
    int cap_pairs, int boff_est, int laggard, long long stride_rows,
    void* stream) {
  EncArgs a = {};
  a.data = (const uint32_t*)data;
  a.tab = (const int*)tab;
  a.pay = (uint32_t*)pay;
  a.bits = (int*)bits;
  a.dn = (int*)dn;
  a.dx = (int*)dx;
  a.viol = (int*)viol;
  a.k = k;
  a.snum = snum;
  a.rot = rot;
  a.G = G;
  a.W = W;
  a.cap_pairs = cap_pairs;
  a.boff_est = boff_est;
  a.laggard = laggard;
  a.stride_rows = stride_rows;
  ils_encode_kernel<true, true, false>
      <<<n_tiles, ILS_LANES, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ils_pack_launch(const void* data, const void* tab,
                               const void* boffs, const void* row_starts,
                               void* pay, int n_tiles, int k, int snum,
                               int rot, int G, int W, int cap_pairs,
                               long long n_rows, void* stream) {
  EncArgs a = {};
  a.data = (const uint32_t*)data;
  a.tab = (const int*)tab;
  a.boffs = (const int*)boffs;
  a.row_starts = (const int*)row_starts;
  a.pay = (uint32_t*)pay;
  a.k = k;
  a.snum = snum;
  a.rot = rot;
  a.G = G;
  a.W = W;
  a.cap_pairs = cap_pairs;
  a.n_rows = n_rows;
  ils_encode_kernel<true, false, true>
      <<<n_tiles, ILS_LANES, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
