// Shared layout helpers for the ILS kernels (see core/ils_ref.py for the
// layout contract).  Payload and data are row-major (rows, ILS_LANES) u32:
// row r of a tile holds word r of all 1024 streams, so thread s of a tile
// touches column s only and a warp's accesses to one row are coalesced.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ILS_LANES 1024
#define ILS_WIN 64
#define ILS_ROT_SUB 3
#define ILS_ROT_LANE 5
// int32 envelope sentinels, as in the JAX kernels and ops/ils.py
// (certify_params subtracts them in int32, so they must stay +-2^30)
#define ILS_BIG (1 << 30)

// Flat word index that stream s reads in body row gi when the section is
// rotated: word ((sub - gi*ROT_SUB) % 8, (lane - gi*ROT_LANE) % 128).  The
// masks give the non-negative residue of a possibly negative difference.
__device__ __forceinline__ int ils_rot_src(int s, int gi) {
  int sub = s >> 7, lane = s & 127;
  int src_sub = (sub - ((gi * ILS_ROT_SUB) & 7)) & 7;
  int src_lane = (lane - ((gi * ILS_ROT_LANE) & 127)) & 127;
  return (src_sub << 7) | src_lane;
}

// Schedule position mu_i = (i * snum) >> 16 in pairs, in 64 bits: the
// product passes 2^31 once i >= 2^16 bodies at 8-bit codes (snum 2^15), as
// on the file path's first attempt at a ragged file (one tile of up to
// 2^18 bodies); the JAX kernels' int32 product wraps there.
__device__ __forceinline__ int ils_mu(int i, int snum) {
  return (int)(((long long)i * (long long)snum) >> 16);
}

__device__ __forceinline__ int ils_clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
