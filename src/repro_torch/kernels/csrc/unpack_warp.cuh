// Warp-per-block integrated unpack + prefix sum (paper Algorithm 1): K1's
// Hopper design (unpack_blocks.cu), which K3 (packed_gallop.cu) and K5
// (packed_fold.cu) run too, through packed_warp.cuh, decoding each candidate
// block into shared memory; K7 (svb_decode.cu) shares its per-row-group
// prefix sum (`prefix_rows`) and scans.
//
// Replaces the per-block body of src/repro/kernels/bitunpack.py
// (make_unpack_kernel).  One warp decodes one block of `rows` x 128 values:
//   1. Its packed words go on the wire at once (`stage_block_words`): lane t
//      issues one 16-byte cp.async per word row of the block, columns
//      4t..4t+3 of that row, into the warp's slice of shared memory (at most
//      `rows` word rows for widths 0-32; each row's index clamped to
//      [0, T-1] as unpack_lane clamps it).  A lane reads back only the
//      columns it copied, so the wait needs no barrier.
//   2. For each row, lane t unpacks lanes 4t..4t+3 with unpack_lane's shift,
//      mask and spill rules, adds the FastPFOR patch where the caller gives
//      one (`patched`: `out` already holds rows x 128 deltas to add before
//      the prefix sum; K3 zeroes its tile and adds the exceptions there, and
//      a lane reads and then overwrites only its own lanes 4t..4t+3, so the
//      patch costs no extra shared memory), runs the mode's prefix sum over
//      them (`prefix_rows`: 4 local adds, a 5-step __shfl_up_sync scan of the
//      thread totals, the row total from lane 31 as the carry), and stores 16
//      bytes, so each row is one coalesced 512-byte store.  Rows go in groups
//      of kRowGroup whose scans are independent, so their shuffle chains
//      overlap and only the carries run in row order: at small K, where one
//      warp's chain is the kernel's time, a block costs about 4 scan
//      latencies, not 32.  There is no __syncthreads: the 32 serial
//      load-and-barrier rounds of the CTA-per-block decode become one wait.
// Per mode:
//   none  the values themselves
//   dv    four per-lane running sums down the rows
//   dm    the row plus a carry that grows by lane 127's delta each row
//   d1    the 128-lane inclusive scan plus the row carry
//   d2/d4 the same per phase: a thread's four lanes are phases 0,1,0,1 (two
//         scans) or 0,1,2,3 (four scans), each phase with its own carry
// Every add is on uint32_t, wrapping mod 2**32 as the reference's uint32
// cumsums.  A width outside 0-32 (never written by the encoders) reads its
// words straight from global memory, as unpack_lane does.
//
// Bound on the card: device-memory bytes (each packed word read once, each
// 4-byte value written once).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {

constexpr int kUnpackWarps = 4;   // blocks a CTA; bitunpack.WARPS mirrors it
constexpr int kRowGroup = 8;      // rows whose scans overlap

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Inclusive warp scans of G independent values (G rows of a group), their
// shuffles interleaved so that the G chains overlap.
template <int G>
__device__ __forceinline__ void warp_scans(uint32_t (&x)[G], int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x[g], off);
      if (lane >= off) x[g] += y;
    }
  }
}

// Lane 31's value of each of G scans: the rows' totals.
template <int G>
__device__ __forceinline__ void row_totals(const uint32_t (&x)[G],
                                           uint32_t (&tot)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) tot[g] = __shfl_sync(0xFFFFFFFFu, x[g], 31);
}

// Lanes 4t..4t+3 of row r from the staged word rows (widths 0-32).
__device__ __forceinline__ uint4 unpack4(const uint4* stage, int b, int r,
                                         int lane) {
  if (b == 0) return make_uint4(0u, 0u, 0u, 0u);
  const int start = r * b;
  const int w = start >> 5;
  const uint32_t sh = static_cast<uint32_t>(start & 31);
  const uint4 lo = stage[w * 32 + lane];
  uint4 v = make_uint4(lo.x >> sh, lo.y >> sh, lo.z >> sh, lo.w >> sh);
  if (sh + static_cast<uint32_t>(b) > 32u) {   // the value spills: word w + 1
    const uint4 hi = stage[(w + 1) * 32 + lane];
    const uint32_t up = (32u - sh) & 31u;
    v.x |= hi.x << up;
    v.y |= hi.y << up;
    v.z |= hi.z << up;
    v.w |= hi.w << up;
  }
  const uint32_t mask = b >= 32 ? 0xFFFFFFFFu : ((1u << b) - 1u);
  v.x &= mask;
  v.y &= mask;
  v.z &= mask;
  v.w &= mask;
  return v;
}

// The mode's prefix sum over G rows of one warp: t[g] holds this lane's
// deltas of row g (lanes 4t..4t+3), v[g] gets their values; c0..c3 are the
// carries (per phase; per lane for dv), advanced past the G rows.  A row past
// the block's end must hold zero deltas, so that it adds to no carry.  K1,
// K3 and K7 all run it.
template <int MODE, int G>
__device__ __forceinline__ void prefix_rows(uint4 (&t)[G], uint4 (&v)[G],
                                            uint32_t& c0, uint32_t& c1,
                                            uint32_t& c2, uint32_t& c3,
                                            int lane) {
  if constexpr (MODE == kNone) {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = t[g];
  } else if constexpr (MODE == kDV) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      c0 += t[g].x; c1 += t[g].y; c2 += t[g].z; c3 += t[g].w;
      v[g] = make_uint4(c0, c1, c2, c3);
    }
  } else if constexpr (MODE == kDM) {
    uint32_t last[G];
#pragma unroll
    for (int g = 0; g < G; ++g)   // lane 127's delta
      last[g] = __shfl_sync(0xFFFFFFFFu, t[g].w, 31);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[g] = make_uint4(t[g].x + c0, t[g].y + c0, t[g].z + c0, t[g].w + c0);
      c0 += last[g];
    }
  } else if constexpr (MODE == kD1) {
    uint32_t x[G], tot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      t[g].y += t[g].x;                     // the thread's 4 local sums
      t[g].z += t[g].y;
      t[g].w += t[g].z;
      x[g] = t[g].w;
    }
    warp_scans(x, lane);
    row_totals(x, tot);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint32_t before = c0 + (x[g] - t[g].w);
      v[g] = make_uint4(before + t[g].x, before + t[g].y, before + t[g].z,
                        before + t[g].w);
      c0 += tot[g];
    }
  } else if constexpr (MODE == kD2) {
    // phase 0: lanes 4t, 4t+2; phase 1: lanes 4t+1, 4t+3
    uint32_t xa[G], xe[G], ta[G], te[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      t[g].z += t[g].x;
      t[g].w += t[g].y;
      xa[g] = t[g].z;
      xe[g] = t[g].w;
    }
    warp_scans(xa, lane);
    warp_scans(xe, lane);
    row_totals(xa, ta);
    row_totals(xe, te);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint32_t ba = c0 + (xa[g] - t[g].z), be = c1 + (xe[g] - t[g].w);
      v[g] = make_uint4(ba + t[g].x, be + t[g].y, ba + t[g].z, be + t[g].w);
      c0 += ta[g];
      c1 += te[g];
    }
  } else {  // kD4: each of the four lanes is its own phase
    uint32_t x0[G], x1[G], x2[G], x3[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      x0[g] = t[g].x; x1[g] = t[g].y; x2[g] = t[g].z; x3[g] = t[g].w;
    }
    warp_scans(x0, lane);
    warp_scans(x1, lane);
    warp_scans(x2, lane);
    warp_scans(x3, lane);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[g] = make_uint4(c0 + x0[g], c1 + x1[g], c2 + x2[g], c3 + x3[g]);
      c0 += __shfl_sync(0xFFFFFFFFu, x0[g], 31);
      c1 += __shfl_sync(0xFFFFFFFFu, x1[g], 31);
      c2 += __shfl_sync(0xFFFFFFFFu, x2[g], 31);
      c3 += __shfl_sync(0xFFFFFFFFu, x3[g], 31);
    }
  }
}

// Step 1 of a block's decode: put its word rows on the wire (widths 0-32;
// another width reads global memory in step 2).  `stage` is this warp's
// `rows` x 32 uint4 of shared memory.
__device__ __forceinline__ void stage_block_words(
    const uint32_t* __restrict__ words, int T, long long offset, int b,
    int rows, uint4* stage) {
  if (b < 0 || b > 32) return;
  const int lane = threadIdx.x & 31;
  const int nw = (rows * b + 31) >> 5;          // word rows the block spans
  for (int j = 0; j < nw; ++j) {
    long long w = offset + j;
    w = w < 0 ? 0 : (w > T - 1 ? T - 1 : w);
    cp_async16(stage + j * 32 + lane, words + w * kLanes + 4 * lane);
  }
}

// Step 2: wait for the staged words and decode the block into
// out[r * 128 + lane], adding the patch that `out` holds where `patched`.
// All 32 lanes of the warp call it, with the arguments of step 1.
template <int MODE>
__device__ __forceinline__ void decode_staged_block(
    const uint32_t* __restrict__ words, int T, long long offset, int b,
    uint32_t seed, int rows, const uint4* stage, uint32_t* __restrict__ out,
    bool patched) {
  const int lane = threadIdx.x & 31;
  const bool staged = b >= 0 && b <= 32;
  if (staged) cp_async_wait_all();
  uint32_t c0 = seed, c1 = seed, c2 = seed, c3 = seed;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  // rows past `rows` in the last group unpack as 0 and are not stored
  for (int r0 = 0; r0 < rows; r0 += kRowGroup) {
    uint4 t[kRowGroup];
#pragma unroll
    for (int g = 0; g < kRowGroup; ++g) {
      const int r = r0 + g;
      if (r >= rows) {
        t[g] = make_uint4(0u, 0u, 0u, 0u);
      } else if (staged) {
        t[g] = unpack4(stage, b, r, lane);
      } else {
        t[g] = make_uint4(unpack_lane(words, T, offset, b, r, 4 * lane),
                          unpack_lane(words, T, offset, b, r, 4 * lane + 1),
                          unpack_lane(words, T, offset, b, r, 4 * lane + 2),
                          unpack_lane(words, T, offset, b, r, 4 * lane + 3));
      }
      if (patched && r < rows) {              // the FastPFOR exceptions
        const uint4 p = out4[r * 32 + lane];
        t[g].x += p.x; t[g].y += p.y; t[g].z += p.z; t[g].w += p.w;
      }
    }
    uint4 v[kRowGroup];
    prefix_rows<MODE, kRowGroup>(t, v, c0, c1, c2, c3, lane);
#pragma unroll
    for (int g = 0; g < kRowGroup; ++g)
      if (r0 + g < rows) out4[(r0 + g) * 32 + lane] = v[g];
  }
}

// Decode one block into out[r * 128 + lane] (steps 1 and 2); all 32 lanes
// of the warp call it.  `stage` is this warp's `rows` x 32 uint4 of shared
// memory.
template <int MODE>
__device__ __forceinline__ void decode_block_warp(
    const uint32_t* __restrict__ words, int T, long long offset, int b,
    uint32_t seed, int rows, uint4* stage, uint32_t* __restrict__ out) {
  stage_block_words(words, T, offset, b, rows, stage);
  decode_staged_block<MODE>(words, T, offset, b, seed, rows, stage, out,
                            false);
}

}  // namespace repro
