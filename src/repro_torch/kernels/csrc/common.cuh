// Shared device code of the decode kernels: the width-generic lane unpack
// and `decode_block`, the per-block integrated unpack + prefix sum (paper
// Algorithm 1) that K1 (unpack_blocks.cu) and K3's decode launch
// (packed_gallop.cu) both run.
//
// Replaces the per-block body of src/repro/kernels/bitunpack.py
// (`make_unpack_kernel`, and `decode_candidates` via core.bitpack's
// unpack_deltas + core.deltas' prefix_sum).
//
// One CTA of 128 threads decodes one block, one thread per lane, looping
// over the block's rows.  Per row each thread loads word (r*b)>>5 of its
// lane (and the next word when the value spills), shifts and masks, then
// applies the mode's prefix sum in the same pass:
//   none  the value itself
//   dv    a running sum per thread (per lane, down the rows)
//   dm    the row plus a carry that grows by lane 127's delta each row
//   d1    a 128-lane inclusive scan: warp __shfl_up_sync scan, a 4-warp
//         combine through shared memory, plus the row carry
//   d2/d4 the same scan over the lanes of one phase (lane mod s)
// Every add is on uint32_t, so sums wrap mod 2**32 exactly as the reference's
// uint32 cumsums.  The TPU kernel's VMEM carry becomes registers and 68 bytes
// of shared memory.
//
// Bound on the card: device-memory bytes (each packed word read once, each
// 4-byte value written once); a thread does a few dozen integer operations
// per value.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kLanes = 128;
constexpr int32_t kSentinel = 0x7FFFFFFF;
enum Mode : int { kNone = 0, kD1 = 1, kD2 = 2, kD4 = 3, kDM = 4, kDV = 5 };

struct ScanScratch {
  uint32_t warp_sum[4][4];  // [warp][phase]: one row's warp totals per phase
  uint32_t last;            // dm: lane 127's delta of one row
};

// Row r, lane `lane` of a block whose `b`-bit words start at row `offset`
// of the flat (T, 128) word array.  Word indices clamp to [0, T-1] as in the
// reference's unpack_deltas.
__device__ __forceinline__ uint32_t unpack_lane(const uint32_t* __restrict__ words,
                                                int T, long long offset, int b,
                                                int r, int lane) {
  const long long start = static_cast<long long>(r) * b;
  const long long w = start >> 5;
  const uint32_t sh = static_cast<uint32_t>(start & 31);
  const uint32_t ub = static_cast<uint32_t>(b);
  long long ilo = offset + w;
  ilo = ilo < 0 ? 0 : (ilo > T - 1 ? T - 1 : ilo);
  uint32_t v = __ldg(words + ilo * kLanes + lane) >> sh;
  if (sh + ub > 32u) {
    long long ihi = offset + w + 1;
    ihi = ihi < 0 ? 0 : (ihi > T - 1 ? T - 1 : ihi);
    v |= __ldg(words + ihi * kLanes + lane) << ((32u - sh) & 31u);
  }
  const uint32_t mask = b >= 32 ? 0xFFFFFFFFu : ((1u << min(ub, 31u)) - 1u);
  return v & mask;
}

// Decode one block of `rows` x 128 values into out[r * 128 + lane].
// `patch` (rows x 128 deltas to add before the prefix sum, FastPFOR
// exceptions) may be null.  All 128 threads of the CTA must call it.
template <int MODE>
__device__ __forceinline__ void decode_block(const uint32_t* __restrict__ words,
                                             int T, long long offset, int b,
                                             uint32_t seed, int rows,
                                             const uint32_t* patch,
                                             uint32_t* __restrict__ out,
                                             ScanScratch& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t carry = seed;
  for (int r = 0; r < rows; ++r) {
    uint32_t t = unpack_lane(words, T, offset, b, r, tid);
    if (patch != nullptr) t += patch[r * kLanes + tid];
    uint32_t v;
    if constexpr (MODE == kNone) {
      v = t;
    } else if constexpr (MODE == kDV) {
      carry += t;
      v = carry;
    } else if constexpr (MODE == kDM) {
      if (tid == kLanes - 1) s.last = t;
      __syncthreads();
      v = t + carry;
      carry += s.last;
      __syncthreads();
    } else {
      constexpr int S = MODE == kD1 ? 1 : (MODE == kD2 ? 2 : 4);
      uint32_t x = t;
#pragma unroll
      for (int off = S; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, off);
        if (lane >= off) x += y;
      }
      // lanes 32-S .. 31 hold the warp's inclusive total of each phase
      if (lane >= 32 - S) s.warp_sum[warp][lane - (32 - S)] = x;
      __syncthreads();
      const int p = lane & (S - 1);
      uint32_t before = 0u, total = 0u;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t ws = s.warp_sum[w][p];
        before += (w < warp) ? ws : 0u;
        total += ws;
      }
      v = carry + before + x;
      carry += total;
      __syncthreads();
    }
    out[r * kLanes + tid] = v;
  }
}

}  // namespace repro
