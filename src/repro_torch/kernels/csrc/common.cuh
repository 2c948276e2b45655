// Shared device code: the lane count, SENTINEL and the delta modes (K1-K7),
// and `unpack_lane`, the width-generic unpack of one lane of one row, which
// the warp decode of K1, K3 and K5 (unpack_warp.cuh) runs for widths outside
// 0-32, reading the words straight from global memory.
//
// Replaces the lane unpack of src/repro/kernels/bitunpack.py
// (`make_unpack_kernel`, via core.bitpack's unpack_deltas): word
// (r*b) >> 5 of the lane, and the next word when the value spills, shifted
// and masked, word indices clamped to [0, T-1].
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kLanes = 128;
constexpr int32_t kSentinel = 0x7FFFFFFF;
enum Mode : int { kNone = 0, kD1 = 1, kD2 = 2, kD4 = 3, kDM = 4, kDV = 5 };

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

}  // namespace repro
