// K6: block bit packing, the encode side of paper section 3.
//
// Replaces src/repro/kernels/bitpack_pack.py::pack_blocks_padded
// (pl.pallas_call, body pack_kernel).  Grid K: one CTA of 128 threads per
// (32, 128) delta tile, one thread per lane.  Row r of width b starts at bit
// r*b of its lane: the thread ORs `val << sh` into word w = (r*b) >> 5 and,
// when the value spills (sh + b > 32), `val >> (32 - sh)` into word
// min(w + 1, 31), with uint32 arithmetic and word indices clamped to 31 as
// pack_kernel's dynamic indexing clamps them, so every width, 0 and 32
// included, packs bit for bit as the reference does.
//
// A lane's 32 words build up in its own column of a 16 KB shared tile
// (a register array indexed by the run-time word would live in local
// memory); no two threads touch one word, so no barrier is needed.  The
// tile is written out once, rows of 512 coalesced bytes.
//
// Bound on the card: device-memory bytes, K * 16 KB of deltas in and
// K * 16 KB of words out (plus 4 bytes of width a block).
#include "common.cuh"

using namespace repro;

namespace {
constexpr int kRows = 32;
}

__global__ void __launch_bounds__(kLanes)
pack_blocks_kernel(const uint32_t* __restrict__ deltas,
                   const int32_t* __restrict__ widths,
                   uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kRows][kLanes];
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kRows * kLanes;
  const uint32_t b = static_cast<uint32_t>(widths[blockIdx.x]);
#pragma unroll
  for (int w = 0; w < kRows; ++w) tile[w][tid] = 0u;
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    const uint32_t val = __ldg(deltas + base + r * kLanes + tid);
    const uint32_t start = static_cast<uint32_t>(r) * b;
    const uint32_t w = start >> 5;
    const uint32_t sh = start & 31u;
    tile[min(w, 31u)][tid] |= val << sh;
    if (sh + b > 32u) tile[min(w + 1u, 31u)][tid] |= val >> ((32u - sh) & 31u);
  }
#pragma unroll
  for (int w = 0; w < kRows; ++w) out[base + w * kLanes + tid] = tile[w][tid];
}

extern "C" int repro_pack_blocks(const void* deltas, const void* widths, int K,
                                 void* out, void* stream) {
  pack_blocks_kernel<<<K, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(deltas), static_cast<const int32_t*>(widths),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
