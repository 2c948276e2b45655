// compact_rows: the surviving values of each row of a batch, moved to the
// front of a narrow row on the card, with their count.
//
// Replaces no TPU kernel.  The reference's batched program returns each seed
// row whole, SENTINEL where a value did not survive, and leaves the
// extraction to the host (src/repro/index/batch.py, `_svs_program` and
// `collect_batch`).  On the card that made the host copy and scan M-wide rows
// (M up to 2**20) for a few hundred answers each; this kernel makes the copy
// and the host's read the size of the answer, capped at the caller's
// `max_results`.
//
// In: r (B, M) int32, valid (B, M) bool.  Out: (B, C + 1) int32, C <= M:
// each row's first min(count, C) values of r where valid, in order, SENTINEL
// in the columns after them, and the full count in column C.
//
// Bound: it reads `valid` (1 B a slot; the second kernel reads it again,
// from L2) and r only in the 16-byte groups that hold a survivor (at most
// 4 B a slot), and writes 4·(C + 1) B a row: memory, about 1.6 µs at B 1,
// M 2**20, C 2**16 (5.2 MB at 3.35 TB/s) when every group holds a survivor,
// under 0.5 µs at the main path's densities (10**-4 to 10**-2).  At those
// sizes two dependent launches, not bytes, set its time.
//
// Design: a row is tiled across many blocks (4,096 slots a block, so a
// single row of 2**20 fills the card with 256 blocks), in two launches that
// share the tiling (reduce, then scan):
//   count_tiles    each block counts its tile's survivors into `counts`;
//   compact_tiles  each block sums the counts of its row's earlier tiles
//                  (and all of them, the row's total) from L2, counts its
//                  survivors again with three warp ballots a round (on the
//                  bits of each lane's count of 0-4), scans the 32
//                  (round, warp) counts in one warp, and writes its
//                  survivors below C, its share of the SENTINEL tail
//                  [total, C) and, tile 0, the count.
// No block waits on another, so nothing depends on the order in which the
// card schedules blocks, and `counts` needs no clearing: every entry is
// written before it is read.  A single-pass decoupled look-back (one 64-bit
// status word a tile, cleared by a memset) took 6.9-10.3 µs of graph time
// at B 1-3, M 2**18-2**20, where this takes 5.6-8.0, and as long at B 13,
// M 2**16 (PERF.md §6).  Nothing here synchronises.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::kSentinel;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                            // slots a thread takes a round
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kVec * kRounds;   // 4096 slots a block
static_assert(kRounds * kWarps == 32, "one warp scans the (round, warp) counts");

// Bit j: slot s + j of the row at `row` survives.  `vec`: the row's slots
// come 4 to an aligned word (M % 4 == 0, aligned base).
__device__ __forceinline__ unsigned slot_mask(const uint8_t* __restrict__ valid,
                                              long long row, int s, int M,
                                              bool vec) {
  unsigned m = 0;
  if (vec) {
    if (s < M) {
      const unsigned f = *reinterpret_cast<const unsigned*>(valid + row + s);
#pragma unroll
      for (int j = 0; j < kVec; ++j) m |= ((f >> (8 * j)) & 0xffu ? 1u : 0u) << j;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      m |= (s + j < M && valid[row + s + j] ? 1u : 0u) << j;
  }
  return m;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) count_tiles(
    const uint8_t* __restrict__ valid, int M, int tiles, bool vec,
    int* __restrict__ counts) {
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const long long row = static_cast<long long>(b) * M;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kRounds; ++k)
    c += __popc(slot_mask(valid, row, t * kTile + (k * kThreads + tid) * kVec, M, vec));
  c = warp_sum(c);
  if (lane == 0) s_warp[warp] = c;
  __syncthreads();
  if (tid < 32) {
    c = warp_sum(lane < kWarps ? s_warp[lane] : 0);
    if (lane == 0) counts[blockIdx.x] = c;
  }
}

__global__ void __launch_bounds__(kThreads) compact_tiles(
    const int32_t* __restrict__ r, const uint8_t* __restrict__ valid, int M,
    int C, int tiles, bool vec, const int* __restrict__ counts,
    int32_t* __restrict__ out) {
  __shared__ int s_scan[32];       // survivors a (round, warp), then their scan
  __shared__ int s_before[kWarps], s_total[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const long long row = static_cast<long long>(b) * M;

  // the survivors of the row's tiles before this one, and of all of them
  int before_tile = 0, total = 0;
  for (int i = tid; i < tiles; i += kThreads) {
    const int v = counts[static_cast<long long>(b) * tiles + i];
    total += v;
    before_tile += i < t ? v : 0;
  }
  before_tile = warp_sum(before_tile);
  total = warp_sum(total);
  if (lane == 0) {
    s_before[warp] = before_tile;
    s_total[warp] = total;
  }

  // Each round a thread takes kVec neighbouring slots; r is read only where
  // one of them survives.  Slot order is (round, warp, lane, j).
  int vals[kRounds][kVec];
  unsigned mask[kRounds];
  int before[kRounds];             // survivors of the lanes before this one
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int s = t * kTile + (k * kThreads + tid) * kVec;
    const unsigned m = slot_mask(valid, row, s, M, vec);
    mask[k] = m;
    if (m && vec) {
      const int4 q = *reinterpret_cast<const int4*>(r + row + s);
      vals[k][0] = q.x; vals[k][1] = q.y; vals[k][2] = q.z; vals[k][3] = q.w;
    } else if (m) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[k][j] = (m >> j) & 1u ? r[row + s + j] : 0;
    }
    const int c = __popc(m);
    const unsigned b0 = __ballot_sync(0xffffffffu, c & 1);
    const unsigned b1 = __ballot_sync(0xffffffffu, c & 2);
    const unsigned b2 = __ballot_sync(0xffffffffu, c & 4);
    const unsigned lt = (1u << lane) - 1u;
    before[k] = __popc(b0 & lt) + 2 * __popc(b1 & lt) + 4 * __popc(b2 & lt);
    if (lane == 0) s_scan[k * kWarps + warp] = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
  }
  __syncthreads();
  if (warp == 0) {
    const int own = s_scan[lane];
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    s_scan[lane] = incl - own;
  }
  __syncthreads();

  int excl = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    excl += s_before[w];
    total += s_total[w];
  }
  int32_t* orow = out + static_cast<long long>(b) * (C + 1);
  if (excl < C) {
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      int p = excl + s_scan[k * kWarps + warp] + before[k];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if ((mask[k] >> j) & 1u) {
          if (p < C) orow[p] = vals[k][j];
          ++p;
        }
      }
    }
  }
  // this tile's share of the SENTINEL tail [total, C), and the count
  const int share = (C + tiles - 1) / tiles;
  const int hi = min((t + 1) * share, C);
  for (int i = max(t * share, total) + tid; i < hi; i += kThreads) orow[i] = kSentinel;
  if (t == 0 && tid == 0) orow[C] = total;
}

}  // namespace

// r, valid, B, M, C, out, counts (B·ceil(M / 4096) int32), stream.
extern "C" int repro_compact_rows(const void* r, const void* valid, int B,
                                  int M, int C, void* out, void* counts,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = (M + kTile - 1) / kTile;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * tiles);
  const bool vec = M % kVec == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  count_tiles<<<blocks, kThreads, 0, s>>>(static_cast<const uint8_t*>(valid), M,
                                          tiles, vec, static_cast<int*>(counts));
  compact_tiles<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(r), static_cast<const uint8_t*>(valid), M, C,
      tiles, vec, static_cast<const int*>(counts), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
