// One warp's work on one candidate block of a packed list: the body that K3
// (packed_gallop.cu) and K5 (packed_fold.cu) share.  Each kernel gives the
// warp one (row, candidate slot) of its grid and an epilogue that says what
// a lookup writes; everything else is this file's.
//
// Replaces, per candidate block, the decode-then-gallop of
// src/repro/kernels/intersect_gallop.py::packed_gallop_batched and of
// src/repro/kernels/megakernel.py::packed_fold_batched (both decode a row's
// C candidate blocks into one sorted VMEM window with
// bitunpack.py::decode_candidates and gallop every candidate over it).
//
// Warp (row, slot c):
//   1. id = blk[c].  A pad slot (id < 0 or id >= Kp) leaves at once and
//      writes nothing, except that slot 0 of a row with no real slot writes
//      false over the whole row.
//   2. Puts the block's packed words on the wire (cp.async, stage_block_words
//      of unpack_warp.cuh, K1's warp decode), then, while they fly, finds
//      with 32-ary warp searches (`warp_partition`: a __ballot_sync over 32
//      probes a round, 4 rounds at M = 2**19) the row's number of real slots
//      L, and in r the upper bounds s_c of hi(c-1), s_c+1 of hi(c) and u of
//      hi(L-1), where hi(c) = maxes[blk[c]]; with FastPFOR exceptions it
//      finds the block's position range in exc_pos the same way, zeroes its
//      tile and adds them there (atomicAdd; none read when E is 0).
//   3. Writes false over its share of the tail [u, M) (before the decode, so
//      that less is live across it): the candidates above every real block,
//      SENTINEL lanes included, cut into L chunks of whole 16-byte stores,
//      chunk c for slot c.
//   4. Decodes the block into its tile of shared memory (decode_staged_block,
//      seeded with maxes[id - 1], 0 for id 0, the patch added before the
//      prefix sum).
//   5. Owns the candidates r[i] for s_c <= i < s_c+1, i.e.
//      hi(c-1) < x <= hi(c) (hi(-1) = -inf): its lanes take them 32 at a
//      time; a candidate the epilogue does not skip gets a branchless lower
//      bound in the tile (ceil(log2(rows·128)) <= 12 rounds in shared
//      memory), and the epilogue is handed
//      member = tile[pos] == x && x != SENTINEL.
// So, within one row, the owned ranges [s_c, s_c+1) of the real slots tile
// [0, u) and the chunks tile [u, M): every out[i] is written by at most one
// lookup or one chunk.  Values compare as int32, as the gallop compares
// them (doc ids are below 2**31, SENTINEL is 2**31 - 1; the maxes arrive as
// int32 bit patterns of uint32).
//
// Why that is the membership the reference's gallop over the concatenated
// window finds: (i) r is strictly increasing, then SENTINEL, so the ranges
// are found by search; (ii) the real slots are a prefix of the row and their
// ids ascend; (iii) block id decodes to values in (maxes[id-1], maxes[id]].
// The window is then the ascending union of the blocks followed by SENTINEL
// pads.  An x with hi(c-1) < x <= hi(c) can equal a value of block c only,
// since the values of every other candidate block are <= hi(c-1) or
// > maxes[blk[c+1] - 1] >= hi(c); an x above hi(L-1) equals no block value,
// and SENTINEL is never a member.  The kernels' notes name the callers that
// give (i)-(iii).
//
// Bound on the card: a warp's chain of dependent loads (blk, the maxes, the
// searches' rounds; the words' copy overlaps the searches) and the decode's
// scans, not bytes.  The decoded block never leaves shared memory, a pad
// slot costs one load, and a lookup takes at most 12 rounds in shared
// memory.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "unpack_warp.cuh"

namespace repro {

constexpr int kPackedMaxWarps = 4;           // warps a CTA at most
constexpr int kPackedCtaSmem = 48 * 1024;    // shared memory a CTA at most

// Shared-memory bytes a warp at `rows`-row blocks (a stage and a tile of
// rows x 128 words), and warps a CTA: as many as fit in 48 KB, at most 4.
constexpr int packed_warp_bytes(int rows) { return 2 * rows * kLanes * 4; }

inline int packed_warps(int rows) {
  return max(1, min(kPackedMaxWarps, kPackedCtaSmem / packed_warp_bytes(rows)));
}

// For S searches over [0, n), each with a predicate before(s, j) that holds
// on a prefix of [0, n): pos[s] = the first j where it fails (n if none).
// Each round the 32 lanes probe 32 evenly spaced points of every open
// interval and a ballot counts the prefix, so an interval of length n
// shrinks to ceil(n / 32) - 1, one load a lane a search a round.  Every lane
// of the warp calls it and gets the same answer.
template <int S, class Before>
__device__ __forceinline__ void warp_partition(int n, Before before,
                                               int (&pos)[S]) {
  const int lane = threadIdx.x & 31;
  int hi[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    pos[s] = 0;
    hi[s] = n;
  }
  for (;;) {
    bool open = false;
#pragma unroll
    for (int s = 0; s < S; ++s) open |= hi[s] > pos[s];
    if (!open) break;
    bool t[S];
    int step[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int len = hi[s] - pos[s];
      step[s] = len > 0 ? (len + 31) >> 5 : 0;
      const int p = pos[s] + (lane + 1) * step[s] - 1;
      t[s] = len > 0 && p < hi[s] && before(s, p);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (step[s] == 0) continue;
      const int lo = pos[s] + __popc(__ballot_sync(0xFFFFFFFFu, t[s])) * step[s];
      hi[s] = min(lo + step[s] - 1, hi[s]);
      pos[s] = lo;
    }
  }
}

// The searches' predicates, each true on a prefix of its array.
struct RealSlot {              // blk[j] is a real block id: real slots lead
  const int32_t* blk;
  int Kp;
  __device__ __forceinline__ bool operator()(int, int j) const {
    const int id = blk[j];
    return id >= 0 && id < Kp;
  }
};

struct AtMost {                // r[j] <= key[s]: upper bounds in sorted r
  const int32_t* r;
  int32_t key[3];
  __device__ __forceinline__ bool operator()(int s, int j) const {
    return r[j] <= key[s];
  }
};

struct Below {                 // exc_pos[j] < key[s], with -1 as +infinity
  const int32_t* ep;
  long long key[2];
  __device__ __forceinline__ bool operator()(int s, int j) const {
    return ep[j] >= 0 && static_cast<long long>(ep[j]) < key[s];
  }
};

// false over row[a, e): byte stores up to a 16-byte boundary, 16-byte
// stores, byte stores after the last boundary.
__device__ __forceinline__ void fill_false(bool* row, long long a, long long e,
                                           int lane) {
  if (a >= e) return;
  char* p = reinterpret_cast<char*>(row);
  const long long head =
      min(e - a, static_cast<long long>(
                     (16 - (reinterpret_cast<uintptr_t>(p + a) & 15)) & 15));
  if (lane < head) p[a + lane] = 0;
  a += head;
  const long long n16 = (e - a) >> 4;
  uint4* q = reinterpret_cast<uint4*>(p + a);
  for (long long i = lane; i < n16; i += 32) q[i] = make_uint4(0u, 0u, 0u, 0u);
  a += n16 << 4;
  if (lane < e - a) p[a + lane] = 0;
}

// One row of a packed candidate stack, as the warps of its slots read it:
// the row's M candidates and mask, its list's (Tp, 128) words, (Kp,) block
// metadata, (C,) candidate block ids and (E,) exceptions.
struct PackedRow {
  const int32_t* r;
  bool* out;
  const uint32_t* words;
  const int32_t* widths;
  const int32_t* offsets;
  const int32_t* maxes;
  const int32_t* blk;
  const int32_t* exc_pos;
  const uint32_t* exc_add;
  int M, Tp, Kp, C, E, rows;
};

// Steps 1-5 for slot c of row p; `stage` is this warp's 2 x rows x 32 uint4
// of shared memory (the staged words, then the tile).  The epilogue has
// skip(i) (no lookup for candidate i) and put(out, i, member).  All 32 lanes
// of the warp call it.
template <int MODE, class Epilogue>
__device__ __forceinline__ void packed_slot(const PackedRow& p, int c,
                                            uint4* stage, const Epilogue& epi) {
  const int lane = threadIdx.x & 31;
  const RealSlot real{p.blk, p.Kp};
  const int id = p.blk[c];
  if (id < 0 || id >= p.Kp) {           // a pad slot writes nothing ...
    if (c == 0) fill_false(p.out, 0, p.M, lane);   // ... unless the row has none
    return;
  }
  const int rows = p.rows;
  const int per = rows * kLanes;
  uint32_t* tile = reinterpret_cast<uint32_t*>(stage + rows * 32);
  const int width = p.widths[id];
  const long long offset = p.offsets[id];
  stage_block_words(p.words, p.Tp, offset, width, rows, stage);

  // while the words fly: L, the three upper bounds in r, the tail, the
  // exceptions
  int L[1];
  warp_partition<1>(p.C, real, L);
  const int last = max(L[0], 1) - 1;            // the last real slot
  const AtMost at_most{p.r, {c > 0 ? p.maxes[p.blk[c - 1]] : INT_MIN,
                             p.maxes[id],
                             real(0, last) ? p.maxes[p.blk[last]] : INT_MAX}};
  int ub[3];
  warp_partition<3>(p.M, at_most, ub);
  const int s_lo = c > 0 ? ub[0] : 0, s_hi = ub[1];
  {  // this slot's chunk of the tail [u, M), 32-bit division
    const int u = ub[2], nl = max(L[0], 1);
    const int share = ((p.M - u + nl - 1) / nl + 15) & ~15;
    const long long a = u + static_cast<long long>(c) * share;
    fill_false(p.out, a, min(a + share, static_cast<long long>(p.M)), lane);
  }
  const uint32_t seed = id > 0 ? static_cast<uint32_t>(p.maxes[id - 1]) : 0u;
  bool patched = false;
  if (p.E > 0) {
    const long long lo_pos = static_cast<long long>(id) * per;
    int ex[2];
    warp_partition<2>(p.E, Below{p.exc_pos, {lo_pos, lo_pos + per}}, ex);
    if (ex[1] > ex[0]) {                       // uniform across the warp
      uint4* tile4 = reinterpret_cast<uint4*>(tile);
      for (int row = 0; row < rows; ++row)
        tile4[row * 32 + lane] = make_uint4(0u, 0u, 0u, 0u);
      __syncwarp();
      for (int j = ex[0] + lane; j < ex[1]; j += 32)
        atomicAdd(&tile[p.exc_pos[j] - lo_pos], p.exc_add[j]);
      __syncwarp();
      patched = true;
    }
  }
  decode_staged_block<MODE>(p.words, p.Tp, offset, width, seed, rows, stage,
                            tile, patched);
  __syncwarp();                                // lanes read the whole tile

  // the owned candidates, a lower bound each in the tile
  int rounds = 0;
  while ((1 << rounds) < per) ++rounds;
  const int32_t* ts = reinterpret_cast<const int32_t*>(tile);
  for (int i = s_lo + lane; i < s_hi; i += 32) {
    if (epi.skip(i)) continue;
    const int32_t x = p.r[i];
    int lo = -1;
    for (int k = rounds - 1; k >= 0; --k) {
      const int probe = lo + (1 << k);
      lo = (probe < per && ts[min(probe, per - 1)] < x) ? probe : lo;
    }
    epi.put(p.out, i, ts[min(lo + 1, per - 1)] == x && x != kSentinel);
  }
}

}  // namespace repro
