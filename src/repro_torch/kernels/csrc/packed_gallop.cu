// K3: skip-aware packed gallop in one launch — each candidate block of a
// row's compressed list is decoded by one warp into its shared memory, and
// the row's candidates that can only lie in that block are searched there.
//
// Replaces src/repro/kernels/intersect_gallop.py::packed_gallop_batched
// (pl.pallas_call, body make_packed_gallop_kernel, with
// bitunpack.py::decode_candidates), which decodes a row's C candidate blocks
// into one sorted VMEM window and gallops every candidate over it.
//
// Grid (ceil(C / warps), B), one warp per (row b, slot c), `warps` warps a
// CTA (the launch picks them so that a CTA's shared memory stays at or under
// 48 KB: one at 32-row blocks, four at 8), and no CTA barrier.  Warp (b, c):
//   1. id = blk[b, c].  A pad slot (id < 0 or id >= Kp) leaves at once and
//      writes nothing, except that slot 0 of a row with no real slot writes
//      false over the whole row.
//   2. Puts the block's packed words on the wire (cp.async, stage_block_words
//      of unpack_warp.cuh, K1's warp decode), then, while they fly, finds
//      with 32-ary warp searches (`warp_partition`: a __ballot_sync over 32
//      probes a round, 4 rounds at M = 2**19) the row's number of real slots
//      L, and in r the upper bounds s_c of hi(c-1), s_c+1 of hi(c) and u of
//      hi(L-1), where hi(c) = maxes[b, blk[b, c]]; with FastPFOR exceptions
//      it finds the block's position range in exc_pos the same way, zeroes
//      its tile and adds them there (atomicAdd; none read when E is 0).
//   3. Decodes the block into its tile of shared memory (decode_staged_block,
//      seeded with maxes[b, id - 1], 0 for id 0, the patch added before the
//      prefix sum).
//   4. Owns the candidates r[b, i] for s_c <= i < s_c+1, i.e.
//      hi(c-1) < x <= hi(c) (hi(-1) = -inf): its lanes take them 32 at a
//      time, each a branchless lower bound in the tile (ceil(log2(rows·128))
//      <= 12 rounds in shared memory) and writes
//      tile[pos] == x && x != SENTINEL.
//   5. Writes false over its share of the tail [u, M) (before step 3, so
//      that less is live across the decode): the candidates above every
//      real block, SENTINEL lanes included, cut into L chunks of whole
//      16-byte stores, chunk c for slot c.
// So every out[b, i] has exactly one writer: the ranges [s_c, s_c+1) of the
// real slots tile [0, u), and the chunks tile [u, M).  Values compare as
// int32, as the gallop compares them (doc ids are below 2**31, SENTINEL is
// 2**31 - 1; the maxes arrive as int32 bit patterns of uint32).
//
// Why this equals the reference's gallop over the concatenated window, for
// every caller: (i) r's valid prefix is strictly increasing, then SENTINEL
// (engine._packed_probe passes the compacted candidate buffer), so r is
// sorted and the ranges are found by search; (ii) the real slots are a
// prefix of the row, their ids ascend, and block id decodes to values in
// (maxes[id-1], maxes[id]] (the encoders' lists are strictly increasing), so
// the window is the ascending union of the blocks followed by SENTINEL pads.
// An x with hi(c-1) < x <= hi(c) can then equal a value of block c only,
// since the values of every other candidate block are <= hi(c-1) or
// > maxes[blk[c+1] - 1] >= hi(c); an x above hi(L-1) equals no block value,
// and SENTINEL is never a member.  Membership in block c is what the
// gallop's lower bound over the window finds.
//
// Bound on the card: bytes — the candidate blocks' packed words and
// metadata, their exceptions, r and the mask (launch/kernel_times.py's
// time_k3).  A decoded window in device memory would cost more than that
// whole bound: at the main path's C = 1024 x 32 rows it is 16.8 MB written
// and read back, half of it pad slots, and a gallop over it takes 22
// dependent rounds.  Here the decoded blocks never leave shared memory, pad
// slots cost a load, a lookup takes at most 12 rounds in shared memory, and
// a warp's dependent global loads (the searches) overlap its words' copy.
#include <climits>
#include <cstdint>

#include "unpack_warp.cuh"

using namespace repro;

namespace {

constexpr int kMaxWarps = 4;                 // warps a CTA at most
constexpr int kCtaSmem = 48 * 1024;          // shared memory a CTA at most

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

// At least one CTA an SM is all the launch bound asks of the register
// allocator: with the thread count alone, ptxas aimed at 64-72 registers and
// spilled 4 bytes in some modes; so it takes 79-117, and shared memory (32 KB
// a warp at 32 rows) bounds the warps an SM holds before registers do.
template <int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
packed_gallop_kernel(const int32_t* __restrict__ r, int M,
                     const uint32_t* __restrict__ words, int Tp,
                     const int32_t* __restrict__ widths,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ maxes, int Kp,
                     const int32_t* __restrict__ blk, int C,
                     const int32_t* __restrict__ exc_pos,
                     const uint32_t* __restrict__ exc_add, int E, int rows,
                     bool* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * warps + warp;
  if (c >= C) return;
  const int b = blockIdx.y;
  const int32_t* rb = r + static_cast<size_t>(b) * M;
  bool* ob = out + static_cast<size_t>(b) * M;
  const int32_t* bb = blk + static_cast<size_t>(b) * C;
  const int32_t* mb = maxes + static_cast<size_t>(b) * Kp;
  const RealSlot real{bb, Kp};
  const int id = bb[c];
  if (id < 0 || id >= Kp) {             // a pad slot writes nothing ...
    if (c == 0) fill_false(ob, 0, M, lane);   // ... unless the row has none
    return;
  }
  const size_t kb = static_cast<size_t>(b) * Kp;
  const int per = rows * kLanes;
  uint4* stage = smem + static_cast<size_t>(warp) * 2 * rows * 32;
  uint32_t* tile = reinterpret_cast<uint32_t*>(stage + rows * 32);
  const uint32_t* wb = words + static_cast<size_t>(b) * Tp * kLanes;
  const int width = widths[kb + id];
  const long long offset = offsets[kb + id];
  stage_block_words(wb, Tp, offset, width, rows, stage);

  // while the words fly: L, the three upper bounds in r, the tail, the
  // exceptions
  int L[1];
  warp_partition<1>(C, real, L);
  const int last = max(L[0], 1) - 1;            // the last real slot
  const AtMost at_most{rb, {c > 0 ? mb[bb[c - 1]] : INT_MIN, mb[id],
                            real(0, last) ? mb[bb[last]] : INT_MAX}};
  int ub[3];
  warp_partition<3>(M, at_most, ub);
  const int s_lo = c > 0 ? ub[0] : 0, s_hi = ub[1];
  {  // this slot's chunk of the tail [u, M), 32-bit division
    const int u = ub[2], nl = max(L[0], 1);
    const int share = ((M - u + nl - 1) / nl + 15) & ~15;
    const long long a = u + static_cast<long long>(c) * share;
    fill_false(ob, a, min(a + share, static_cast<long long>(M)), lane);
  }
  const uint32_t seed = id > 0 ? static_cast<uint32_t>(mb[id - 1]) : 0u;
  bool patched = false;
  if (E > 0) {
    const int32_t* ep = exc_pos + static_cast<size_t>(b) * E;
    const uint32_t* ea = exc_add + static_cast<size_t>(b) * E;
    const long long lo_pos = static_cast<long long>(id) * per;
    int ex[2];
    warp_partition<2>(E, Below{ep, {lo_pos, lo_pos + per}}, ex);
    if (ex[1] > ex[0]) {                       // uniform across the warp
      uint4* tile4 = reinterpret_cast<uint4*>(tile);
      for (int row = 0; row < rows; ++row)
        tile4[row * 32 + lane] = make_uint4(0u, 0u, 0u, 0u);
      __syncwarp();
      for (int j = ex[0] + lane; j < ex[1]; j += 32)
        atomicAdd(&tile[ep[j] - lo_pos], ea[j]);
      __syncwarp();
      patched = true;
    }
  }
  decode_staged_block<MODE>(wb, Tp, offset, width, seed, rows, stage, tile,
                            patched);
  __syncwarp();                                // lanes read the whole tile

  // the owned candidates, a lower bound each in the tile
  int rounds = 0;
  while ((1 << rounds) < per) ++rounds;
  const int32_t* ts = reinterpret_cast<const int32_t*>(tile);
  for (int i = s_lo + lane; i < s_hi; i += 32) {
    const int32_t x = rb[i];
    int lo = -1;
    for (int k = rounds - 1; k >= 0; --k) {
      const int probe = lo + (1 << k);
      lo = (probe < per && ts[min(probe, per - 1)] < x) ? probe : lo;
    }
    ob[i] = ts[min(lo + 1, per - 1)] == x && x != kSentinel;
  }
}

template <int MODE>
cudaError_t launch_probe(const int32_t* r, int M, const uint32_t* w, int Tp,
                   const int32_t* wd, const int32_t* of, const int32_t* mx,
                   int Kp, const int32_t* bk, int C, const int32_t* ep,
                   const uint32_t* ea, int E, int rows, int B, bool* out,
                   cudaStream_t st) {
  const int tile_bytes = 2 * rows * kLanes * 4;       // stage + tile a warp
  const int warps = max(1, min(kMaxWarps, kCtaSmem / tile_bytes));
  const dim3 grid((C + warps - 1) / warps, B);
  packed_gallop_kernel<MODE><<<grid, warps * 32, warps * tile_bytes, st>>>(
      r, M, w, Tp, wd, of, mx, Kp, bk, C, ep, ea, E, rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_packed_gallop(const void* r, int M, const void* words,
                                   int Tp, const void* widths,
                                   const void* offsets, const void* maxes,
                                   int Kp, const void* blk, int C,
                                   const void* exc_pos, const void* exc_add,
                                   int E, int rows, int mode, int B,
                                   void* out, void* stream) {
  if (rows < 1 || rows > 32 || B < 1 || M < 1 || C < 1 || Kp < 1 || Tp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto rr = static_cast<const int32_t*>(r);
  const auto w = static_cast<const uint32_t*>(words);
  const auto wd = static_cast<const int32_t*>(widths);
  const auto of = static_cast<const int32_t*>(offsets);
  const auto mx = static_cast<const int32_t*>(maxes);
  const auto bk = static_cast<const int32_t*>(blk);
  const auto ep = static_cast<const int32_t*>(exc_pos);
  const auto ea = static_cast<const uint32_t*>(exc_add);
  const auto y = static_cast<bool*>(out);
#define REPRO_LAUNCH(MD) \
  launch_probe<MD>(rr, M, w, Tp, wd, of, mx, Kp, bk, C, ep, ea, E, rows, B, y, st)
  cudaError_t err;
  switch (mode) {
    case kNone: err = REPRO_LAUNCH(kNone); break;
    case kD1: err = REPRO_LAUNCH(kD1); break;
    case kD2: err = REPRO_LAUNCH(kD2); break;
    case kD4: err = REPRO_LAUNCH(kD4); break;
    case kDM: err = REPRO_LAUNCH(kDM); break;
    case kDV: err = REPRO_LAUNCH(kDV); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(err);
}
