// K5: the packed SvS fold of a batch in one pass — every active (j, b)
// slot's candidate blocks are decoded one warp each in shared memory, and
// each warp clears the mask bits of the candidates its block can hold but
// does not.
//
// Replaces src/repro/kernels/megakernel.py::packed_fold_batched
// (pl.pallas_call, body make_packed_fold_kernel), which for each row b and,
// in order, each fold j decodes the (j, b) list's C candidate blocks into a
// VMEM window (bitunpack.py::decode_candidates), gallops the candidates over
// it and ANDs the hits into row b's output block, seeded from `valid`.
//
// The C entry makes one stream of two operations: cudaMemcpyAsync of
// `valid` into `out` (the AND's seed), then packed_fold_kernel.  The fold
// only clears bits, so it needs no order between its warps and no window:
//   out[b, i] = valid[b, i] AND, over active j, (r[b, i] is a value of the
//               (j, b) list's candidate blocks AND r[b, i] != SENTINEL),
// and a warp writes nothing but false.  Warps of different j may write
// false to the same byte; they write the same value, and a byte store does
// not touch its neighbours.  The seed is a copy on the stream rather than a
// kernel phase because a kernel cannot order one CTA's seed before another
// CTA's clear; both operations go into a CUDA graph as they are.
//
// The warps walk the Jp·B·C slots c-major (slot s = c·Jp·B + j·B + b), so
// the real slots, which lead every (j, b) row, come first; a CTA holds
// packed_warps(rows) warps (one at 32-row blocks: 32 KB of shared memory),
// and the grid is one CTA per `warps` slots.
// Warp (j, b, c):
//   - an inactive (j, b) writes nothing (the AND's identity);
//   - otherwise it runs packed_warp.cuh's `packed_slot` on row b of list
//     (j, b) — the K3 body: a pad slot writes nothing, except that slot 0 of
//     a row with no real slot clears the whole row (a list with no candidate
//     block holds none of the candidates); a real slot clears its chunk of
//     the tail above every candidate block, decodes its block into its tile
//     and looks up the candidates it owns, hi(c-1) < x <= hi(c), clearing
//     those that are not members.  A candidate already false in the input
//     `valid` is not looked up: read from `valid`, never from `out`, so the
//     work done does not depend on the order the warps run in.
// So for each active (j, b) every out[b, i] is written at most once, by a
// lookup or a tail chunk, and only ever with false.
//
// Exact, by packed_warp.cuh's argument, where (i) every row of r is
// strictly increasing, then SENTINEL; (ii) the real candidate slots of each
// (j, b) row form an ascending prefix; (iii) block id decodes to values in
// (maxes[id-1], maxes[id]].  The only callers, index/batch.py::_svs_program
// → ops.intersect_packed_fold, give (i) through _assemble_svs (the rows are
// the seeds' decoded lists, R[b, :len] = it.r, then SENTINEL), (ii) through
// _stack_packed (each slot's candidate_block_ids, unique and ascending, then
// source.pad_block_ids's pads) and (iii) through the encoders (strictly
// increasing lists, maxes the blocks' last values).  `valid` may have holes.
//
// Bound on the card: bytes — the real candidate blocks' packed words and
// metadata, their exceptions, r, valid and the mask
// (launch/kernel_times.py's time_k5); the time is each warp's chain of
// dependent loads (packed_warp.cuh), in as many waves as the real slots
// need at the warps an SM holds.
#include <climits>
#include <cstdint>

#include "packed_warp.cuh"

using namespace repro;

namespace {

// K5's lookup only clears, and only candidates still valid on input.
struct ClearMiss {
  const bool* valid;
  __device__ __forceinline__ bool skip(int i) const { return !valid[i]; }
  __device__ __forceinline__ void put(bool* out, int i, bool member) const {
    if (!member) out[i] = false;
  }
};

// The launch bound as K3's: one CTA an SM at least, so that ptxas does not
// spill (shared memory bounds the warps an SM holds before registers do).
template <int MODE>
__global__ void __launch_bounds__(kPackedMaxWarps * 32, 1)
packed_fold_kernel(const int32_t* __restrict__ r,
                   const bool* __restrict__ valid, int B, int M,
                   const uint32_t* __restrict__ words, int Tp,
                   const int32_t* __restrict__ widths,
                   const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ maxes, int Kp,
                   const int32_t* __restrict__ blk, int C,
                   const int32_t* __restrict__ exc_pos,
                   const uint32_t* __restrict__ exc_add, int E, int rows,
                   int S, const bool* __restrict__ active,
                   bool* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  uint4* stage = smem + static_cast<size_t>(warp) * 2 * rows * 32;
  const int n = S * C;                       // slots; the entry checks < 2**31
  const int s = blockIdx.x * warps + warp;
  if (s >= n) return;
  const int c = s / S, jb = s - c * S;       // c-major: real slots lead
  if (!active[jb]) return;                   // uniform across the warp
  const size_t b = jb % B, q = jb;
  const PackedRow row{r + b * M, out + b * M, words + q * Tp * kLanes,
                      widths + q * Kp, offsets + q * Kp, maxes + q * Kp,
                      blk + q * C, exc_pos + q * E, exc_add + q * E,
                      M, Tp, Kp, C, E, rows};
  packed_slot<MODE>(row, c, stage, ClearMiss{valid + b * M});
}

template <int MODE>
cudaError_t launch_fold(const int32_t* r, const bool* valid, int B, int M,
                        const uint32_t* w, int Tp, const int32_t* wd,
                        const int32_t* of, const int32_t* mx, int Kp,
                        const int32_t* bk, int C, const int32_t* ep,
                        const uint32_t* ea, int E, int rows, int S,
                        const bool* act, bool* out, cudaStream_t st) {
  const int warps = packed_warps(rows);
  const int n = S * C;
  const int ctas = (n + warps - 1) / warps;
  packed_fold_kernel<MODE><<<ctas, warps * 32,
                             warps * packed_warp_bytes(rows), st>>>(
      r, valid, B, M, w, Tp, wd, of, mx, Kp, bk, C, ep, ea, E, rows, S, act,
      out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_packed_fold(const void* r, const void* valid, int B,
                                 int M, const void* words, int Tp,
                                 const void* widths, const void* offsets,
                                 const void* maxes, int Kp, const void* blk,
                                 int C, const void* exc_pos,
                                 const void* exc_add, int E, int rows,
                                 int mode, int Jp, const void* active,
                                 void* out, void* stream) {
  if (rows < 1 || rows > 32 || B < 1 || M < 1 || C < 1 || Kp < 1 || Tp < 1 ||
      Jp < 1 || mode < kNone || mode > kDV ||
      static_cast<long long>(Jp) * B * C > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t seed = cudaMemcpyAsync(
      out, valid, static_cast<size_t>(B) * M, cudaMemcpyDeviceToDevice, st);
  if (seed != cudaSuccess) return static_cast<int>(seed);
  const auto rr = static_cast<const int32_t*>(r);
  const auto vd = static_cast<const bool*>(valid);
  const auto w = static_cast<const uint32_t*>(words);
  const auto wd = static_cast<const int32_t*>(widths);
  const auto of = static_cast<const int32_t*>(offsets);
  const auto mx = static_cast<const int32_t*>(maxes);
  const auto bk = static_cast<const int32_t*>(blk);
  const auto ep = static_cast<const int32_t*>(exc_pos);
  const auto ea = static_cast<const uint32_t*>(exc_add);
  const auto act = static_cast<const bool*>(active);
  const auto y = static_cast<bool*>(out);
  const int S = Jp * B;
#define REPRO_LAUNCH(MD)                                                    \
  launch_fold<MD>(rr, vd, B, M, w, Tp, wd, of, mx, Kp, bk, C, ep, ea, E, rows, \
                  S, act, y, st)
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
