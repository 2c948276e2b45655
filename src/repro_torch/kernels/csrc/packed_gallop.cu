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
// CTA (packed_warps: one at 32-row blocks, four at 8, so that a CTA's shared
// memory stays at or under 48 KB), and no CTA barrier.  Warp (b, c) runs
// packed_warp.cuh's `packed_slot`, which K5 (packed_fold.cu) shares: the
// pad-slot exit, the words' cp.async under the warp searches for L, hi(c-1),
// hi(c) and hi(L-1), its chunk of the tail, the exception patch, the decode
// into shared memory and the lookups of the candidates it owns,
// hi(c-1) < x <= hi(c).  K3's epilogue writes out[b, i] = member over the
// owned range (the tail chunk is false), so every out[b, i] has exactly one
// writer: the owned ranges of the real slots tile [0, u) and the chunks
// tile [u, M).
//
// Exact for every caller, by packed_warp.cuh's argument: (i) r's valid
// prefix is strictly increasing, then SENTINEL (engine._packed_probe passes
// the compacted candidate buffer); (ii) the real slots are a prefix of the
// row with ascending ids (source.pad_block_ids pads at the end); (iii) block
// id decodes to values in (maxes[id-1], maxes[id]] (the encoders' lists are
// strictly increasing).
//
// Bound on the card: bytes — the candidate blocks' packed words and
// metadata, their exceptions, r and the mask (launch/kernel_times.py's
// time_k3); the time is a warp's chain of dependent loads (packed_warp.cuh).
// A decoded window in device memory would cost more than that whole bound:
// at the main path's C = 1024 x 32 rows it is 16.8 MB written and read back,
// half of it pad slots, and a gallop over it takes 22 dependent rounds.
#include <cstdint>

#include "packed_warp.cuh"

using namespace repro;

namespace {

// K3's lookup writes the membership itself.
struct WriteMember {
  __device__ __forceinline__ bool skip(int) const { return false; }
  __device__ __forceinline__ void put(bool* out, int i, bool member) const {
    out[i] = member;
  }
};

// At least one CTA an SM is all the launch bound asks of the register
// allocator: with the thread count alone, ptxas aimed at 64-72 registers and
// spilled 4 bytes in some modes; so it takes 79-117, and shared memory (32 KB
// a warp at 32 rows) bounds the warps an SM holds before registers do.
template <int MODE>
__global__ void __launch_bounds__(kPackedMaxWarps * 32, 1)
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
  const int c = blockIdx.x * warps + warp;
  if (c >= C) return;
  const size_t b = blockIdx.y;
  const PackedRow row{r + b * M, out + b * M, words + b * Tp * kLanes,
                      widths + b * Kp, offsets + b * Kp, maxes + b * Kp,
                      blk + b * C, exc_pos + b * E, exc_add + b * E,
                      M, Tp, Kp, C, E, rows};
  packed_slot<MODE>(row, c, smem + static_cast<size_t>(warp) * 2 * rows * 32,
                    WriteMember{});
}

template <int MODE>
cudaError_t launch_probe(const int32_t* r, int M, const uint32_t* w, int Tp,
                   const int32_t* wd, const int32_t* of, const int32_t* mx,
                   int Kp, const int32_t* bk, int C, const int32_t* ep,
                   const uint32_t* ea, int E, int rows, int B, bool* out,
                   cudaStream_t st) {
  const int warps = packed_warps(rows);
  const dim3 grid((C + warps - 1) / warps, B);
  packed_gallop_kernel<MODE><<<grid, warps * 32,
                               warps * packed_warp_bytes(rows), st>>>(
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
