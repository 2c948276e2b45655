// K5's candidate-block decode stage (packed_fold.cu): decode only the
// candidate blocks of each slot's compressed list into a window in device
// memory.
//
// Replaces the decode half of src/repro/kernels/megakernel.py::
// make_packed_fold_kernel (bitunpack.py::decode_candidates).
//
// Grid (C, S), one 128-thread CTA per (candidate c, slot s).  A slot is one
// (j, b) cell of K5's (Jp, B) fold stack; every
// operand is laid out slot-major with the strides below.  CTA (c, s) decodes
// block id = blk[s, c] with decode_block (common.cuh), seeded with
// maxes[s, id - 1] (0 for id 0), after adding the FastPFOR exceptions whose
// position falls in that block; ids >= Kp are pad slots and write SENTINEL.
// The window is (S, C * rows * 128) int32, sorted per slot because
// candidate ids ascend.  `active` (S,) may be null (every slot decodes); a
// slot whose flag is false writes nothing, and its consumer never reads it.
//
// exc_pos is ascending and -1-padded at the end (fastpfor.encode and the
// layout padding make it so).  CUDA has no scatter with mode="drop", so a
// CTA binary-searches its block's position range, reading -1 as "past the
// end", and adds exactly the exceptions inside it (atomicAdd into a
// rows x 128 shared-memory patch, exact for integers in any order);
// exceptions of blocks that are not candidates are never read, and none is
// read when E is 0.
//
// Bound on the card: bytes — the candidate blocks' packed words and
// metadata in, the window out.  The TPU kept the window in VMEM; here it
// passes through L2 and device memory, and its consumer reads it back.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {

// First index j in [0, E) with key(ep[j]) >= key, key(-1) = +infinity.
__device__ __forceinline__ int exc_lower_bound(const int32_t* __restrict__ ep,
                                               int E, long long key) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const long long v = ep[mid] < 0 ? LLONG_MAX : ep[mid];
    if (v < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int MODE>
__global__ void __launch_bounds__(kLanes)
packed_decode_kernel(const uint32_t* __restrict__ words, int Tp,
                     const int32_t* __restrict__ widths,
                     const int32_t* __restrict__ offsets,
                     const uint32_t* __restrict__ maxes, int Kp,
                     const int32_t* __restrict__ blk, int C,
                     const int32_t* __restrict__ exc_pos,
                     const uint32_t* __restrict__ exc_add, int E, int rows,
                     const bool* __restrict__ active,
                     int32_t* __restrict__ window) {
  extern __shared__ uint32_t patch[];  // rows x 128 deltas to add
  __shared__ ScanScratch s;
  const int slot = blockIdx.y;
  if (active != nullptr && !active[slot]) return;  // uniform across the CTA
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int per = rows * kLanes;
  int32_t* out = window + (static_cast<size_t>(slot) * C + c) * per;
  const int id = blk[static_cast<size_t>(slot) * C + c];
  if (id < 0 || id >= Kp) {  // pad slot: stays sorted at the tail
    for (int i = tid; i < per; i += kLanes) out[i] = kSentinel;
    return;
  }
  const size_t kb = static_cast<size_t>(slot) * Kp;
  const uint32_t seed = id > 0 ? maxes[kb + id - 1] : 0u;
  const uint32_t* patch_ptr = nullptr;
  if (E > 0) {
    const int32_t* ep = exc_pos + static_cast<size_t>(slot) * E;
    const uint32_t* ea = exc_add + static_cast<size_t>(slot) * E;
    const long long lo_pos = static_cast<long long>(id) * per;
    const int first = exc_lower_bound(ep, E, lo_pos);
    const int last = exc_lower_bound(ep, E, lo_pos + per);
    if (last > first) {  // uniform across the CTA
      for (int i = tid; i < per; i += kLanes) patch[i] = 0u;
      __syncthreads();
      for (int j = first + tid; j < last; j += kLanes)
        atomicAdd(&patch[ep[j] - lo_pos], ea[j]);
      __syncthreads();
      patch_ptr = patch;
    }
  }
  decode_block<MODE>(words + static_cast<size_t>(slot) * Tp * kLanes, Tp,
                     offsets[kb + id], widths[kb + id], seed, rows, patch_ptr,
                     reinterpret_cast<uint32_t*>(out), s);
}

// Decode every active slot's candidate blocks into `window` (S slots).
inline cudaError_t launch_packed_decode(const void* words, int Tp,
                                        const void* widths, const void* offsets,
                                        const void* maxes, int Kp,
                                        const void* blk, int C,
                                        const void* exc_pos,
                                        const void* exc_add, int E, int rows,
                                        int mode, int S, const bool* active,
                                        int32_t* window, cudaStream_t st) {
  const dim3 grid(C, S);
  const size_t smem = static_cast<size_t>(rows) * kLanes * sizeof(uint32_t);
  const auto w = static_cast<const uint32_t*>(words);
  const auto wd = static_cast<const int32_t*>(widths);
  const auto of = static_cast<const int32_t*>(offsets);
  const auto mx = static_cast<const uint32_t*>(maxes);
  const auto bk = static_cast<const int32_t*>(blk);
  const auto ep = static_cast<const int32_t*>(exc_pos);
  const auto ea = static_cast<const uint32_t*>(exc_add);
#define REPRO_LAUNCH(MD)                                              \
  packed_decode_kernel<MD><<<grid, kLanes, smem, st>>>(               \
      w, Tp, wd, of, mx, Kp, bk, C, ep, ea, E, rows, active, window)
  switch (mode) {
    case kNone: REPRO_LAUNCH(kNone); break;
    case kD1: REPRO_LAUNCH(kD1); break;
    case kD2: REPRO_LAUNCH(kD2); break;
    case kD4: REPRO_LAUNCH(kD4); break;
    case kDM: REPRO_LAUNCH(kDM); break;
    case kDV: REPRO_LAUNCH(kDV); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

}  // namespace repro
