// K4's SvS mask fold (decoded_fold.cu): AND the galloping membership of
// every candidate against a (J, B, N) stack of sorted lists into the
// candidate's validity bit.  (K5, packed_fold.cu, folds by clearing bits
// instead, a warp a candidate block.)
//
// Replaces the fold of src/repro/kernels/megakernel.py (body
// make_decoded_fold_kernel).  The TPU ran a
// (B, J) grid in order and revisited row b's output block across the j
// axis, seeding it from `valid` at j = 0.  CUDA blocks run concurrently and
// in no order, so the j axis moves inside the thread instead: grid
// (ceil(M / 256), B), one thread per candidate r[b, i] loads valid[b, i],
// and for j = 0 .. J-1 with fold_active[j, b] set, replaces it with
// gallop_member (gallop.cuh) of r[b, i] in folds[j, b, :]; it writes the
// bit once.  There are no atomics and no order between blocks, so the
// result is deterministic.  The loop stops once the bit is false: AND is
// monotone, so the skipped folds could not set it again.  Inactive (j, b)
// slots are identities, as in the reference, and are never read.
//
// Bound on the card: latency of the dependent loads (ceil(log2 N) in a chain
// per active fold per live candidate); by bytes only r, valid, the mask and
// the touched lines of the folds.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "gallop.cuh"

namespace repro {

constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const int32_t* __restrict__ r, const bool* __restrict__ valid,
            int B, int M, const int32_t* __restrict__ folds, int J, int N,
            int rounds, const bool* __restrict__ active,
            bool* __restrict__ out) {
  const int i = blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= M) return;
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * M + i;
  const int32_t x = r[row];
  bool v = valid[row];
  for (int j = 0; j < J && v; ++j) {
    const size_t slot = static_cast<size_t>(j) * B + b;
    if (active[slot]) v = gallop_member(folds + slot * N, N, rounds, x);
  }
  out[row] = v;
}

inline cudaError_t launch_fold(const int32_t* r, const bool* valid, int B,
                               int M, const int32_t* folds, int J, int N,
                               const bool* active, bool* out,
                               cudaStream_t st) {
  const dim3 grid((M + kFoldThreads - 1) / kFoldThreads, B);
  fold_kernel<<<grid, kFoldThreads, 0, st>>>(r, valid, B, M, folds, J, N,
                                             gallop_rounds(N), active, out);
  return cudaGetLastError();
}

}  // namespace repro
