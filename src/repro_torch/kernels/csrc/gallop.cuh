// K2: galloping intersection, branchless lower bound of every candidate.
//
// Replaces src/repro/kernels/intersect_gallop.py::gallop_tiles and
// ::gallop_tiles_batched (pl.pallas_call, body _gallop_body).  Grid
// (ceil(M / 256), B): one thread per candidate r[b, i] runs ceil(log2 N)
// rounds `probe = lo + 2**k; lo = f[probe] < x ? probe : lo` over row b of
// the sorted, SENTINEL-padded f, then tests f[lo + 1] == x; SENTINEL
// candidates are never members.  f is read from global memory (through L1
// and the 50 MB L2), so any N >= 1 works: the TPU kernel's VMEM-resident f
// and its 2**20 cap have no counterpart.
//
// Bound on the card: latency of the dependent loads (log2 N in a chain per
// thread); by bytes it needs only r, the output and the touched lines of f.
// The engine's candidate buffers are compacted (core/intersect.py::compact
// packs the survivors to the front of a SENTINEL-filled buffer that keeps
// its length), so most warps of a main-path call hold SENTINEL only.  Such a
// warp writes false and leaves before the first round (__all_sync): exact,
// because a SENTINEL lane is never a member, and it leaves the card's
// threads to the valid prefix.  The first rounds probe the same few entries
// of f in every warp and hit L1, so f is not staged in shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {

constexpr int kGallopThreads = 256;

__device__ __forceinline__ bool gallop_member(const int32_t* __restrict__ f,
                                              int N, int rounds, int32_t x) {
  int lo = -1;
  for (int k = rounds - 1; k >= 0; --k) {
    const int probe = lo + (1 << k);
    const int32_t v = __ldg(f + min(probe, N - 1));
    lo = (probe < N && v < x) ? probe : lo;
  }
  const int pos = min(lo + 1, N - 1);
  return __ldg(f + pos) == x && x != kSentinel;
}

__global__ void __launch_bounds__(kGallopThreads)
gallop_kernel(const int32_t* __restrict__ r, int M,
              const int32_t* __restrict__ f, int N, int rounds,
              bool* __restrict__ out) {
  const int i = blockIdx.x * kGallopThreads + threadIdx.x;
  const size_t row_r = static_cast<size_t>(blockIdx.y) * M;
  const size_t row_f = static_cast<size_t>(blockIdx.y) * N;
  const int32_t x = i < M ? __ldg(r + row_r + i) : kSentinel;
  // every lane of the warp is here (256 threads a CTA, no exit above)
  if (__all_sync(0xFFFFFFFFu, x == kSentinel)) {
    if (i < M) out[row_r + i] = false;
    return;
  }
  if (i < M) out[row_r + i] = gallop_member(f + row_f, N, rounds, x);
}

// ceil(log2 n) for n >= 1
inline int gallop_rounds(int n) {
  int k = 0;
  while ((1LL << k) < n) ++k;
  return k;
}

inline cudaError_t launch_gallop(const int32_t* r, int B, int M,
                                 const int32_t* f, int N, bool* out,
                                 cudaStream_t st) {
  const dim3 grid((M + kGallopThreads - 1) / kGallopThreads, B);
  gallop_kernel<<<grid, kGallopThreads, 0, st>>>(r, M, f, N, gallop_rounds(N),
                                                 out);
  return cudaGetLastError();
}

}  // namespace repro
