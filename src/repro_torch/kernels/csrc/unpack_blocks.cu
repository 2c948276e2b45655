// K1: integrated bit-unpack + prefix sum over whole blocks.
//
// Replaces src/repro/kernels/bitunpack.py::unpack_blocks (pl.pallas_call,
// body make_unpack_kernel).  Grid K: one CTA of 128 threads per block runs
// decode_block (common.cuh) straight from the flat (T, 128) packed words at
// the block's row offset, so the reference's gather into (K, 32, 128)
// padded blocks is gone.  block_rows is a run-time argument (32 or 8).
//
// Bound on the card: device-memory bytes, K * (b * 512 + rows * 512)
// (packed words in, 4-byte values out).  Design: a thread's loads of one row
// are one coalesced 512-byte row of words; the scan stays in registers,
// shuffles and 68 bytes of shared memory, so nothing but the output goes
// back to memory.
#include "common.cuh"

using namespace repro;

template <int MODE>
__global__ void __launch_bounds__(kLanes)
unpack_blocks_kernel(const uint32_t* __restrict__ words, int T,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ widths,
                     const uint32_t* __restrict__ seeds, int rows,
                     uint32_t* __restrict__ out) {
  __shared__ ScanScratch s;
  const int k = blockIdx.x;
  decode_block<MODE>(words, T, offsets[k], widths[k], seeds[k], rows, nullptr,
                     out + static_cast<size_t>(k) * rows * kLanes, s);
}

extern "C" int repro_unpack_blocks(const void* words, int T, const void* offsets,
                                   const void* widths, const void* seeds, int K,
                                   int rows, int mode, void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const uint32_t*>(words);
  const auto o = static_cast<const int32_t*>(offsets);
  const auto b = static_cast<const int32_t*>(widths);
  const auto s = static_cast<const uint32_t*>(seeds);
  const auto y = static_cast<uint32_t*>(out);
#define REPRO_LAUNCH(M) \
  unpack_blocks_kernel<M><<<K, kLanes, 0, st>>>(w, T, o, b, s, rows, y)
  switch (mode) {
    case kNone: REPRO_LAUNCH(kNone); break;
    case kD1: REPRO_LAUNCH(kD1); break;
    case kD2: REPRO_LAUNCH(kD2); break;
    case kD4: REPRO_LAUNCH(kD4); break;
    case kDM: REPRO_LAUNCH(kDM); break;
    case kDV: REPRO_LAUNCH(kDV); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
