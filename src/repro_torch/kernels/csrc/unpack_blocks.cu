// K1: integrated bit-unpack + prefix sum over whole blocks.
//
// Replaces src/repro/kernels/bitunpack.py::unpack_blocks (pl.pallas_call,
// body make_unpack_kernel).  Grid ceil(K / kUnpackWarps): a CTA of
// kUnpackWarps warps decodes that many consecutive blocks, one warp a block
// (decode_block_warp, unpack_warp.cuh), straight from the flat (T, 128)
// packed words at each block's row offset, so the reference's gather into
// (K, 32, 128) padded blocks is gone.  block_rows is a run-time argument
// (1-32).  The words must be 16-byte aligned (the wrapper checks).
//
// Bound on the card: device-memory bytes, K * (b * 512 + rows * 512)
// (packed words in, 4-byte values out).  Design: a warp puts all of its
// block's word rows on the wire at once (cp.async into shared memory) and
// scans in registers and shuffles, so a block costs one load round trip and
// no barrier whatever K is; a large K gives many blocks a CTA.
#include "unpack_warp.cuh"

using namespace repro;

template <int MODE>
__global__ void __launch_bounds__(kUnpackWarps * 32)
unpack_blocks_kernel(const uint32_t* __restrict__ words, int T,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ widths,
                     const uint32_t* __restrict__ seeds, int K, int rows,
                     uint32_t* __restrict__ out) {
  extern __shared__ uint4 stage[];
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kUnpackWarps + warp;
  if (k >= K) return;
  decode_block_warp<MODE>(words, T, offsets[k], widths[k], seeds[k], rows,
                          stage + warp * rows * 32,
                          out + static_cast<size_t>(k) * rows * kLanes);
}

// Dynamic shared memory above 48 KB must be allowed once per kernel and
// device; 32 rows take 64 KB.
template <int MODE>
static cudaError_t allow_stage() {
  constexpr int kMaxStage = kUnpackWarps * 32 * kLanes * 4;
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(unpack_blocks_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxStage);
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

template <int MODE>
static cudaError_t launch_unpack(const uint32_t* w, int T, const int32_t* o,
                                 const int32_t* b, const uint32_t* s, int K,
                                 int rows, uint32_t* y, cudaStream_t st) {
  const size_t stage = static_cast<size_t>(kUnpackWarps) * rows * kLanes * 4;
  if (stage > 48 * 1024) {
    const cudaError_t err = allow_stage<MODE>();
    if (err != cudaSuccess) return err;
  }
  const int grid = (K + kUnpackWarps - 1) / kUnpackWarps;
  unpack_blocks_kernel<MODE><<<grid, kUnpackWarps * 32, stage, st>>>(
      w, T, o, b, s, K, rows, y);
  return cudaGetLastError();
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
  if (rows < 1 || rows > 32) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_LAUNCH(M) launch_unpack<M>(w, T, o, b, s, K, rows, y, st)
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
