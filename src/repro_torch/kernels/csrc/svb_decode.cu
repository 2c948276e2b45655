// K7: Stream VByte decode (arXiv 1709.08990) with the integrated delta
// prefix sum.
//
// Replaces src/repro/kernels/svb_decode.py::unpack_svb_blocks
// (pl.pallas_call, body make_svb_kernel).  Grid K: one CTA of 128 threads
// per block, one thread per lane, looping over the block's rows.  Per row
// each thread
//   1. reads its 2-bit code from the block's control words (16 per word)
//      and takes its byte length, code + 1;
//   2. scans the byte lengths across the block in row order with
//      prefix_row<kD1> (common.cuh: warp shuffles, a 4-warp combine, and a
//      carry across rows that starts at the block's data offset), which
//      gives its value's byte offset;
//   3. reads the two data words around that offset (indices clamped to
//      [0, DW-1] as the reference's _reconstruct clamps them), shifts and
//      masks out its 1-4 bytes;
//   4. applies the mode's prefix sum from the block's seed (prefix_row),
//      and writes its value once.
// Offsets are int32 sums and every add is on 32 bits, as in the reference,
// so pad blocks (code 0, offset 0) decode to the same clamped values.
//
// The TPU kernel keeps the whole data stream resident in VMEM because byte
// offsets cross block boundaries; here each value's two words come from
// device memory (through the read-only cache: neighbouring lanes read
// neighbouring bytes), so DW has no cap.
//
// Bound on the card: device-memory bytes, K * (rows * 32 control bytes +
// the block's data bytes + 8) in and K * rows * 512 out.  A thread does some
// forty integer operations per value and two block-wide scans per row.
#include "common.cuh"

using namespace repro;

template <int MODE>
__global__ void __launch_bounds__(kLanes)
svb_decode_kernel(const uint32_t* __restrict__ ctrl, int CW,
                  const uint32_t* __restrict__ data, int DW,
                  const int32_t* __restrict__ doffs,
                  const uint32_t* __restrict__ seeds, int rows,
                  uint32_t* __restrict__ out) {
  __shared__ ScanScratch s;
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t* c = ctrl + static_cast<size_t>(k) * CW;
  uint32_t* o = out + static_cast<size_t>(k) * rows * kLanes;
  uint32_t pos = static_cast<uint32_t>(doffs[k]);  // byte offset carry
  uint32_t carry = seeds[k];                        // value carry
  for (int r = 0; r < rows; ++r) {
    const int i = r * kLanes + tid;
    const uint32_t len = ((__ldg(c + (i >> 4)) >> ((i & 15) << 1)) & 3u) + 1u;
    const int32_t off = static_cast<int32_t>(prefix_row<kD1>(len, pos, s) - len);
    const int32_t word = off >> 2;
    const uint32_t sh = static_cast<uint32_t>(off & 3) << 3;
    const int32_t wlo = min(max(word, 0), DW - 1);
    const int32_t whi = min(max(word + 1, 0), DW - 1);
    uint32_t v = __ldg(data + wlo) >> sh;
    if (sh > 0u) v |= __ldg(data + whi) << ((32u - sh) & 31u);
    const uint32_t mask = len >= 4u ? 0xFFFFFFFFu : ((1u << (len << 3)) - 1u);
    o[i] = prefix_row<MODE>(v & mask, carry, s);
  }
}

extern "C" int repro_svb_decode(const void* ctrl, int CW, const void* data,
                                int DW, const void* doffs, const void* seeds,
                                int K, int rows, int mode, void* out,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const uint32_t*>(ctrl);
  const auto d = static_cast<const uint32_t*>(data);
  const auto o = static_cast<const int32_t*>(doffs);
  const auto s = static_cast<const uint32_t*>(seeds);
  const auto y = static_cast<uint32_t*>(out);
#define REPRO_LAUNCH(M) \
  svb_decode_kernel<M><<<K, kLanes, 0, st>>>(c, CW, d, DW, o, s, rows, y)
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
