// K7: Stream VByte decode (arXiv 1709.08990) with the integrated delta
// prefix sum, one warp a block.
//
// Replaces src/repro/kernels/svb_decode.py::unpack_svb_blocks
// (pl.pallas_call, body make_svb_kernel).  Grid ceil(K / kSvbWarps): a CTA
// of kSvbWarps warps decodes that many consecutive blocks, one warp a block,
// and lane t owns values 4t..4t+3 of every row, as in K1 (unpack_warp.cuh).
// Rows go in groups of G (kRowGroup; 1 for the 1-row blocks the engine
// stores).  For each row of a group, lane t
//   1. reads control byte t of the row (its four 2-bit codes: the warp reads
//      the row's 32 contiguous bytes) and takes its four byte lengths,
//      code + 1, and their sum;
//   2. scans the sums across the warp (warp_scans: a 5-step __shfl_up_sync
//      scan, the group's rows overlapped), which gives its first value's
//      byte offset; the row total, from lane 31, carries to the next row,
//      starting at the block's data offset doffs[k] (int32 sums, wrapping as
//      the reference's).
// Then the group's data span — contiguous, at most G x 512 bytes — is
// staged once, whole 16-byte chunks by cp.async (through L1) into the warp's
// shared memory (a __syncwarp, not a CTA barrier, makes other lanes' chunks
// visible), and each lane extracts its four values from it with the shift,
// mask and clamp of the reference's _reconstruct: a lane whose 4-16 bytes
// all lie in the stage reads the five words that cover them once and takes
// each value with a funnel shift (svb_lane).  A value whose bytes do not lie
// wholly inside staged chunks (an offset below 0 or past the data's last
// whole chunk, or a span that wraps int32) takes the clamped __ldg pair: word indices clamped to [0, DW-1], so a read past the end repeats
// the last word and a negative offset reads word 0; pad blocks (code 0,
// offset 0) decode to the same clamped values.  Last, the mode's prefix sum
// from seeds[k] (prefix_rows, K1's warp scan) and one coalesced 512-byte
// store a row.  There is no __syncthreads.
//
// Bound on the card: device-memory bytes, K * (rows * 32 control bytes +
// the block's data bytes + 8) in and K * rows * 512 out.  The engine's
// blocks are 1 row, 512 bytes out, so a block must cost little more than
// its two dependent loads (control bytes, then data): a 128-thread CTA a
// block would add block-wide scans, each a 4-warp combine between two
// barriers, for the offsets and again for the values.  Here a block is a
// warp with no barrier, its offsets on shuffles, and its data read once in
// 16-byte pieces.
#include <climits>
#include <cstdint>

#include "unpack_warp.cuh"

using namespace repro;

namespace {

constexpr int kSvbWarps = 4;     // blocks a CTA; svb_decode.WARPS mirrors it

// A 16-byte cp.async that also caches in L1 (.ca; K1's cp_async16 is .cg,
// L2 only).  A decode's pow2 pad blocks all stage the stream's first bytes:
// through L2 alone every such copy lands on one line, and on an H100 the
// main path's largest call (16384 blocks) took 0.0090 ms with .cg against
// 0.0064 with .ca.
__device__ __forceinline__ void cp_async16_l1(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Value bytes [o, o + len) of the stream (o an int32 byte offset): from the
// staged chunks q0..q1 (st: chunk q0 first) where they hold all of them,
// else the reference's clamped pair of words.
__device__ __forceinline__ uint32_t svb_value(
    const uint32_t* __restrict__ data, int DW, const uint32_t* st, int q0,
    int q1, int32_t o, uint32_t len) {
  const int32_t word = o >> 2;                          // floor, as int32
  const uint32_t sh = static_cast<uint32_t>(o & 3) << 3;
  uint32_t lo, hi = 0u;
  if (o >= 0 && q1 >= q0 && (o >> 4) >= q0 &&
      (static_cast<uint32_t>(o) + len - 1u) >> 4 <= static_cast<uint32_t>(q1)) {
    const int w = word - 4 * q0;
    lo = st[w];
    if (sh + 8u * len > 32u) hi = st[w + 1];           // the value spills
  } else {
    const int32_t wlo = min(max(word, 0), DW - 1);
    const int32_t whi = min(max(word + 1, 0), DW - 1);
    lo = __ldg(data + wlo);
    hi = __ldg(data + whi);
  }
  return __funnelshift_r(lo, hi, sh) & (0xFFFFFFFFu >> ((4u - len) << 3));
}

// A lane's four values of a row, its bytes [o, o + sum) (sum <= 16) and
// `code` its four 2-bit codes.  Where the staged chunks hold all of those
// bytes, the lane reads the five words that cover them once and takes each
// value with a funnel shift (a word past the bytes may be stale, but only
// bits that the value's mask drops come from it); else each value takes
// svb_value.
__device__ __forceinline__ uint4 svb_lane(const uint32_t* __restrict__ data,
                                         int DW, const uint32_t* st, int q0,
                                         int q1, int32_t o, uint32_t sum,
                                         uint32_t code) {
  uint32_t v[4];
  if (o >= 0 && q1 >= q0 && (o >> 4) >= q0 &&
      (static_cast<uint32_t>(o) + sum - 1u) >> 4 <= static_cast<uint32_t>(q1)) {
    const uint32_t* w = st + ((o >> 2) - 4 * q0);
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
    uint32_t p = static_cast<uint32_t>(o & 3);          // byte in w0
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t len = ((code >> (2 * j)) & 3u) + 1u;
      const uint32_t k = p >> 2;                         // 0..3
      const uint32_t lo = k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : w3;
      const uint32_t hi = k == 0 ? w1 : k == 1 ? w2 : k == 2 ? w3 : w4;
      v[j] = __funnelshift_r(lo, hi, (p & 3u) << 3) &
             (0xFFFFFFFFu >> ((4u - len) << 3));
      p += len;
    }
  } else {
    uint32_t oj = static_cast<uint32_t>(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t len = ((code >> (2 * j)) & 3u) + 1u;
      v[j] = svb_value(data, DW, st, q0, q1, static_cast<int32_t>(oj), len);
      oj += len;
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <int MODE, int G>
__global__ void __launch_bounds__(kSvbWarps * 32)
svb_decode_kernel(const uint32_t* __restrict__ ctrl, int CW,
                  const uint32_t* __restrict__ data, int DW,
                  const int32_t* __restrict__ doffs,
                  const uint32_t* __restrict__ seeds, int K, int rows,
                  uint32_t* __restrict__ out) {
  // a group's span: at most G x 512 bytes from any byte, so G x 32 + 1
  // chunks, and one more that svb_lane's fifth word may reach
  __shared__ uint4 stage_all[kSvbWarps][G * 32 + 2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kSvbWarps + warp;
  if (k >= K) return;
  uint4* stage = stage_all[warp];
  const uint32_t* st = reinterpret_cast<const uint32_t*>(stage);
  const uint8_t* cb = reinterpret_cast<const uint8_t*>(
      ctrl + static_cast<size_t>(k) * CW);
  uint4* o4 = reinterpret_cast<uint4*>(out + static_cast<size_t>(k) * rows *
                                             kLanes);
  const int chunks = DW >> 2;                // whole 16-byte chunks of data
  uint32_t pos = static_cast<uint32_t>(doffs[k]);   // byte offset carry
  const uint32_t seed = seeds[k];
  uint32_t c0 = seed, c1 = seed, c2 = seed, c3 = seed;
  for (int r0 = 0; r0 < rows; r0 += G) {
    // byte lengths and offsets; rows past `rows` have none
    uint32_t code[G], sum[G], x[G], tot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      code[g] = r0 + g < rows ? __ldg(cb + (r0 + g) * 32 + lane) : 0u;
      sum[g] = r0 + g < rows ? 4u + (code[g] & 3u) + ((code[g] >> 2) & 3u) +
                                   ((code[g] >> 4) & 3u) + (code[g] >> 6)
                             : 0u;
      x[g] = sum[g];
    }
    warp_scans(x, lane);
    row_totals(x, tot);
    const uint32_t start = pos;
    uint32_t first[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      first[g] = pos + x[g] - sum[g];
      pos += tot[g];
    }
    // stage the span [start, pos) where it lies inside int32 and the data
    const int32_t s0 = static_cast<int32_t>(start);
    const int span = static_cast<int>(pos - start);    // <= G x 512
    int q0 = 0, q1 = -1;
    if (span > 0 && s0 >= 0 && s0 <= INT_MAX - (span - 1)) {
      q0 = s0 >> 4;
      q1 = min((s0 + (span - 1)) >> 4, chunks - 1);
    }
    for (int q = q0 + lane; q <= q1; q += 32)
      cp_async16_l1(stage + (q - q0), data + 4 * static_cast<size_t>(q));
    cp_async_wait_all();
    __syncwarp();
    uint4 t[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      t[g] = r0 + g < rows
                 ? svb_lane(data, DW, st, q0, q1,
                            static_cast<int32_t>(first[g]), sum[g], code[g])
                 : make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();                 // all lanes are done with the stage
    uint4 v[G];
    prefix_rows<MODE, G>(t, v, c0, c1, c2, c3, lane);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (r0 + g < rows) o4[(r0 + g) * 32 + lane] = v[g];
  }
}

template <int MODE>
cudaError_t launch_svb(const uint32_t* c, int CW, const uint32_t* d, int DW,
                   const int32_t* o, const uint32_t* s, int K, int rows,
                   uint32_t* y, cudaStream_t st) {
  const int grid = (K + kSvbWarps - 1) / kSvbWarps;
  if (rows == 1)
    svb_decode_kernel<MODE, 1><<<grid, kSvbWarps * 32, 0, st>>>(
        c, CW, d, DW, o, s, K, rows, y);
  else
    svb_decode_kernel<MODE, kRowGroup><<<grid, kSvbWarps * 32, 0, st>>>(
        c, CW, d, DW, o, s, K, rows, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_svb_decode(const void* ctrl, int CW, const void* data,
                                int DW, const void* doffs, const void* seeds,
                                int K, int rows, int mode, void* out,
                                void* stream) {
  if (rows < 1 || CW != rows * 8 || DW < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const uint32_t*>(ctrl);
  const auto d = static_cast<const uint32_t*>(data);
  const auto o = static_cast<const int32_t*>(doffs);
  const auto s = static_cast<const uint32_t*>(seeds);
  const auto y = static_cast<uint32_t*>(out);
#define REPRO_LAUNCH(M) launch_svb<M>(c, CW, d, DW, o, s, K, rows, y, st)
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
