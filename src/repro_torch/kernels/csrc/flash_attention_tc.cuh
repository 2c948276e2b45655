// K8, the tensor-core route ("tc"): flash attention forward for bf16 q, k, v
// at head widths 64, 128 and 256, on Hopper's tensor cores through the
// warp-level mma.sync.m16n8k16 (bf16 operands, float32 accumulation).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (pl.pallas_call, body _flash_kernel) for those calls; the wrapper's route
// table (kernels/flash_attention.py::_route) sends float32, other widths,
// kv_len = 0 and unaligned operands to the SIMT kernel of
// flash_attention.cu, and short non-causal queries to flash_decode.cuh.
//
// What bounds it on this card.  At the serving shapes (S = 1024, D = 128 or
// 256) attention does some 500 FLOPs per byte of q, k, v and output, above
// the H100's ridge of about 295 bf16 FLOPs a byte, so the bound is the
// tensor cores.  The SIMT kernel ran every product on the CUDA cores in
// float32 and visited the masked causal half too.  Here:
//   - One CTA per (b, h, tile of BQ = 16 x kWarps query rows); warp w owns
//     rows 16w .. 16w + 15 and keeps its m, l (two rows a thread: g and
//     g + 8 of the mma layout) and its 16 x D float32 accumulator in
//     registers.  The loop over KV tiles inside the CTA replaces the TPU
//     grid's sequential ki axis.  Causal grids launch the heaviest q tiles
//     first (grid z reversed, h and b fastest), so the last wave is short.
//   - K and V tiles of BK keys stay bf16 in shared memory, loaded by
//     cp.async 16-byte copies, double buffered: tile j + 1 is in flight
//     while tile j is in the tensor cores.  Rows are padded by 16 bytes
//     (stride 2D + 16 bytes = 16 mod 128), so the eight 16-byte rows of
//     every ldmatrix phase fall in distinct banks.  Shared memory:
//     (BQ + 4 BK) (D + 8) 2 bytes.  The CTA's shape is a function of D
//     (Tile below), the fastest of the shapes timed at causal S = 1024:
//     8 warps and 64-key tiles at D = 256 (202,752 bytes, one CTA an SM),
//     4 warps and 32 keys at D = 128 (52,224 bytes), 4 warps and 64 keys
//     at D = 64 (46,080).  At D = 256 four warps with 64-key tiles spill
//     (each warp's 16 x 256 float32 accumulator is 128 registers a lane).
//   - S = Q K^T: Q's A fragments by ldmatrix from shared memory each tile,
//     K's B fragments by ldmatrix (K rows are B's columns).  Each bf16 x
//     bf16 product is exact in float32, as in the reference, which widens
//     before its product; only the order of the sums differs.
//   - The online softmax runs in the log2 domain: scores are scaled by
//     1/sqrt(D) (rounded to float as the reference rounds it) times log2(e)
//     and p = exp2f(s - m), which differs from expf(s - m) by rounding only
//     (the bf16 tolerance covers it).  The row max is reduced over the four
//     lanes of a row by xor shuffles; each lane sums its own part of l and
//     the four parts are added once, at the end.
//   - P V: p is rounded to bf16 straight from the S accumulators into A
//     fragments (the C layout of two n-tiles is the A layout of one k-step);
//     V's B fragments come through ldmatrix.trans.  l sums the ROUNDED p, so
//     the output is a convex combination of V's rows with exactly the
//     weights the tensor cores applied.  This rounding is the one step the
//     reference lacks (it multiplies p in float32); 2^-9 relative per
//     weight, inside the bf16 tolerance of 0.05.
//   - Output acc / max(l, 1e-30), rounded once to bf16, staged through the
//     warp's own rows of the Q tile and written with 16-byte stores.
//
// Masks, as the reference: scores hidden by the causal mask (q_pos < k_pos,
// both from 0, no offset when Sq != Sk) or by kv_len (k_pos >= kv_len) are
// the finite -1e30, keys past Sk are -inf (weight exactly 0), m starts at
// -1e30.
//
// Skipping fully masked tiles.  A KV tile whose every key is hidden from
// every row of the q tile (causally: k0 > the tile's last q_pos; by kv_len:
// k0 >= kv_len) is not visited.  This is exact, bit for bit, whenever every
// row has a visible key: tile 0 holds key 0, visible to every row when
// kv_len >= 1, and is always visited first, so after it m is a real score;
// a skipped tile would then have added p = exp2(-1e30 - m) = 0 to l and
// 0 x V to acc with alpha = exp2(m - m) = 1, which changes no bit.  The
// residual condition is that real scores lie above -1e30, that is, finite
// inputs.  With kv_len = 0 no row has a visible key and every masked key
// adds exp(0) = 1 (the mean of V over all Sk keys); the route table sends
// those calls to the SIMT kernel, which visits every tile.
//
// What this design leaves on the table: Hopper's full tensor-core rate
// needs wgmma (warpgroup products with B read from shared memory by
// descriptor) fed by TMA and warp-specialised producers; mma.sync issues
// from every warp and reads both operands through registers.
#pragma once

#include <cstdint>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_tc {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;                  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Rows row0 .. row0 + kRows - 1 of a (S, stride) bf16 array into dst (row
// stride D + 8) by cp.async; rows at or past n_valid are zeros.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src,
                                          size_t stride, int row0,
                                          int n_valid, bf16* dst) {
  constexpr int kChunks = D / 8;                   // 16-byte chunks a row
  static_assert(kRows * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < n_valid;
    cp_async16(smem_u32(dst + r * (D + 8) + c),
               src + static_cast<size_t>(ok ? row0 + r : 0) * stride + c,
               ok ? 16 : 0);
  }
}

// The CTA by head width: kWarps warps of 16 query rows, KV tiles of BK keys
// (kernels/flash_attention.py::TC_TILES mirrors it for the CPU emulation).
template <int D> struct Tile;
template <> struct Tile<64> { static constexpr int kWarps = 4, BK = 64; };
template <> struct Tile<128> { static constexpr int kWarps = 4, BK = 32; };
template <> struct Tile<256> { static constexpr int kWarps = 8, BK = 64; };

template <int D, int kWarps, int BK>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(16 * kWarps + 4 * BK) * (D + 8) * sizeof(bf16);
}

template <int D, int kWarps, int BK>
__global__ void __launch_bounds__(kWarps * 32, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int Sq, int Sk, int H, int Hkv,
                int causal, int kv_len, float scale_log2,
                bf16* __restrict__ out) {
  constexpr int kThreads = kWarps * 32;
  constexpr int BQ = 16 * kWarps;
  constexpr int kLd = D + 8;                       // bf16 row stride
  constexpr int NT = BK / 8;                       // key n-tiles of S
  constexpr int ND = D / 8;                        // d n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // [BQ][kLd]
  bf16* ks = qs + BQ * kLd;                        // [2][BK][kLd]
  bf16* vs = ks + 2 * BK * kLd;                    // [2][BK][kLd]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int hk = h / (H / Hkv);
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t k_stride = static_cast<size_t>(Hkv) * D;
  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  bf16* ob = out + (static_cast<size_t>(b) * Sq * H + h) * D;

  // The tiles that hold a key visible to some row of this q tile: keys
  // below kv_len (and Sk) and, causally, at most the tile's last q_pos.
  int kv_end = kv_len >= 0 ? min(kv_len, Sk) : Sk;
  if (causal) kv_end = min(kv_end, min(q0 + BQ, Sq));
  const int n_tiles = (kv_end + BK - 1) / BK;      // >= 1: key 0 is visible

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;           // mma row group, column pair
  load_rows<D, BQ, kThreads>(qb, q_stride, q0, Sq, qs);
  load_rows<D, BK, kThreads>(kb, k_stride, 0, Sk, ks);
  load_rows<D, BK, kThreads>(vb, k_stride, 0, Sk, vs);
  cp_async_commit();

  // ldmatrix row addresses: Q as A (matrices rows 0-7 / 8-15 x d 0-7 /
  // 8-15), K as B (keys 0-7, d 0-7 / 8-15, then keys 8-15), V as B through
  // .trans (keys 0-7 / 8-15 x d 0-7, then d 8-15)
  const uint32_t q_addr = smem_u32(qs) +
      ((warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
       (lane >> 4) * 8) * 2;
  const uint32_t k_off =
      (((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t v_off =
      (((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8) * 2;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};               // rows g and g + 8
  float l_r[2] = {0.f, 0.f};                       // this lane's part of l
  const int row_a = q0 + warp * 16 + g;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {   // buffer buf ^ 1 was freed by the last sync
      load_rows<D, BK, kThreads>(kb, k_stride, (j + 1) * BK, Sk,
                                 ks + (buf ^ 1) * BK * kLd);
      load_rows<D, BK, kThreads>(vb, k_stride, (j + 1) * BK, Sk,
                                 vs + (buf ^ 1) * BK * kLd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kt = smem_u32(ks + buf * BK * kLd) + k_off;
    const uint32_t vt = smem_u32(vs + buf * BK * kLd) + v_off;

    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(q_addr + kk * 32, a);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk4[4];
        ldmatrix_x4(kt + (np * 16 * kLd + kk * 16) * 2, bk4);
        mma_bf16(s[2 * np], a, bk4[0], bk4[1]);
        mma_bf16(s[2 * np + 1], a, bk4[2], bk4[3]);
      }
    }

    const int k0 = j * BK;
    const bool masked = k0 + BK > Sk || (kv_len >= 0 && k0 + BK > kv_len) ||
                        (causal && k0 + BK - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int kp = k0 + nt * 8 + 2 * t + (e & 1);
          const int qp = row_a + (e >> 1) * 8;
          if (kp >= Sk) x = -INFINITY;             // no key: weight exactly 0
          else if ((causal && qp < kp) || (kv_len >= 0 && kp >= kv_len))
            x = kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xFFFFFFFFu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xFFFFFFFFu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
    }

    // p rounded to bf16, in the A layout of P V's k-steps of 16 keys:
    // n-tile 2kk gives a0 (row g) and a1 (row g + 8), 2kk + 1 gives a2, a3
    uint32_t pa[NT / 2][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          exp2f(s[nt][0] - m_r[0]), exp2f(s[nt][1] - m_r[0]));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          exp2f(s[nt][2] - m_r[1]), exp2f(s[nt][3] - m_r[1]));
      const float2 flo = __bfloat1622float2(lo), fhi = __bfloat1622float2(hi);
      sum[0] += flo.x + flo.y;
      sum[1] += fhi.x + fhi.y;
      pa[nt / 2][(nt & 1) * 2] = as_u32(lo);
      pa[nt / 2][(nt & 1) * 2 + 1] = as_u32(hi);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + sum[i];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bv4[4];
        ldmatrix_x4_trans(vt + (kk * 16 * kLd + dp * 16) * 2, bv4);
        mma_bf16(acc[2 * dp], pa[kk], bv4[0], bv4[1]);
        mma_bf16(acc[2 * dp + 1], pa[kk], bv4[2], bv4[3]);
      }
    __syncthreads();                               // tile j's buffers are free
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xFFFFFFFFu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xFFFFFFFFu, l_r[i], 2);
    den[i] = fmaxf(l_r[i], 1e-30f);
  }
  // stage the warp's 16 output rows in its own rows of the Q tile (only this
  // warp ever read them), then 16-byte stores of the rows below Sq
  bf16* os = qs + warp * 16 * kLd;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * kLd + nd * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[nd][0] / den[0], acc[nd][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * kLd + nd * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[nd][2] / den[1], acc[nd][3] / den[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < ND / 2; ++it) {
    const int i = lane + it * 32;
    const int r = i / ND, c = (i % ND) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(row) * q_stride + c) =
          *reinterpret_cast<const uint4*>(os + r * kLd + c);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, int B, int Sq, int Sk,
           int H, int Hkv, int causal, int kv_len, void* out,
           cudaStream_t stream) {
  constexpr int kWarps = Tile<D>::kWarps, BK = Tile<D>::BK;
  const auto kernel = flash_tc_kernel<D, kWarps, BK>;
  constexpr size_t smem = smem_bytes<D, kWarps, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1/sqrt(D) rounded to float as the reference rounds it, then log2(e)
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int n_q = (Sq + 16 * kWarps - 1) / (16 * kWarps);
  if (n_q > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // heads fastest, q tiles slowest: a causal grid starts with the heaviest
  // tile of every (b, h)
  const dim3 grid(H, B, n_q);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), Sq, Sk, H, Hkv, causal, kv_len,
      scale * kLog2e, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_tc
