// K8: flash attention forward (GQA, causal and kv_len masks, float32
// accumulation).
//
// This library holds K8's three routes (kernels/flash_attention.py::_route
// picks one a call): the tensor-core route (flash_attention_tc.cuh, entry
// repro_flash_attention_tc), the split-KV route (flash_decode.cuh, entry
// repro_flash_decode) and, below, the SIMT route (entry
// repro_flash_attention), which takes float32, the other head widths,
// kv_len = 0 and unaligned operands.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (pl.pallas_call, body _flash_kernel).  The TPU kernel runs a grid
// (B, H, n_q, n_k) whose last axis is sequential: it carries the online
// softmax state m, l, acc in VMEM scratch from one KV tile to the next.
// CUDA blocks run in no order, so here one CTA of 256 threads owns one
// (b, h, tile of BQ query rows) and loops over the KV tiles itself, keeping
// m and l in registers and acc in registers.  Per KV tile of 64 keys:
//   1. K and V (the KV head h / (H / Hkv)) are read from the (B, S, Hkv, D)
//      layout, 16 bytes a load where the rows are aligned, widened to
//      float32 into shared memory (rows padded to D + 1 floats, so the 16
//      keys a half-warp reads lie in 16 banks);
//   2. S = Q K^T: thread (ty, tx) computes rows ty*R .. ty*R+R-1 against
//      keys tx, tx+16, tx+32, tx+48 with fmaf over d, then scales by
//      1/sqrt(D) and masks: -1e30 where the causal or kv_len mask hides a
//      key (the reference's finite NEG_INF), -inf past Sk (no key there);
//   3. the row max and the row sum of p = expf(s - m_new) over the 16
//      threads of a row group (xor shuffles, the same value in every lane),
//      then l = l * alpha + sum with alpha = expf(m - m_new); p and alpha
//      go to shared memory;
//   4. acc = acc * alpha + P V: warp w owns rows w*RW .. w*RW+RW-1, lane
//      owns columns lane + 32 j.
// The output is acc / max(l, 1e-30), rounded once to the input dtype.
// expf and the division are the IEEE ones (no --use_fast_math), so the
// float32 result agrees with the plain version to rounding order.
//
// Tiles: BQ = 16 R query rows (R = 4, 64 rows; R = 1, 16 rows where
// Sq <= 16, as in decode), 64 keys, heads up to 256 wide (NJ = D / 32
// accumulator columns per thread, rounded up to 1, 2, 4 or 8).  At D = 256
// the CTA holds Q, K and V as float32, (64 + 128) x 257 x 4 bytes, plus the
// 64 x 65 probability tile: 214,528 bytes of the 227 KB a CTA may have.
// The TPU's bq = bk = 512 float32 tiles (about 3.3 MiB of VMEM) do not fit
// an SM; bq and bk change the result only through the order of sums.
// Every KV tile is visited, masked ones too, as the reference visits them.
//
// Bound on the card: the bytes of q, k, v and the output once each against
// 4 B H Sq D x (mean visible keys per row) operations; the products run on
// the CUDA cores in float32 (67 TFLOP/s), not on the tensor cores.
#include <cstdint>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention_tc.cuh"
#include "flash_decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;            // keys per tile
constexpr int kPL = kBK + 1;       // row stride of the probability tile
constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float x, float* y) { *y = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* y) {
  *y = __float2bfloat16_rn(x);
}

// Rows row0 .. row0 + kRows - 1 of a (S, stride) array, widened to float32
// into dst[r * ld + d]; rows at or past n_valid are zeros.  With `vec` (the
// rows start 16-byte aligned and D is a multiple of 16 / sizeof(T)) each
// thread moves 16 bytes a load, several loads in flight.
template <typename T, int kRows>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          size_t stride, int row0, int n_valid,
                                          int D, bool vec, float* dst,
                                          int ld) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int per_row = D / V;
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * V;
      float* o = dst + r * ld + c;
      if (row0 + r < n_valid) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(row0 + r) * stride + c));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < V; ++u) o[u] = widen(e[u]);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) o[u] = 0.f;
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      dst[r * ld + d] = row0 + r < n_valid
          ? widen(src[static_cast<size_t>(row0 + r) * stride + d]) : 0.f;
    }
  }
}

template <int R>
constexpr size_t smem_bytes(int D) {
  return (static_cast<size_t>(16 * R + 2 * kBK) * (D + 1) + 16 * R * kPL +
          2 * 16 * R) * sizeof(float);
}

template <typename T, int R, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, int Sq, int Sk, int H, int Hkv,
                 int D, int causal, int kv_len, float scale, bool vec,
                 T* __restrict__ out) {
  constexpr int BQ = 16 * R;
  constexpr int RW = BQ / 8;       // rows per warp in the P V product
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                // [BQ][ld]
  float* ks = qs + BQ * ld;        // [kBK][ld]
  float* vs = ks + kBK * ld;       // [kBK][ld]
  float* ps = vs + kBK * ld;       // [BQ][kPL]
  float* alpha_s = ps + BQ * kPL;  // [BQ]
  float* l_s = alpha_s + BQ;       // [BQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_stride = static_cast<size_t>(H) * D;   // between positions
  const size_t k_stride = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  T* ob = out + (static_cast<size_t>(b) * Sq * H + h) * D;

  load_tile<T, BQ>(qb, q_stride, q0, Sq, D, vec, qs, ld);

  const int ty = tid >> 4;         // score rows ty*R ..
  const int tx = tid & 15;         // score keys tx + 16 j
  const int warp = tid >> 5;       // P V rows warp*RW ..
  const int lane = tid & 31;       // P V columns lane + 32 j
  float m_i[R], l_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
  }
  float acc[RW][NJ];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = (Sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();               // the last tile's P V is done (and Q is in)
    load_tile<T, kBK>(kb, k_stride, k0, Sk, D, vec, ks, ld);
    load_tile<T, kBK>(vb, k_stride, k0, Sk, D, vec, vs, ld);
    __syncthreads();

    float s[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], kk[4];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = qs[(ty * R + r) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(a[r], kk[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = ty * R + r;
      const int qi = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[r][j] * scale;
        bool visible = true;
        if (causal) visible = qi >= kj;
        if (kv_len >= 0) visible = visible && kj < kv_len;
        x = visible ? x : kNegInf;
        if (kj >= Sk) x = -INFINITY;  // past the keys: weight exactly 0
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        ps[row * kPL + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      l_i[r] = l_i[r] * alpha + sum;
      m_i[r] = m_new;
      if (tx == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float al = alpha_s[warp * RW + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[RW], vv[NJ];
#pragma unroll
      for (int i = 0; i < RW; ++i) p[i] = ps[(warp * RW + i) * kPL + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < D ? vs[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) l_s[ty * R + r] = l_i[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = warp * RW + i;
    if (q0 + row >= Sq) continue;
    const float den = fmaxf(l_s[row], 1e-30f);
    T* o = ob + static_cast<size_t>(q0 + row) * q_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) narrow(acc[i][j] / den, o + d);
    }
  }
}

template <typename T, int R, int NJ>
int launch(const void* q, const void* k, const void* v, int B, int Sq, int Sk,
           int H, int Hkv, int D, int causal, int kv_len, void* out,
           cudaStream_t stream) {
  const auto kernel = flash_fwd_kernel<T, R, NJ>;
  const size_t smem = smem_bytes<R>(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1/sqrt(D) in double, rounded once to float, as JAX rounds the
  // reference's numpy scalar
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const bool vec = D % (16 / sizeof(T)) == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((Sq + 16 * R - 1) / (16 * R), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Sq, Sk, H, Hkv, D, causal, kv_len, scale,
      vec, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int launch_d(const void* q, const void* k, const void* v, int B, int Sq,
             int Sk, int H, int Hkv, int D, int causal, int kv_len, void* out,
             cudaStream_t st) {
  if (D <= 32) return launch<T, R, 1>(q, k, v, B, Sq, Sk, H, Hkv, D, causal, kv_len, out, st);
  if (D <= 64) return launch<T, R, 2>(q, k, v, B, Sq, Sk, H, Hkv, D, causal, kv_len, out, st);
  if (D <= 128) return launch<T, R, 4>(q, k, v, B, Sq, Sk, H, Hkv, D, causal, kv_len, out, st);
  return launch<T, R, 8>(q, k, v, B, Sq, Sk, H, Hkv, D, causal, kv_len, out, st);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, int B, int Sq,
             int Sk, int H, int Hkv, int D, int causal, int kv_len, void* out,
             cudaStream_t st) {
  if (Sq <= 16) return launch_d<T, 1>(q, k, v, B, Sq, Sk, H, Hkv, D, causal, kv_len, out, st);
  return launch_d<T, 4>(q, k, v, B, Sq, Sk, H, Hkv, D, causal, kv_len, out, st);
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D), out (B, Sq, H, D), all contiguous
// and of one dtype (0 float32, 1 bfloat16); kv_len -1 means no kv_len mask.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, int B, int Sq, int Sk,
                                     int H, int Hkv, int D, int causal,
                                     int kv_len, int dtype, void* out,
                                     void* stream) {
  if (B < 1 || Sq < 1 || Sk < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      D < 1 || D > 256 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_t<float>(q, k, v, B, Sq, Sk, H, Hkv, D, causal, kv_len, out, st);
    case 1:
      return launch_t<__nv_bfloat16>(q, k, v, B, Sq, Sk, H, Hkv, D, causal, kv_len, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core route (flash_attention_tc.cuh): bf16 q (B, Sq, H, D), k/v
// (B, Sk, Hkv, D), out (B, Sq, H, D), contiguous and 16-byte aligned, D in
// {64, 128, 256}; kv_len -1 means no kv_len mask, else kv_len >= 1.  The
// CTA's shape is a function of D alone (flash_tc::Tile).
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, int B, int Sq, int Sk,
                                        int H, int Hkv, int D, int causal,
                                        int kv_len, void* out, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      kv_len == 0 || kv_len < -1 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return flash_tc::launch<64>(q, k, v, B, Sq, Sk, H, Hkv, causal, kv_len, out, st);
    case 128:
      return flash_tc::launch<128>(q, k, v, B, Sq, Sk, H, Hkv, causal, kv_len, out, st);
    case 256:
      return flash_tc::launch<256>(q, k, v, B, Sq, Sk, H, Hkv, causal, kv_len, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split-KV route (flash_decode.cuh): bf16 q (B, Sq, H, D) with
// Sq H / Hkv <= 8 rows a KV head, k/v (B, Sk, Hkv, D), out (B, Sq, H, D),
// contiguous and 16-byte aligned, D in {64, 128, 256}, non-causal; keys
// [0, n_visible) in n_split chunks of `chunk` keys, every chunk non-empty;
// part_acc float32 (B, Hkv, n_split, rows, D), part_ml float32 (B, Hkv,
// n_split, rows, 2).  Two launches: the partials, then the combine.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  int B, int Sq, int Sk, int H, int Hkv,
                                  int D, int n_visible, int n_split,
                                  int chunk, void* part_acc, void* part_ml,
                                  void* out, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      B > 65535 || Hkv > 65535 ||
      Sq * (H / Hkv) > flash_decode::kSplitRows || n_visible < 1 ||
      n_visible > Sk || chunk < 1 || n_split < 1 || n_split > 65535 ||
      static_cast<long long>(n_split) * chunk < n_visible ||
      static_cast<long long>(n_split - 1) * chunk >= n_visible ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  switch (D) {
    case 64:
      return flash_decode::launch_d<64>(q, k, v, B, Sq, Sk, H, Hkv, n_visible, n_split, chunk, pa, pm, out, st);
    case 128:
      return flash_decode::launch_d<128>(q, k, v, B, Sq, Sk, H, Hkv, n_visible, n_split, chunk, pa, pm, out, st);
    case 256:
      return flash_decode::launch_d<256>(q, k, v, B, Sq, Sk, H, Hkv, n_visible, n_split, chunk, pa, pm, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
