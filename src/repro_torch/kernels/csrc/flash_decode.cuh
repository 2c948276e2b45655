// K8, the split-KV route ("split"): flash attention forward for short,
// non-causal bf16 queries against a long cache (decode), at head widths 64,
// 128 and 256.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (pl.pallas_call, body _flash_kernel) for the calls the wrapper's route
// table (kernels/flash_attention.py::_route) sends here: bf16, causal=False,
// kv_len != 0 and at most kSplitRows query rows a KV head (Sq x H / Hkv).
//
// What bounds it on this card.  A decode step reads the whole visible cache
// once and does 4 D operations per (row, key) on it: one or a few rows do
// a handful of FLOPs per byte, far below the H100's ridge, so the bound is
// the cache's bytes over 3.35 TB/s.  The SIMT kernel gave each (b, h) one
// CTA of 16 query rows (one useful) walking the whole cache alone: 64 CTAs
// on 132 SMs at gemma-7b's decode shape.  Here the cache is cut into
// n_split contiguous chunks and every SM streams its own:
//   - Partials: grid (B, Hkv, n_split), 128 threads.  One CTA takes every
//     query row of one KV head's group (n_rep heads x Sq rows, at most
//     kSplitRows) against one chunk, so each cache byte is read once for
//     all the heads that share it.  K and V come as bf16 in 16-byte loads:
//     L = D / 8 lanes hold one key, a warp 32 / L keys, and each lane keeps
//     G keys' loads in flight.  Each group of L lanes runs its own online
//     softmax (float32, expf, CUDA cores: the work is below the ridge) over
//     its keys; the groups are merged by xor shuffles, the warps through
//     shared memory, and the CTA writes float32 (m, l, acc) for its rows to
//     a scratch tensor the wrapper allocated.
//   - Combine: grid (rows, Hkv, B), D threads.  M = max m_i, l = sum l_i
//     e^(m_i - M), acc = sum acc_i e^(m_i - M); the output is
//     acc / max(l, 1e-30), rounded once to bf16.
// The wrapper picks n_split so that B Hkv n_split fills the card about
// four CTAs deep, over the visible keys only: the grid covers keys
// [0, min(kv_len, Sk)), every chunk holds at least one of them, and no CTA
// is launched for keys at or past kv_len.
//
// Exactness.  The reference masks keys at or past kv_len to the finite
// -1e30 and visits them; with kv_len >= 1 key 0 is visible, so its m is a
// real score and each masked key adds exp(-1e30 - m) = 0: leaving them out
// changes nothing (for finite inputs, whose scores lie above -1e30).  A
// merge of two states (m_a, l_a, acc_a), (m_b, l_b, acc_b) is the online
// softmax's own step with both sides rescaled to M = max(m_a, m_b); a state
// that saw no key carries m = -1e30, l = 0, acc = 0 and weighs e^(-1e30 - M)
// = 0 once any state has a real score, so the -1e30 semantics hold through
// the combine.  p multiplies V in float32, as in the reference; only the
// order of the sums differs.
#pragma once

#include <cstdint>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_decode {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitRows = 8;      // query rows a CTA, at most
constexpr int G = 4;               // keys a lane group loads at once
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void widen8(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// (m, l, acc) <- the merge of itself and (mo, lo, acco)
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[8],
                                      float mo, float lo,
                                      const float (&acco)[8]) {
  const float mn = fmaxf(m, mo);
  const float a = expf(m - mn), b = expf(mo - mn);
  l = l * a + lo * b;
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d] = acc[d] * a + acco[d] * b;
  m = mn;
}

// R: the CTA's query rows rounded up to a power of two (rows <= R)
template <int D, int R>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, int Sq, int Sk, int H, int Hkv,
               int n_visible, int chunk, float scale,
               float* __restrict__ part_acc, float* __restrict__ part_ml) {
  constexpr int L = D / 8;                         // lanes a key
  constexpr int KPW = 32 / L;                      // keys a warp step
  constexpr int kGroups = kWarps * KPW;            // lane groups a CTA
  __shared__ float sm_acc[kWarps][R][D];
  __shared__ float sm_m[kWarps][R], sm_l[kWarps][R];

  const int b = blockIdx.x, hk = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int n_rep = H / Hkv, rows = n_rep * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (lane % L) * 8;                    // this lane's 8 dims
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D + c;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D + c;

  float qr[R][8];                                  // row r = s n_rep + rep
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
      const int s = r / n_rep, h = hk * n_rep + r % n_rep;
      widen8(__ldg(reinterpret_cast<const uint4*>(
                 q + ((static_cast<size_t>(b) * Sq + s) * H + h) * D + c)),
             qr[r]);
    } else {
#pragma unroll
      for (int d = 0; d < 8; ++d) qr[r][d] = 0.f;
    }
  }
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[r][d] = 0.f;
  }

  const int key0 = split * chunk;
  const int key_end = min(key0 + chunk, n_visible);
  // warp-uniform steps (the shuffles need every lane); lane group
  // warp * KPW + lane / L takes keys step + lane / L + i kGroups
  for (int step = key0 + warp * KPW; step < key_end; step += kGroups * G) {
    uint4 kr[G], vr[G];
    bool ok[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int key = step + lane / L + i * kGroups;
      ok[i] = key < key_end;
      const size_t off = static_cast<size_t>(ok[i] ? key : key0) * kv_stride;
      kr[i] = __ldg(reinterpret_cast<const uint4*>(kb + off));
      vr[i] = __ldg(reinterpret_cast<const uint4*>(vb + off));
    }
    float s[R][G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float kf[8];
      widen8(kr[i], kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < 8; ++d) x = fmaf(qr[r][d], kf[d], x);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
        s[r][i] = ok[i] ? x * scale : -INFINITY;   // no key: weight 0
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int i = 1; i < G; ++i) mx = fmaxf(mx, s[r][i]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float p[G], sum = 0.f;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        p[i] = expf(s[r][i] - m_new);
        sum += p[i];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[r][d] *= alpha;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float vf[8];
        widen8(vr[i], vf);
#pragma unroll
        for (int d = 0; d < 8; ++d) acc[r][d] = fmaf(p[i], vf[d], acc[r][d]);
      }
    }
  }

  // merge the warp's lane groups (lanes c apart by multiples of L hold the
  // same dims), then the warps through shared memory
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acco[8];
#pragma unroll
      for (int d = 0; d < 8; ++d)
        acco[d] = __shfl_xor_sync(0xFFFFFFFFu, acc[r][d], off);
      const float mo = __shfl_xor_sync(0xFFFFFFFFu, m[r], off);
      const float lo = __shfl_xor_sync(0xFFFFFFFFu, l[r], off);
      merge(m[r], l[r], acc[r], mo, lo, acco);
    }
  if (lane < L) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int d = 0; d < 8; ++d) sm_acc[warp][r][c + d] = acc[r][d];
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * Hkv + hk) * n_split + split;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float M = sm_m[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w][r] - M);
      lt += sm_l[w][r] * e;
      at += sm_acc[w][r][d] * e;
    }
    part_acc[(part * rows + r) * D + d] = at;
    if (d == 0) {
      part_ml[(part * rows + r) * 2] = M;
      part_ml[(part * rows + r) * 2 + 1] = lt;
    }
  }
}

__global__ void combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml, int Sq,
                               int H, int Hkv, int D, int n_split,
                               bf16* __restrict__ out) {
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const int rows = gridDim.x, n_rep = H / Hkv;
  const size_t first = (static_cast<size_t>(b) * Hkv + hk) * n_split;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part_ml[((first + s) * rows + r) * 2]);
  float lt = 0.f, at = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t i = (first + s) * rows + r;
    const float e = expf(part_ml[i * 2] - M);
    lt += part_ml[i * 2 + 1] * e;
    at += part_acc[i * D + d] * e;
  }
  const int sq = r / n_rep, h = hk * n_rep + r % n_rep;
  out[((static_cast<size_t>(b) * Sq + sq) * H + h) * D + d] =
      __float2bfloat16_rn(at / fmaxf(lt, 1e-30f));
}

template <int D, int R>
int launch_r(const void* q, const void* k, const void* v, int B, int Sq,
             int Sk, int H, int Hkv, int n_visible, int n_split, int chunk,
             float* part_acc, float* part_ml, void* out, cudaStream_t st) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  partial_kernel<D, R><<<dim3(B, Hkv, n_split), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), Sq, Sk, H, Hkv, n_visible, chunk, scale,
      part_acc, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<<<dim3(Sq * (H / Hkv), Hkv, B), D, 0, st>>>(
      part_acc, part_ml, Sq, H, Hkv, D, n_split, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, int B, int Sq,
             int Sk, int H, int Hkv, int n_visible, int n_split, int chunk,
             float* pa, float* pm, void* out, cudaStream_t st) {
  const int rows = Sq * (H / Hkv);
  if (rows <= 1) return launch_r<D, 1>(q, k, v, B, Sq, Sk, H, Hkv, n_visible, n_split, chunk, pa, pm, out, st);
  if (rows <= 2) return launch_r<D, 2>(q, k, v, B, Sq, Sk, H, Hkv, n_visible, n_split, chunk, pa, pm, out, st);
  if (rows <= 4) return launch_r<D, 4>(q, k, v, B, Sq, Sk, H, Hkv, n_visible, n_split, chunk, pa, pm, out, st);
  return launch_r<D, 8>(q, k, v, B, Sq, Sk, H, Hkv, n_visible, n_split, chunk, pa, pm, out, st);
}

}  // namespace flash_decode
