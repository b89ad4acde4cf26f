// Flash-attention forward at head dim 64, hand-written for Hopper (sm_90a).
//
// Replaces fsvlm_tpu/ops/flash_attention.py::_hp_fwd_kernel (the head-packed
// Pallas forward, pallas_call at :725, entry packed_attention :754).  Same
// function:  O = softmax(Q K^T / 8 + mask) V  per (batch, head), plus the
// per-row logsumexp LSE = m + log(l) that a backward pass needs.
//   q, k, v : (B, H, L, 64) float32 or bfloat16, any b/h/l strides, unit d stride
//   mask    : optional (L, L) float32 additive, shared by batch and heads
//   o       : (B, H, L, 64) in q's dtype, any b/h/l strides
//   lse     : (B, H, L) float32, contiguous
//
// Arithmetic, as in the TPU kernel (:565-596): scores, running max m and
// running sum l are fp32; m starts at -1e30 (not -inf) so that a key tile
// wholly masked by the -inf causal mask gives exp(-inf - m) = 0 and never
// exp(-inf + inf) = NaN; P is rounded to the input dtype before the P.V
// product, l sums the unrounded P, and l is clamped to 1e-30 at the end.
// Keys past L are excluded; query rows past L are computed but not stored.
// No head packing: two heads per 128 lanes was a TPU lane-width device.
//
// bfloat16 takes the tensor-core forward of mma_flash_fwd.cuh at D = 64,
// scale 1/8 (the same kernel as #3's bf16 entry in blockwise_attn_fwd.cu):
// one pass over 64-key tiles, mma.sync on cp.async tiles, and below L = 33
// a whole (b*h) per warp.  It is bound by the bytes at CLIP's shapes.
//
// float32 keeps this file's first version, fp32 FMAs on the CUDA cores (the
// agreement checks' fp32 limits are tighter than TF32 tensor cores can
// meet), bound by those FMAs: one CTA of 128 threads per (b*h, 64-query
// tile) walks the key tiles of 64 with an online softmax, Q/K/V/P tiles in
// shared memory (Q/K/P transposed and padded so the inner loops read
// 16-byte vectors without bank conflicts), each thread owning a 4x8 block
// of S and of the output accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_flash_fwd.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = 8;       // key columns of S / head dims of O per thread
constexpr int kQS = kBQ + 4;   // row stride of the transposed Q and P tiles
constexpr int kKS = kBK + 4;   // row stride of the transposed K tile
constexpr int kSmemFloats = kD * kQS + kD * kKS + kBK * kD + kBK * kQS;
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);
constexpr float kScale = 0.125f;  // 64 ** -0.5
using blockwise::from_f;
using blockwise::kLMin;
using blockwise::kMInit;
using blockwise::to_f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_d64_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ mask,
                          T* __restrict__ o, float* __restrict__ lse, int H, int L,
                          long long sqb, long long sqh, long long sql,
                          long long skb, long long skh, long long skl,
                          long long svb, long long svh, long long svl,
                          long long sob, long long soh, long long sol) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* Qt = reinterpret_cast<float*>(smem4);  // [kD][kQS]  Q tile, transposed
  float* Kt = Qt + kD * kQS;                    // [kD][kKS]  K tile, transposed
  float* Vs = Kt + kD * kKS;                    // [kBK][kD]  V tile
  float* Pt = Vs + kBK * kD;                    // [kBK][kQS] P tile, transposed

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // this thread's rows: rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;   // its columns: cg*8 .. cg*8+7 (lanes 8j..8j+7 share rows)

  const T* qp = q + b * sqb + h * sqh;
  const T* kp = k + b * skb + h * skh;
  const T* vp = v + b * svb + h * svh;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int row = q0 + r;
    Qt[d * kQS + r] = row < L ? to_f(qp[row * sql + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMInit;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      const int key = k0 + r;
      const bool in = key < L;
      Kt[d * kKS + r] = in ? to_f(kp[key * skl + d]) : 0.f;
      Vs[r * kD + d] = in ? to_f(vp[key * svl + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4x8 block, fp32
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kQS + rg * kRows]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * kKS + cg * kCols]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * kKS + cg * kCols + 4]);
      const float qr[kRows] = {qa.x, qa.y, qa.z, qa.w};
      const float kc[kCols] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    // online softmax; the 8 lanes of a row group hold one row's 64 columns
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + rg * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = k0 + cg * kCols + j;
        float x = s[i][j] * kScale;
        if (key >= L)
          x = -INFINITY;
        else if (mask != nullptr && row < L)
          x += mask[(long long)row * L + key];
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

    // P, rounded to the input dtype, to shared memory (transposed)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float4 pv;
      pv.x = to_f(from_f<T>(s[0][j]));
      pv.y = to_f(from_f<T>(s[1][j]));
      pv.z = to_f(from_f<T>(s[2][j]));
      pv.w = to_f(from_f<T>(s[3][j]));
      *reinterpret_cast<float4*>(&Pt[(cg * kCols + j) * kQS + rg * kRows]) = pv;
    }
    __syncthreads();

    // acc += P V for this thread's 4 rows x 8 head dims
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[j * kQS + rg * kRows]);
      const float4 va = *reinterpret_cast<const float4*>(&Vs[j * kD + cg * kCols]);
      const float4 vb = *reinterpret_cast<const float4*>(&Vs[j * kD + cg * kCols + 4]);
      const float pr[kRows] = {pa.x, pa.y, pa.z, pa.w};
      const float vc[kCols] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pr[i], vc[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    if (row < L) {
      const float lg = fmaxf(l[i], kLMin);
      T* orow = o + b * sob + h * soh + row * sol + cg * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) orow[c] = from_f<T>(acc[i][c] / lg);
      if (cg == 0) lse[(long long)bh * L + row] = m[i] + logf(lg);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o,
           void* lse, int B, int H, int L, const long long* st, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_d64_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + kBQ - 1) / kBQ);
  flash_attn_fwd_d64_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(o), static_cast<float*>(lse), H, L,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (b, h, l) strides of q, k, v and o in that order.  mask may be null.
// Launches on the current device, which the caller sets to the tensors'.
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
int fsvlm_flash_attn_fwd_d64(int dtype, const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* lse, int B, int H, int L,
                             const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, mask, o, lse, B, H, L, strides, s);
  if (dtype == 1)
    return mma_attn::launch_flash<kD>(q, k, v, mask, o, lse, B, H, L, kD, kScale, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
