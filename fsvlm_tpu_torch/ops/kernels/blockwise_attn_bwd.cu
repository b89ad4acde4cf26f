// Blockwise flash-attention backward at any head dim up to 128, hand-written
// for Hopper (sm_90a): two kernels, dK/dV and dQ.
//
// Replaces fsvlm_tpu/ops/flash_attention.py::_blockwise_dkv_kernel (:324,
// pallas_call at :465) and ::_blockwise_dq_kernel (:372, pallas_call at
// :492), the backward of blockwise_attention (:433-513).  Same function, per
// (batch, head), from the forward's LSE and the pre-pass
// delta = rowsum(dO * O) (computed outside any kernel, as at :458-460):
//   S  = Q K^T * scale + mask      P  = exp(S - LSE)      (fp32, P not rounded)
//   dV = P^T dO                    dP = dO V^T
//   dS = P * (dP - delta)          dK = dS^T Q * scale    dQ = dS K * scale
//   q, k, v, dO    : (B, H, L, d) float32 or bfloat16, any b/h/l strides, unit d stride
//   lse, delta     : (B, H, L) float32, contiguous
//   mask           : optional (L, L) float32 additive, shared by batch and heads
//   dq, dk, dv     : (B, H, L, d) in q's dtype, any b/h/l strides
// Inputs are upcast to fp32, every product accumulates in fp32, and each
// output is cast to the input dtype once, at the end (TPU kernel :334-369,
// :380-406).  Keys and queries at or past L get P = 0 instead of padding in
// memory.  A -inf mask entry gives P = exp(-inf) = 0 and so dS = 0; a row
// whose keys are all masked has LSE ~ -1e30 from the forward and gets zero
// gradients.
//
// Grid.  The TPU kernels carry dK/dV (and dQ) in scratch across a
// sequential grid axis (grid=(B*H, n_kv, n_q) at :467, (B*H, n_q, n_kv) at
// :494); Hopper runs blocks in no order, so that axis is a loop inside the
// CTA:
//   dK/dV: one CTA per (b*h, key tile) keeps its K and V tile and its fp32
//          dK and dV accumulators on chip and walks 64-query tiles;
//   dQ:    one CTA per (b*h, query tile) walks 64-key tiles.
// Every output element is written by exactly one CTA: no atomics, and the
// result is deterministic.
//
// Templated on the head dim D in {32, 64, 128}; d <= D is zero-padded in
// shared memory.  128 threads per CTA, thread (rg, cg) = (tid / kCG,
// tid % kCG) owns rows rg*4 .. rg*4+3 of the CTA's own tile, rows cg + kCG*j
// of the streamed tile, and head dims in chunks of four (blockwise_attn.cuh).
// Tile traits per D: 8 column groups and own tiles of 64 rows at D = 32 and
// 64; at D = 128, 16 column groups and own tiles of 32 rows, which keep a
// thread's two accumulators at 4 x 8 each (as at D = 64) and the fp32 tiles
// at 108.5 KiB (two CTAs per SM) instead of 4 x 16 and 144 KiB.
//
// What bounds it on this card: at CLIP's shapes (L <= 201) the bytes (q, k,
// v, dO read, the outputs written), against 8 (dK/dV) or 6 (dQ) * B*H*L^2*d
// operations.  This first version does every product with fp32 FMAs on the
// CUDA cores (no tensor cores, no TMA), so it is bound by those FMAs; its
// design only keeps S, P, dP and dS on chip.  Every tile lives in shared
// memory as fp32 rows padded by four floats, so that rows cg + kCG*j fall on
// distinct banks.

#include <math.h>

#include "blockwise_attn.cuh"

namespace {

using namespace blockwise;

template <int D> struct BwdTile;
template <> struct BwdTile<32> { static constexpr int kCG = 8; };
template <> struct BwdTile<64> { static constexpr int kCG = 8; };
template <> struct BwdTile<128> { static constexpr int kCG = 16; };

template <int D>
struct Bwd {
  static constexpr int kCG = BwdTile<D>::kCG;        // column groups
  static constexpr int kBO = kThreads / kCG * kRows;  // rows of the CTA's own tile
  static constexpr int kBS = 64;                      // rows of a streamed tile
  static constexpr int kSC = kBS / kCG;               // streamed rows per thread
  static constexpr int kDC = D / kCG;                 // head dims per thread
  static constexpr int kS = D + 4;                    // row stride of a [row][d] tile
  static constexpr int kPS = kBO + 4;                 // row stride of the [streamed][own] tile
  static constexpr int kSmemBytes =
      (2 * kBO * kS + 2 * kBS * kS + kBS * kPS + 2 * kBS) * (int)sizeof(float);
  static_assert(kDC % 4 == 0 && kBO <= kBS, "tile traits");
};

// out[i][j] = sum_c A[a0 + i][c] * B[cg + kCG*j][c]   (both tiles [row][d])
template <int D>
__device__ __forceinline__ void rows_dot(float out[kRows][Bwd<D>::kSC], const float* A, int a0,
                                         const float* Bt, int cg) {
  using F = Bwd<D>;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < F::kSC; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 a[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(a0 + i) * F::kS + c]);
#pragma unroll
    for (int j = 0; j < F::kSC; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(&Bt[(cg + F::kCG * j) * F::kS + c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float s = out[i][j];
        s = fmaf(a[i].x, b.x, s);
        s = fmaf(a[i].y, b.y, s);
        s = fmaf(a[i].z, b.z, s);
        s = fmaf(a[i].w, b.w, s);
        out[i][j] = s;
      }
    }
  }
}

// acc[i][c] += sum_r X[r][a0 + i] * Y[r][chunk_col(cg, c)]   (r over kBS streamed rows)
template <int D>
__device__ __forceinline__ void cols_dot(float acc[kRows][Bwd<D>::kDC], const float* X, int a0,
                                         const float* Y, int cg) {
  using F = Bwd<D>;
#pragma unroll 4
  for (int r = 0; r < F::kBS; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(&X[r * F::kPS + a0]);
    const float xr[kRows] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int t = 0; t < F::kDC / 4; ++t) {
      const float4 y = *reinterpret_cast<const float4*>(&Y[r * F::kS + t * 4 * F::kCG + cg * 4]);
      const float yc[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t * 4 + e] = fmaf(xr[i], yc[e], acc[i][t * 4 + e]);
    }
  }
}

// P = exp(S*scale + mask - LSE) and dS = P (dP - delta) for one thread's
// block, in place: s holds S on entry and P on exit, dp holds dP on entry
// and dS on exit.  The CTA's own tile is keys (dK/dV) or queries (dQ);
// lse_s / delta_s hold the query tile's LSE and delta.
template <int D, bool kKeysOwned>
__device__ __forceinline__ void probs_and_dscores(float s[kRows][Bwd<D>::kSC],
                                                  float dp[kRows][Bwd<D>::kSC], int own0,
                                                  int other0, int rg, int cg, int L, float scale,
                                                  const float* __restrict__ mask,
                                                  const float* lse_s, const float* delta_s) {
  using F = Bwd<D>;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < F::kSC; ++j) {
      const int own = own0 + rg * kRows + i, other = other0 + cg + F::kCG * j;
      const int row = kKeysOwned ? other : own;
      const int key = kKeysOwned ? own : other;
      const int r = kKeysOwned ? cg + F::kCG * j : rg * kRows + i;  // row within the query tile
      float p = 0.f;
      if (row < L && key < L) {
        float x = s[i][j] * scale;
        if (mask != nullptr) x += mask[(long long)row * L + key];
        p = expf(x - lse_s[r]);
      }
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

// this thread's 4 x kSC block, transposed, into the [streamed row][own row] tile
template <int D>
__device__ __forceinline__ void store_transposed(float* dst, const float v[kRows][Bwd<D>::kSC],
                                                 int rg, int cg) {
  using F = Bwd<D>;
#pragma unroll
  for (int j = 0; j < F::kSC; ++j)
    *reinterpret_cast<float4*>(&dst[(cg + F::kCG * j) * F::kPS + rg * kRows]) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out, long long sb, long long sh, long long sl, int b,
                                           int h, int row0, int rg, int cg, int L, int d,
                                           const float acc[kRows][Bwd<D>::kDC], float mult) {
  using F = Bwd<D>;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + rg * kRows + i;
    if (row < L) {
      T* dst = out + b * sb + h * sh + row * sl;
#pragma unroll
      for (int c = 0; c < F::kDC; ++c) {
        const int dim = chunk_col<F::kCG>(cg, c);
        if (dim < d) dst[dim] = from_f<T>(acc[i][c] * mult);
      }
    }
  }
}

// the query tile's LSE and delta (zeros past L) into shared memory
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s, const float* lse,
                                           const float* delta, int bh, int row0, int n, int L) {
  const int t = threadIdx.x;
  if (t < n) {
    const int row = row0 + t;
    lse_s[t] = row < L ? lse[(long long)bh * L + row] : 0.f;
    delta_s[t] = row < L ? delta[(long long)bh * L + row] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
blockwise_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const float* __restrict__ mask, T* __restrict__ dk,
                              T* __restrict__ dv, int H, int L, int d, float scale, Strides st) {
  using F = Bwd<D>;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* Ks = reinterpret_cast<float*>(smem4);  // this CTA's K tile   [key][d]
  float* Vs = Ks + F::kBO * F::kS;              // this CTA's V tile   [key][d]
  float* Qs = Vs + F::kBO * F::kS;              // streamed Q tile     [query][d]
  float* Gs = Qs + F::kBS * F::kS;              // streamed dO tile    [query][d]
  float* Ps = Gs + F::kBS * F::kS;              // P, then dS          [query][key]
  float* lse_s = Ps + F::kBS * F::kPS;
  float* delta_s = lse_s + F::kBS;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * F::kBO;
  const int tid = threadIdx.x;
  const int rg = tid / F::kCG;
  const int cg = tid % F::kCG;

  const T* qp = q + b * st.s[0][0] + h * st.s[0][1];
  const T* gp = g + b * st.s[3][0] + h * st.s[3][1];
  load_rows<F::kBO, D>(Ks, F::kS, k + b * st.s[1][0] + h * st.s[1][1], st.s[1][2], k0, L, d);
  load_rows<F::kBO, D>(Vs, F::kS, v + b * st.s[2][0] + h * st.s[2][1], st.s[2][2], k0, L, d);

  float dk_acc[kRows][F::kDC], dv_acc[kRows][F::kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < F::kDC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += F::kBS) {
    __syncthreads();  // the previous query tile's Q, dO and dS are no longer read
    load_rows<F::kBS, D>(Qs, F::kS, qp, st.s[0][2], q0, L, d);
    load_rows<F::kBS, D>(Gs, F::kS, gp, st.s[3][2], q0, L, d);
    load_stats(lse_s, delta_s, lse, delta, bh, q0, F::kBS, L);
    __syncthreads();

    float p[kRows][F::kSC], ds[kRows][F::kSC];
    rows_dot<D>(p, Ks, rg * kRows, Qs, cg);   // S^T: this thread's keys x queries
    rows_dot<D>(ds, Vs, rg * kRows, Gs, cg);  // dP^T = V dO^T
    probs_and_dscores<D, true>(p, ds, k0, q0, rg, cg, L, scale, mask, lse_s, delta_s);

    store_transposed<D>(Ps, p, rg, cg);
    __syncthreads();
    cols_dot<D>(dv_acc, Ps, rg * kRows, Gs, cg);  // dV += P^T dO
    __syncthreads();
    store_transposed<D>(Ps, ds, rg, cg);
    __syncthreads();
    cols_dot<D>(dk_acc, Ps, rg * kRows, Qs, cg);  // dK += dS^T Q
  }

  store_rows<D>(dk, st.s[4][0], st.s[4][1], st.s[4][2], b, h, k0, rg, cg, L, d, dk_acc, scale);
  store_rows<D>(dv, st.s[5][0], st.s[5][1], st.s[5][2], b, h, k0, rg, cg, L, d, dv_acc, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
blockwise_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const float* __restrict__ mask, T* __restrict__ dq, int H, int L,
                             int d, float scale, Strides st) {
  using F = Bwd<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // this CTA's Q tile   [query][d]
  float* Gs = Qs + F::kBO * F::kS;              // this CTA's dO tile  [query][d]
  float* Ks = Gs + F::kBO * F::kS;              // streamed K tile     [key][d]
  float* Vs = Ks + F::kBS * F::kS;              // streamed V tile     [key][d]
  float* Ss = Vs + F::kBS * F::kS;              // dS                  [key][query]
  float* lse_s = Ss + F::kBS * F::kPS;
  float* delta_s = lse_s + F::kBS;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * F::kBO;
  const int tid = threadIdx.x;
  const int rg = tid / F::kCG;
  const int cg = tid % F::kCG;

  const T* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const T* vp = v + b * st.s[2][0] + h * st.s[2][1];
  load_rows<F::kBO, D>(Qs, F::kS, q + b * st.s[0][0] + h * st.s[0][1], st.s[0][2], q0, L, d);
  load_rows<F::kBO, D>(Gs, F::kS, g + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], q0, L, d);
  load_stats(lse_s, delta_s, lse, delta, bh, q0, F::kBO, L);

  float dq_acc[kRows][F::kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < F::kDC; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += F::kBS) {
    __syncthreads();  // the previous key tile's K and dS are no longer read
    load_rows<F::kBS, D>(Ks, F::kS, kp, st.s[1][2], k0, L, d);
    load_rows<F::kBS, D>(Vs, F::kS, vp, st.s[2][2], k0, L, d);
    __syncthreads();

    float p[kRows][F::kSC], ds[kRows][F::kSC];
    rows_dot<D>(p, Qs, rg * kRows, Ks, cg);   // S: this thread's queries x keys
    rows_dot<D>(ds, Gs, rg * kRows, Vs, cg);  // dP = dO V^T
    probs_and_dscores<D, false>(p, ds, q0, k0, rg, cg, L, scale, mask, lse_s, delta_s);

    store_transposed<D>(Ss, ds, rg, cg);
    __syncthreads();
    cols_dot<D>(dq_acc, Ss, rg * kRows, Ks, cg);  // dQ += dS K
  }

  store_rows<D>(dq, st.s[4][0], st.s[4][1], st.s[4][2], b, h, q0, rg, cg, L, d, dq_acc, scale);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, const void* mask, void* dk, void* dv, int B, int H, int L, int d,
               float scale, const long long* strides, cudaStream_t stream) {
  using F = Bwd<D>;
  cudaError_t err = cudaFuncSetAttribute(blockwise_attn_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + F::kBO - 1) / F::kBO);
  blockwise_attn_bwd_dkv_kernel<T, D><<<grid, kThreads, F::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dk), static_cast<T*>(dv), H, L, d, scale,
      unpack(strides, 6));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
              const void* delta, const void* mask, void* dq, int B, int H, int L, int d,
              float scale, const long long* strides, cudaStream_t stream) {
  using F = Bwd<D>;
  cudaError_t err = cudaFuncSetAttribute(blockwise_attn_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + F::kBO - 1) / F::kBO);
  blockwise_attn_bwd_dq_kernel<T, D><<<grid, kThreads, F::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dq), H, L, d, scale, unpack(strides, 5));
  return (int)cudaGetLastError();
}

template <typename T>
int dkv_dim(const void* q, const void* k, const void* v, const void* g, const void* lse,
            const void* delta, const void* mask, void* dk, void* dv, int B, int H, int L, int d,
            float scale, const long long* st, cudaStream_t s) {
  switch (padded_dim(d)) {
    case 32: return launch_dkv<T, 32>(q, k, v, g, lse, delta, mask, dk, dv, B, H, L, d, scale, st, s);
    case 64: return launch_dkv<T, 64>(q, k, v, g, lse, delta, mask, dk, dv, B, H, L, d, scale, st, s);
    case 128: return launch_dkv<T, 128>(q, k, v, g, lse, delta, mask, dk, dv, B, H, L, d, scale, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dq_dim(const void* q, const void* k, const void* v, const void* g, const void* lse,
           const void* delta, const void* mask, void* dq, int B, int H, int L, int d, float scale,
           const long long* st, cudaStream_t s) {
  switch (padded_dim(d)) {
    case 32: return launch_dq<T, 32>(q, k, v, g, lse, delta, mask, dq, B, H, L, d, scale, st, s);
    case 64: return launch_dq<T, 64>(q, k, v, g, lse, delta, mask, dq, B, H, L, d, scale, st, s);
    case 128: return launch_dq<T, 128>(q, k, v, g, lse, delta, mask, dq, B, H, L, d, scale, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d: the head dim, 1..128.  strides: 18
// element strides, the (b, h, l) strides of q, k, v, dO, dK and dV in that
// order.  mask may be null.  Launches on the current device, which the
// caller sets to the tensors'.  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
int fsvlm_blockwise_attn_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, const void* delta,
                                 const void* mask, void* dk, void* dv, int B, int H, int L,
                                 float scale, const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dkv_dim<float>(q, k, v, g, lse, delta, mask, dk, dv, B, H, L, d, scale, strides, s);
  if (dtype == 1)
    return dkv_dim<__nv_bfloat16>(q, k, v, g, lse, delta, mask, dk, dv, B, H, L, d, scale,
                                  strides, s);
  return (int)cudaErrorInvalidValue;
}

// As above, with one output: strides are the 15 of q, k, v, dO and dQ.
int fsvlm_blockwise_attn_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v,
                                const void* g, const void* lse, const void* delta,
                                const void* mask, void* dq, int B, int H, int L, float scale,
                                const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dq_dim<float>(q, k, v, g, lse, delta, mask, dq, B, H, L, d, scale, strides, s);
  if (dtype == 1)
    return dq_dim<__nv_bfloat16>(q, k, v, g, lse, delta, mask, dq, B, H, L, d, scale, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
