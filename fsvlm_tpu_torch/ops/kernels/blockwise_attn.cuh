// Device code shared by the blockwise flash-attention kernels
// (blockwise_attn_fwd.cu, blockwise_attn_bwd.cu) and the whole-sequence
// kernels (fused_attn_fwd.cu, fused_attn_bwd.cu).  build.py hashes every
// header in this directory into each library's name, so an edited header
// rebuilds them all.
//
// Every kernel runs 128 threads per CTA.  Thread tid is (row group rg,
// column group cg) = (tid / kCG, tid % kCG): it owns kRows = 4 rows of the
// CTA's own tile and, against a streamed tile, its columns in chunks of
// four, chunk t at t * 4 * kCG + cg * 4, so that the kCG threads of a row
// group (neighbouring lanes of one warp) read consecutive 16-byte vectors.
// A head dim d below the kernel's instantiation D is zero-padded in shared
// memory (the TPU pads to 128 lanes the same way); only dims below d are
// stored.
//
// The second half holds the fp32 backward's tiles (Bwd<D>) and its dK/dV
// and dQ kernels, templated on kWholeRow: false for the blockwise backward,
// which recomputes P = exp(S - LSE) from the forward's logsumexp; true for
// the whole-sequence backward, which recomputes P = exp(S - m) / l from the
// row max m and row sum l of its own pre-pass (fused_attn_bwd.cu), as the
// TPU kernel _attn_bwd_kernel normalizes P (flash_attention.py:128-130).
// bf16 backwards take the tensor-core kernels of mma_attn.cuh instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace blockwise {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // rows of the CTA's own tile per thread
constexpr float kMInit = -1e30f;
constexpr float kLMin = 1e-30f;

// strides (in elements) of the (b, h, l) axes of up to six tensors
struct Strides {
  long long s[6][3];
};

inline Strides unpack(const long long* flat, int n) {
  Strides st{};
  for (int t = 0; t < n; ++t)
    for (int i = 0; i < 3; ++i) st.s[t][i] = flat[3 * t + i];
  return st;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the c-th column of column group cg (chunks of four, kCG groups)
template <int kCG>
__device__ __forceinline__ int chunk_col(int cg, int c) {
  return (c >> 2) * (4 * kCG) + cg * 4 + (c & 3);
}

// rows row0 .. row0+R-1 of one (b, h) slice of src, head dims 0 .. D-1, into
// dst[r * stride + c] (fp32); rows at or past L and dims at or past d are 0
template <int R, int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* __restrict__ src,
                                          long long stride_l, int row0, int L, int d) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * stride + c] = (row < L && c < d) ? to_f(src[(long long)row * stride_l + c]) : 0.f;
  }
}

// as load_rows, transposed: dst[c * stride + r]
template <int R, int D, typename T>
__device__ __forceinline__ void load_rows_t(float* dst, int stride, const T* __restrict__ src,
                                            long long stride_l, int row0, int L, int d) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[c * stride + r] = (row < L && c < d) ? to_f(src[(long long)row * stride_l + c]) : 0.f;
  }
}

// the head-dim instantiation that holds d (0: none)
inline int padded_dim(int d) { return d < 1 ? 0 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0; }

// ------------------------------------------------------------ backward tiles
// Tile traits per D: 8 column groups and own tiles of 64 rows at D = 32 and
// 64; at D = 128, 16 column groups and own tiles of 32 rows, which keep a
// thread's two accumulators at 4 x 8 each (as at D = 64).  Every tile lives
// in shared memory as fp32 rows padded by four floats, so that rows
// cg + kCG*j fall on distinct banks.
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
  // the dK/dV and dQ kernels: two own and two streamed [row][d] tiles, the
  // [streamed][own] tile, and three per-query-row statistics
  static constexpr int kSmemBytes =
      (2 * kBO * kS + 2 * kBS * kS + kBS * kPS + 3 * kBS) * (int)sizeof(float);
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

// P and dS = P (dP - delta) for one thread's block, in place: s holds S on
// entry and P on exit, dp holds dP on entry and dS on exit.  The CTA's own
// tile is keys (dK/dV) or queries (dQ); stat0_s / stat1_s / delta_s hold the
// query tile's statistics: LSE (stat1_s unused) for the blockwise backward,
// P = exp(S*scale + mask - LSE); the row max m and row sum l for the
// whole-sequence one, P = exp(S*scale + mask - m) / l.
template <int D, bool kKeysOwned, bool kWholeRow>
__device__ __forceinline__ void probs_and_dscores(float s[kRows][Bwd<D>::kSC],
                                                  float dp[kRows][Bwd<D>::kSC], int own0,
                                                  int other0, int rg, int cg, int L, float scale,
                                                  const float* __restrict__ mask,
                                                  const float* stat0_s, const float* stat1_s,
                                                  const float* delta_s) {
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
        p = kWholeRow ? expf(x - stat0_s[r]) / stat1_s[r] : expf(x - stat0_s[r]);
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

// the query tile's statistics (zeros past L) into shared memory; stat1 may
// be null (the blockwise backward has one statistic, LSE)
__device__ __forceinline__ void load_stats(float* stat0_s, float* stat1_s, float* delta_s,
                                           const float* stat0, const float* stat1,
                                           const float* delta, int bh, int row0, int n, int L) {
  const int t = threadIdx.x;
  if (t < n) {
    const int row = row0 + t;
    const long long at = (long long)bh * L + row;
    stat0_s[t] = row < L ? stat0[at] : 0.f;
    stat1_s[t] = (row < L && stat1 != nullptr) ? stat1[at] : 0.f;
    delta_s[t] = row < L ? delta[at] : 0.f;
  }
}

// dK/dV: one CTA per (b*h, key tile) keeps its K and V tile and its fp32 dK
// and dV accumulators on chip and walks 64-query tiles:
//   dV += P^T dO,  dK += dS^T Q * scale
template <typename T, int D, bool kWholeRow>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ stat0,
                    const float* __restrict__ stat1, const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv, int H,
                    int L, int d, float scale, Strides st) {
  using F = Bwd<D>;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* Ks = reinterpret_cast<float*>(smem4);  // this CTA's K tile   [key][d]
  float* Vs = Ks + F::kBO * F::kS;              // this CTA's V tile   [key][d]
  float* Qs = Vs + F::kBO * F::kS;              // streamed Q tile     [query][d]
  float* Gs = Qs + F::kBS * F::kS;              // streamed dO tile    [query][d]
  float* Ps = Gs + F::kBS * F::kS;              // P, then dS          [query][key]
  float* stat0_s = Ps + F::kBS * F::kPS;
  float* stat1_s = stat0_s + F::kBS;
  float* delta_s = stat1_s + F::kBS;

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
    load_stats(stat0_s, stat1_s, delta_s, stat0, stat1, delta, bh, q0, F::kBS, L);
    __syncthreads();

    float p[kRows][F::kSC], ds[kRows][F::kSC];
    rows_dot<D>(p, Ks, rg * kRows, Qs, cg);   // S^T: this thread's keys x queries
    rows_dot<D>(ds, Vs, rg * kRows, Gs, cg);  // dP^T = V dO^T
    probs_and_dscores<D, true, kWholeRow>(p, ds, k0, q0, rg, cg, L, scale, mask, stat0_s,
                                          stat1_s, delta_s);

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

// dQ: one CTA per (b*h, query tile) walks 64-key tiles: dQ += dS K * scale
template <typename T, int D, bool kWholeRow>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ g, const float* __restrict__ stat0,
                   const float* __restrict__ stat1, const float* __restrict__ delta,
                   const float* __restrict__ mask, T* __restrict__ dq, int H, int L, int d,
                   float scale, Strides st) {
  using F = Bwd<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // this CTA's Q tile   [query][d]
  float* Gs = Qs + F::kBO * F::kS;              // this CTA's dO tile  [query][d]
  float* Ks = Gs + F::kBO * F::kS;              // streamed K tile     [key][d]
  float* Vs = Ks + F::kBS * F::kS;              // streamed V tile     [key][d]
  float* Ss = Vs + F::kBS * F::kS;              // dS                  [key][query]
  float* stat0_s = Ss + F::kBS * F::kPS;
  float* stat1_s = stat0_s + F::kBS;
  float* delta_s = stat1_s + F::kBS;

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
  load_stats(stat0_s, stat1_s, delta_s, stat0, stat1, delta, bh, q0, F::kBO, L);

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
    probs_and_dscores<D, false, kWholeRow>(p, ds, q0, k0, rg, cg, L, scale, mask, stat0_s,
                                           stat1_s, delta_s);

    store_transposed<D>(Ss, ds, rg, cg);
    __syncthreads();
    cols_dot<D>(dq_acc, Ss, rg * kRows, Ks, cg);  // dQ += dS K
  }

  store_rows<D>(dq, st.s[4][0], st.s[4][1], st.s[4][2], b, h, q0, rg, cg, L, d, dq_acc, scale);
}

template <typename T, int D, bool kWholeRow>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* stat0,
               const void* stat1, const void* delta, const void* mask, void* dk, void* dv, int B,
               int H, int L, int d, float scale, const long long* strides, cudaStream_t stream) {
  using F = Bwd<D>;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T, D, kWholeRow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + F::kBO - 1) / F::kBO);
  attn_bwd_dkv_kernel<T, D, kWholeRow><<<grid, kThreads, F::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(stat0),
      static_cast<const float*>(stat1), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dk), static_cast<T*>(dv), H, L, d, scale,
      unpack(strides, 6));
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kWholeRow>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* stat0,
              const void* stat1, const void* delta, const void* mask, void* dq, int B, int H,
              int L, int d, float scale, const long long* strides, cudaStream_t stream) {
  using F = Bwd<D>;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, D, kWholeRow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + F::kBO - 1) / F::kBO);
  attn_bwd_dq_kernel<T, D, kWholeRow><<<grid, kThreads, F::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(stat0),
      static_cast<const float*>(stat1), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dq), H, L, d, scale, unpack(strides, 5));
  return (int)cudaGetLastError();
}

// the dK/dV (kDkv) or dQ kernel at the instantiation that holds d
template <typename T, bool kWholeRow, bool kDkv>
int bwd_dim(const void* q, const void* k, const void* v, const void* g, const void* stat0,
            const void* stat1, const void* delta, const void* mask, void* out0, void* out1,
            int B, int H, int L, int d, float scale, const long long* st, cudaStream_t s) {
#define FSVLM_BWD_CASE(DP)                                                                       \
  case DP:                                                                                       \
    return kDkv ? launch_dkv<T, DP, kWholeRow>(q, k, v, g, stat0, stat1, delta, mask, out0,     \
                                               out1, B, H, L, d, scale, st, s)                   \
                : launch_dq<T, DP, kWholeRow>(q, k, v, g, stat0, stat1, delta, mask, out0, B, H, \
                                              L, d, scale, st, s);
  switch (padded_dim(d)) {
    FSVLM_BWD_CASE(32)
    FSVLM_BWD_CASE(64)
    FSVLM_BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FSVLM_BWD_CASE
}

// ------------------------------------------------------ whole-row statistics
// For one thread's block S of queries q0 + rg*4 + i and keys k0 + cg + kCG*j:
// x = S * scale + mask in place, -inf at keys past L (query rows past L take
// no mask: they are computed but never stored).
template <int D>
__device__ __forceinline__ void scale_and_mask(float s[kRows][Bwd<D>::kSC], int q0, int k0,
                                               int rg, int cg, int L, float scale,
                                               const float* __restrict__ mask) {
  using F = Bwd<D>;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
#pragma unroll
    for (int j = 0; j < F::kSC; ++j) {
      const int key = k0 + cg + F::kCG * j;
      float x = s[i][j] * scale;
      if (key >= L)
        x = -INFINITY;
      else if (mask != nullptr && row < L)
        x += mask[(long long)row * L + key];
      s[i][j] = x;
    }
  }
}

// Fold one block of x into this thread's running row max m (from -1e30),
// row sum l = sum exp(x - m) and, with kWithU, u = sum exp(x - m) * w, each
// rescaled by exp(m_old - m_new) as m grows.  Keys at -inf add 0.
template <int D, bool kWithU>
__device__ __forceinline__ void fold_row_stats(const float x[kRows][Bwd<D>::kSC],
                                               const float w[kRows][Bwd<D>::kSC], float m[kRows],
                                               float l[kRows], float u[kRows]) {
  using F = Bwd<D>;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < F::kSC; ++j) mt = fmaxf(mt, x[i][j]);
    const float m_new = fmaxf(m[i], mt);
    const float alpha = expf(m[i] - m_new);
    float se = 0.f, su = 0.f;
#pragma unroll
    for (int j = 0; j < F::kSC; ++j) {
      const float e = expf(x[i][j] - m_new);
      se += e;
      if (kWithU) su = fmaf(e, w[i][j], su);
    }
    l[i] = fmaf(l[i], alpha, se);
    if (kWithU) u[i] = fmaf(u[i], alpha, su);
    m[i] = m_new;
  }
}

// Combine the kCG lanes of a row group (each saw its own keys): afterwards
// every lane holds the whole row's m, l (and u).
template <int kCG, bool kWithU>
__device__ __forceinline__ void merge_row_stats(float m[kRows], float l[kRows], float u[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 1; off < kCG; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float m_new = fmaxf(m[i], mo);
      const float a = expf(m[i] - m_new), c = expf(mo - m_new);
      l[i] = l[i] * a + lo * c;
      if (kWithU) {
        const float uo = __shfl_xor_sync(0xffffffffu, u[i], off);
        u[i] = u[i] * a + uo * c;
      }
      m[i] = m_new;
    }
  }
}

}  // namespace blockwise
