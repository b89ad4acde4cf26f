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
// stored.  Past d = 256 the kernels run at D = 256 in column passes
// (gridDim.z = ceil(d / 256), pass z writing output columns 256 z ..
// 256 z + 255): each pass sums S (and dP) over the whole head dim, 256
// columns of Q and K at a time through the same shared tiles, and reloads
// its own tiles for each 256 columns; at d <= 256 one pass holds the whole
// head dim, as before.  bf16 inputs take these FMA tiles too past d = 256.
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

// the head-dim instantiation that holds d, or that runs it in column passes
// past 256 (0: none, d < 1)
inline int padded_dim(int d) {
  return d < 1 ? 0 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256;
}

// the column passes of head dim d at instantiation D
__host__ __device__ inline int passes(int d, int D) { return (d + D - 1) / D; }

// ------------------------------------------------------------ backward tiles
// Tile traits per D: 8 column groups and own tiles of 64 rows at D = 32 and
// 64; from D = 128, 16 column groups and own tiles of 32 rows, which keep a
// thread's two accumulators at 4 x 8 each at D = 128 (as at D = 64) and 4 x
// 16 at D = 256 (205 KiB of shared memory there, one CTA per SM).  Every tile lives
// in shared memory as fp32 rows padded by four floats, so that rows
// cg + kCG*j fall on distinct banks.
template <int D> struct BwdTile;
template <> struct BwdTile<32> { static constexpr int kCG = 8; };
template <> struct BwdTile<64> { static constexpr int kCG = 8; };
template <> struct BwdTile<128> { static constexpr int kCG = 16; };
template <> struct BwdTile<192> { static constexpr int kCG = 16; };
template <> struct BwdTile<256> { static constexpr int kCG = 16; };

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

// out[i][j] (+)= sum_c A[a0 + i][c] * B[cg + kCG*j][c]   (both tiles [row][d];
// kAcc: added to out)
template <int D, bool kAcc = false>
__device__ __forceinline__ void rows_dot(float out[kRows][Bwd<D>::kSC], const float* A, int a0,
                                         const float* Bt, int cg) {
  using F = Bwd<D>;
  if (!kAcc) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < F::kSC; ++j) out[i][j] = 0.f;
  }
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

// o1 = A1 B1^T and o2 = A2 B2^T (rows_dot, kTwo: both, else o1 alone) over
// the whole head dim, for this CTA's own rows own0 .. (A1, A2) against the
// streamed rows str0 .. (B1, B2), D columns at a time: each column block's
// rows are loaded into the tiles, then multiplied.  With one block (nd ==
// 1) the own tiles already hold their rows and only B1, B2 are loaded.
// Starts with a barrier (the tiles' previous readers are done) and leaves
// B1, B2 holding the last block.
template <int D, bool kTwo, typename T>
__device__ __forceinline__ void dots_over_d(float o1[kRows][Bwd<D>::kSC],
                                            float o2[kRows][Bwd<D>::kSC], float* A1, float* A2,
                                            float* B1, float* B2, const T* a1, const T* a2,
                                            long long a1l, long long a2l, int own0, const T* b1,
                                            const T* b2, long long b1l, long long b2l, int str0,
                                            int L, int d, int nd, int rg, int cg) {
  using F = Bwd<D>;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < F::kSC; ++j) o1[i][j] = o2[i][j] = 0.f;
  for (int c = 0; c < nd; ++c) {
    const int cd = c * D;
    __syncthreads();
    if (nd > 1) {
      load_rows<F::kBO, D>(A1, F::kS, a1 + cd, a1l, own0, L, d - cd);
      if (kTwo) load_rows<F::kBO, D>(A2, F::kS, a2 + cd, a2l, own0, L, d - cd);
    }
    load_rows<F::kBS, D>(B1, F::kS, b1 + cd, b1l, str0, L, d - cd);
    if (kTwo) load_rows<F::kBS, D>(B2, F::kS, b2 + cd, b2l, str0, L, d - cd);
    __syncthreads();
    rows_dot<D, true>(o1, A1, rg * kRows, B1, cg);
    if (kTwo) rows_dot<D, true>(o2, A2, rg * kRows, B2, cg);
  }
}

// With nd > 1 column blocks, the streamed rows str0 .. of the output's
// column block c0 into the tiles B1 (and B2) (after a barrier, then another);
// with one block they hold them already.
template <int D, bool kTwo, typename T>
__device__ __forceinline__ void out_columns(float* B1, float* B2, const T* b1, const T* b2,
                                            long long b1l, long long b2l, int str0, int L, int d,
                                            int nd, int c0) {
  using F = Bwd<D>;
  if (nd == 1) return;
  __syncthreads();
  load_rows<F::kBS, D>(B1, F::kS, b1 + c0, b1l, str0, L, d - c0);
  if (kTwo) load_rows<F::kBS, D>(B2, F::kS, b2 + c0, b2l, str0, L, d - c0);
  __syncthreads();
}

// dK/dV: one CTA per (b*h, key tile, column pass) keeps its K and V tile and
// its fp32 dK and dV accumulators on chip and walks 64-query tiles:
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

  const int nd = passes(d, D), c0 = blockIdx.z * D;
  const T* qp = q + b * st.s[0][0] + h * st.s[0][1];
  const T* gp = g + b * st.s[3][0] + h * st.s[3][1];
  const T* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const T* vp = v + b * st.s[2][0] + h * st.s[2][1];
  if (nd == 1) {
    load_rows<F::kBO, D>(Ks, F::kS, kp, st.s[1][2], k0, L, d);
    load_rows<F::kBO, D>(Vs, F::kS, vp, st.s[2][2], k0, L, d);
  }

  float dk_acc[kRows][F::kDC], dv_acc[kRows][F::kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < F::kDC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += F::kBS) {
    // (the previous query tile's statistics were last read before its barriers)
    load_stats(stat0_s, stat1_s, delta_s, stat0, stat1, delta, bh, q0, F::kBS, L);
    // S^T = K Q^T and dP^T = V dO^T: this thread's keys x queries
    float p[kRows][F::kSC], ds[kRows][F::kSC];
    dots_over_d<D, true>(p, ds, Ks, Vs, Qs, Gs, kp, vp, st.s[1][2], st.s[2][2], k0, qp, gp,
                         st.s[0][2], st.s[3][2], q0, L, d, nd, rg, cg);
    out_columns<D, true>(Qs, Gs, qp, gp, st.s[0][2], st.s[3][2], q0, L, d, nd, c0);
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

  store_rows<D>(dk + c0, st.s[4][0], st.s[4][1], st.s[4][2], b, h, k0, rg, cg, L, d - c0, dk_acc,
                scale);
  store_rows<D>(dv + c0, st.s[5][0], st.s[5][1], st.s[5][2], b, h, k0, rg, cg, L, d - c0, dv_acc,
                1.f);
}

// dQ: one CTA per (b*h, query tile, column pass) walks 64-key tiles:
// dQ += dS K * scale
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

  const int nd = passes(d, D), c0 = blockIdx.z * D;
  const T* qp = q + b * st.s[0][0] + h * st.s[0][1];
  const T* gp = g + b * st.s[3][0] + h * st.s[3][1];
  const T* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const T* vp = v + b * st.s[2][0] + h * st.s[2][1];
  if (nd == 1) {
    load_rows<F::kBO, D>(Qs, F::kS, qp, st.s[0][2], q0, L, d);
    load_rows<F::kBO, D>(Gs, F::kS, gp, st.s[3][2], q0, L, d);
  }
  load_stats(stat0_s, stat1_s, delta_s, stat0, stat1, delta, bh, q0, F::kBO, L);

  float dq_acc[kRows][F::kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < F::kDC; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += F::kBS) {
    // S = Q K^T and dP = dO V^T: this thread's queries x keys (the previous
    // key tile's K and dS are no longer read past the first barrier)
    float p[kRows][F::kSC], ds[kRows][F::kSC];
    dots_over_d<D, true>(p, ds, Qs, Gs, Ks, Vs, qp, gp, st.s[0][2], st.s[3][2], q0, kp, vp,
                         st.s[1][2], st.s[2][2], k0, L, d, nd, rg, cg);
    out_columns<D, false>(Ks, nullptr, kp, kp, st.s[1][2], 0, k0, L, d, nd, c0);
    probs_and_dscores<D, false, kWholeRow>(p, ds, q0, k0, rg, cg, L, scale, mask, stat0_s,
                                           stat1_s, delta_s);

    store_transposed<D>(Ss, ds, rg, cg);
    __syncthreads();
    cols_dot<D>(dq_acc, Ss, rg * kRows, Ks, cg);  // dQ += dS K
  }

  store_rows<D>(dq + c0, st.s[4][0], st.s[4][1], st.s[4][2], b, h, q0, rg, cg, L, d - c0, dq_acc,
                scale);
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
  const dim3 grid(B * H, (L + F::kBO - 1) / F::kBO, passes(d, D));
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
  const dim3 grid(B * H, (L + F::kBO - 1) / F::kBO, passes(d, D));
  attn_bwd_dq_kernel<T, D, kWholeRow><<<grid, kThreads, F::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(stat0),
      static_cast<const float*>(stat1), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dq), H, L, d, scale, unpack(strides, 5));
  return (int)cudaGetLastError();
}

// the dK/dV (kDkv) or dQ kernel at the instantiation that holds d (past
// 256: D = 256 in column passes)
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
    FSVLM_BWD_CASE(192)
    FSVLM_BWD_CASE(256)
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
