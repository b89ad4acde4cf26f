// Flash-attention backward at head dim 64, hand-written for Hopper (sm_90a):
// two kernels, dK/dV and dQ.
//
// Replaces fsvlm_tpu/ops/flash_attention.py::_hp_bwd_dkv_kernel (:599,
// pallas_call at :791) and ::_hp_bwd_dq_kernel (:648, pallas_call at :818),
// the head-packed Pallas backward of packed_attention (:768-844).  Same
// function, per (batch, head), from the forward's LSE and the pre-pass
// delta = rowsum(dO * O) (computed outside, as the JAX package does):
//   S  = Q K^T / 8 + mask          P  = exp(S - LSE)      (fp32, P not rounded)
//   dV = P^T dO                    dP = dO V^T
//   dS = P * (dP - delta)          dK = dS^T Q / 8        dQ = dS K / 8
//   q, k, v, dO    : (B, H, L, 64) float32 or bfloat16, any b/h/l strides, unit d stride
//   lse, delta     : (B, H, L) float32, contiguous
//   mask           : optional (L, L) float32 additive, shared by batch and heads
//   dq, dk, dv     : (B, H, L, 64) in q's dtype, any b/h/l strides
// Every product accumulates in fp32, and each output is cast to the input
// dtype once, at the end (TPU kernel :609-685).  Keys and queries at or
// past L are excluded (P = 0) instead of padded in memory (the TPU's -1e30
// key padding, _hp_block_mask :703-710).  A -inf mask entry gives P = 0 and
// so dS = 0; a row whose keys are all masked has LSE ~ -1e30 from the
// forward and gets zero gradients.
//
// Grid.  The TPU kernel carried dK/dV (and dQ) in scratch across a
// sequential grid axis (grid=(G, n_kv, n_q), :793, :604-607); Hopper runs
// blocks in no order, so that axis is a loop inside the CTA:
//   dK/dV: one CTA per (b*h, key tile) keeps its K and V tile and its fp32
//          dK and dV accumulators on chip and walks the query tiles;
//   dQ:    one CTA per (b*h, query tile) walks the key tiles.
// Every output element is written by exactly one CTA: no atomics, and the
// result is deterministic.
//
// bfloat16 takes the tensor-core kernels of mma_attn.cuh at D = 64, scale
// 1/8, reading the LSE (kLse; the same kernels serve #2 from its row max
// and sum): mma.sync m16n8k16 on bf16 tiles copied by cp.async, one warp
// per 16 own rows.  S and dP take the bf16 inputs, whose products the fp32
// accumulator holds exactly; P and dS, fp32 operands on the TPU (:621-640,
// :668-681), go to the tensor cores from their accumulator registers split
// into bf16 hi + lo parts, two products each.  L > 32: CTAs of
// kDkvWarps (4) / kDqWarps (8) warps, 16 own rows each, walk 64-row tiles
// of the other side, double-buffered; L <= 32 (the text passes): every warp
// one whole (b*h).  What bounds it on this card: at CLIP's shapes (L <= 201)
// the bytes, q, k, v, dO read and the outputs written, against 8 (dK/dV)
// and 6 (dQ) L^2 d operations per head, 1.6x that with the hi/lo products:
// under the H100's ridge of about 295 bf16 operations per byte.
//
// float32 keeps this file's first version, fp32 FMAs on the CUDA cores (the
// agreement checks' fp32 limit of 1e-5 is tighter than TF32 tensor cores
// can meet), bound by those FMAs; its design only keeps S, P, dP and dS on
// chip.  128 threads per CTA of 64 rows; every tile lives in shared memory
// as fp32 rows of 64 padded to 68 floats (85.5 KiB with LSE and delta: two
// CTAs per SM).  Thread (rg, cg) = (tid / 8, tid % 8) owns rows
// rg*4..rg*4+3 of the CTA's own tile; against the streamed tile it owns
// the rows cg + 8j (j < 8), and of the head dims cg*4..cg*4+3 and
// 32+cg*4..32+cg*4+3, so that the eight threads of a quarter warp read
// 16-byte vectors from distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_attn.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBlock = 64;     // rows of every tile (queries or keys)
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kRows = 4;       // rows of the CTA's own tile per thread
constexpr int kCols = 8;       // rows of the streamed tile / head dims per thread
constexpr int kS = kD + 4;     // row stride of a shared tile, in floats
constexpr int kTile = kBlock * kS;
constexpr int kSmemFloats = 5 * kTile + 2 * kBlock;  // five tiles, LSE, delta
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);
constexpr float kScale = 0.125f;  // 64 ** -0.5
// warps per CTA of the bf16 tiled kernels (L > 32), 16 own rows each: the
// faster of 4 and 8 at the vision shape (compare_bwd_ctas.py times both)
constexpr int kDkvWarps = 4, kDqWarps = 8;

// strides (in elements) of the (b, h, l) axes of q, k, v, dO and the outputs
struct Strides {
  long long q[3], k[3], v[3], g[3], o1[3], o2[3];
};

// head dim of this thread's c-th output column (c < 8)
__device__ __forceinline__ int dim_of(int cg, int c) { return (c < 4 ? 0 : 28) + cg * 4 + c; }

// rows row0 .. row0+63 of one (b, h) slice of src into dst (fp32, stride kS);
// rows at or past L read as zeros
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride_l,
                                          int row0, int L) {
  for (int i = threadIdx.x; i < kBlock * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int row = row0 + r;
    dst[r * kS + d] = row < L ? src[(long long)row * stride_l + d] : 0.f;
  }
}

// out[i][j] = sum_d A[a0 + i][d] * Bt[cg + 8j][d]   (both tiles row-major)
__device__ __forceinline__ void rows_dot(float out[kRows][kCols], const float* A, int a0,
                                         const float* Bt, int cg) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 a[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(a0 + i) * kS + d]);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(&Bt[(cg + 8 * j) * kS + d]);
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

// acc[i][c] += sum_r X[r][a0 + i] * Y[r][dim_of(cg, c)]   (r over the 64 rows)
__device__ __forceinline__ void cols_dot(float acc[kRows][kCols], const float* X, int a0,
                                         const float* Y, int cg) {
#pragma unroll 4
  for (int r = 0; r < kBlock; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(&X[r * kS + a0]);
    const float4 y0 = *reinterpret_cast<const float4*>(&Y[r * kS + cg * 4]);
    const float4 y1 = *reinterpret_cast<const float4*>(&Y[r * kS + 32 + cg * 4]);
    const float xr[kRows] = {x.x, x.y, x.z, x.w};
    const float yc[kCols] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(xr[i], yc[c], acc[i][c]);
  }
}

// P = exp(S/8 + mask - LSE) and dS = P (dP - delta) for one thread's block,
// in place: s holds S on entry and P on exit, dp holds dP on entry and dS
// on exit.  (qrow[i][j], key[i][j]) is the (query, key) of element (i, j);
// lse_of / delta_of give the query's LSE and delta.
template <bool kKeysOwned>
__device__ __forceinline__ void probs_and_dscores(float s[kRows][kCols], float dp[kRows][kCols],
                                                  int own0, int other0, int rg, int cg, int L,
                                                  const float* __restrict__ mask,
                                                  const float* lse_s, const float* delta_s) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      // the CTA's own tile is keys (dK/dV) or queries (dQ)
      const int own = own0 + rg * kRows + i, other = other0 + cg + 8 * j;
      const int row = kKeysOwned ? other : own;
      const int key = kKeysOwned ? own : other;
      const int r = kKeysOwned ? cg + 8 * j : rg * kRows + i;  // row within the query tile
      float p = 0.f;
      if (row < L && key < L) {
        float x = s[i][j] * kScale;
        if (mask != nullptr) x += mask[(long long)row * L + key];
        p = expf(x - lse_s[r]);
      }
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

// this thread's 4 x 8 block, transposed, into a tile laid out [streamed row][own row]
__device__ __forceinline__ void store_transposed(float* dst, const float v[kRows][kCols], int rg,
                                                 int cg) {
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    *reinterpret_cast<float4*>(&dst[(cg + 8 * j) * kS + rg * kRows]) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

__device__ __forceinline__ void store_rows(float* out, long long sb, long long sh, long long sl, int b,
                                           int h, int row0, int rg, int cg, int L,
                                           const float acc[kRows][kCols], float mult) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + rg * kRows + i;
    if (row < L) {
      float* dst = out + b * sb + h * sh + row * sl;
#pragma unroll
      for (int c = 0; c < kCols; ++c) dst[dim_of(cg, c)] = acc[i][c] * mult;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_d64_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const float* __restrict__ mask, float* __restrict__ dk,
                              float* __restrict__ dv, int H, int L, Strides st) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* Ks = reinterpret_cast<float*>(smem4);  // this CTA's K tile   [key][d]
  float* Vs = Ks + kTile;                       // this CTA's V tile   [key][d]
  float* Qs = Vs + kTile;                       // streamed Q tile     [query][d]
  float* Gs = Qs + kTile;                       // streamed dO tile    [query][d]
  float* Ps = Gs + kTile;                       // P, then dS          [query][key]
  float* lse_s = Ps + kTile;
  float* delta_s = lse_s + kBlock;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;

  const float* qp = q + b * st.q[0] + h * st.q[1];
  const float* gp = g + b * st.g[0] + h * st.g[1];
  load_tile(Ks, k + b * st.k[0] + h * st.k[1], st.k[2], k0, L);
  load_tile(Vs, v + b * st.v[0] + h * st.v[1], st.v[2], k0, L);

  float dk_acc[kRows][kCols], dv_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += kBlock) {
    __syncthreads();  // the previous query tile's Q, dO and dS are no longer read
    load_tile(Qs, qp, st.q[2], q0, L);
    load_tile(Gs, gp, st.g[2], q0, L);
    if (tid < kBlock) {
      const int row = q0 + tid;
      lse_s[tid] = row < L ? lse[(long long)bh * L + row] : 0.f;
      delta_s[tid] = row < L ? delta[(long long)bh * L + row] : 0.f;
    }
    __syncthreads();

    float p[kRows][kCols], ds[kRows][kCols];
    rows_dot(p, Ks, rg * kRows, Qs, cg);   // S^T: this thread's keys x queries
    rows_dot(ds, Vs, rg * kRows, Gs, cg);  // dP^T = V dO^T
    probs_and_dscores<true>(p, ds, k0, q0, rg, cg, L, mask, lse_s, delta_s);

    store_transposed(Ps, p, rg, cg);
    __syncthreads();
    cols_dot(dv_acc, Ps, rg * kRows, Gs, cg);  // dV += P^T dO
    __syncthreads();
    store_transposed(Ps, ds, rg, cg);
    __syncthreads();
    cols_dot(dk_acc, Ps, rg * kRows, Qs, cg);  // dK += dS^T Q
  }

  store_rows(dk, st.o1[0], st.o1[1], st.o1[2], b, h, k0, rg, cg, L, dk_acc, kScale);
  store_rows(dv, st.o2[0], st.o2[1], st.o2[2], b, h, k0, rg, cg, L, dv_acc, 1.f);
}

__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_d64_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ g,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const float* __restrict__ mask, float* __restrict__ dq, int H, int L,
                             Strides st) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // this CTA's Q tile   [query][d]
  float* Gs = Qs + kTile;                       // this CTA's dO tile  [query][d]
  float* Ks = Gs + kTile;                       // streamed K tile     [key][d]
  float* Vs = Ks + kTile;                       // streamed V tile     [key][d]
  float* Ss = Vs + kTile;                       // dS                  [key][query]
  float* lse_s = Ss + kTile;
  float* delta_s = lse_s + kBlock;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;

  const float* kp = k + b * st.k[0] + h * st.k[1];
  const float* vp = v + b * st.v[0] + h * st.v[1];
  load_tile(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, L);
  load_tile(Gs, g + b * st.g[0] + h * st.g[1], st.g[2], q0, L);
  if (tid < kBlock) {
    const int row = q0 + tid;
    lse_s[tid] = row < L ? lse[(long long)bh * L + row] : 0.f;
    delta_s[tid] = row < L ? delta[(long long)bh * L + row] : 0.f;
  }

  float dq_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBlock) {
    __syncthreads();  // the previous key tile's K and dS are no longer read
    load_tile(Ks, kp, st.k[2], k0, L);
    load_tile(Vs, vp, st.v[2], k0, L);
    __syncthreads();

    float p[kRows][kCols], ds[kRows][kCols];
    rows_dot(p, Qs, rg * kRows, Ks, cg);   // S: this thread's queries x keys
    rows_dot(ds, Gs, rg * kRows, Vs, cg);  // dP = dO V^T
    probs_and_dscores<false>(p, ds, q0, k0, rg, cg, L, mask, lse_s, delta_s);

    store_transposed(Ss, ds, rg, cg);
    __syncthreads();
    cols_dot(dq_acc, Ss, rg * kRows, Ks, cg);  // dQ += dS K
  }

  store_rows(dq, st.o1[0], st.o1[1], st.o1[2], b, h, q0, rg, cg, L, dq_acc, kScale);
}

Strides unpack(const long long* s) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.g[i] = s[9 + i];
    st.o1[i] = s[12 + i];
    st.o2[i] = s[15 + i];
  }
  return st;
}

int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, const void* mask, void* dk, void* dv, int B, int H, int L,
               const long long* strides, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dkv_d64_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + kBlock - 1) / kBlock);
  flash_attn_bwd_dkv_d64_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(mask), static_cast<float*>(dk),
      static_cast<float*>(dv), H, L, unpack(strides));
  return (int)cudaGetLastError();
}

int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
              const void* delta, const void* mask, void* dq, int B, int H, int L,
              const long long* strides, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dq_d64_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + kBlock - 1) / kBlock);
  flash_attn_bwd_dq_d64_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(mask), static_cast<float*>(dq),
      H, L, unpack(strides));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 18 element strides, the
// (b, h, l) strides of q, k, v, dO, dK and dV in that order.  mask may be
// null.  Launches on the current device, which the caller sets to the
// tensors'.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
int fsvlm_flash_attn_bwd_dkv_d64(int dtype, const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, const void* delta,
                                 const void* mask, void* dk, void* dv, int B, int H, int L,
                                 const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv(q, k, v, g, lse, delta, mask, dk, dv, B, H, L, strides, s);
  if (dtype == 1)
    return mma_attn::launch_bwd<kD, true, true, kDkvWarps>(q, k, v, g, lse, nullptr, delta, mask,
                                                           dk, dv, B, H, L, kD, kScale, strides, s);
  return (int)cudaErrorInvalidValue;
}

// As above, with one output: strides are those of q, k, v, dO and dQ (the
// last three of the 18 are not read).
int fsvlm_flash_attn_bwd_dq_d64(int dtype, const void* q, const void* k, const void* v,
                                const void* g, const void* lse, const void* delta,
                                const void* mask, void* dq, int B, int H, int L,
                                const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dq(q, k, v, g, lse, delta, mask, dq, B, H, L, strides, s);
  if (dtype == 1)
    return mma_attn::launch_bwd<kD, false, true, kDqWarps>(q, k, v, g, lse, nullptr, delta, mask,
                                                           dq, nullptr, B, H, L, kD, kScale,
                                                           strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
