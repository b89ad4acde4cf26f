// Blockwise flash-attention forward at any head dim, hand-written for Hopper
// (sm_90a).
//
// Replaces fsvlm_tpu/ops/flash_attention.py::_blockwise_fwd_kernel (:232,
// pallas_call at :296, entry blockwise_attention :414).  Same function, per
// (batch, head):  O = softmax(Q K^T * scale + mask) V  and the per-row
// logsumexp LSE = m + log(l) that the backward recomputes P from.
//   q, k, v : (B, H, L, d) float32 or bfloat16, any b/h/l strides, unit d stride
//   mask    : optional (L, L) float32 additive, shared by batch and heads
//   o       : (B, H, L, d) in q's dtype, any b/h/l strides
//   lse     : (B, H, L) float32, contiguous
//   scale   : d ** -0.5, an argument (the TPU kernel's partial(scale=...))
//
// Arithmetic, as in the TPU kernel (:245-271): fp32 scores, running max m
// from -1e30 (not -inf: a key tile wholly masked by a -inf mask gives
// exp(-inf - m) = 0, never NaN) and running sum l; P rounded to the input
// dtype before the P.V product while l sums the unrounded P;
// O = acc / max(l, 1e-30) and LSE = m + log(max(l, 1e-30)).  Keys past L are
// excluded (the TPU pads them with -1e30); query rows past L are computed
// but not stored.  Templated on the head dim D in {32, 64, 128, 192, 256};
// d <= D is zero-padded in shared memory; past d = 256 the FMA tiles run at
// D = 256 in column passes (blockwise_attn.cuh), each pass summing S over
// the whole head dim and writing 256 columns of O (every pass writes the
// same LSE; pass 0 stores it).
//
// bfloat16 takes the tensor-core forward of mma_flash_fwd.cuh (the same
// kernel as #6's bf16 entry in flash_attn_fwd.cu, here at D = 32, 64, 128,
// 192 and 256): one pass over 64-key tiles at every D, mma.sync on cp.async
// tiles, and below L = 33 a whole (b*h) per warp at D <= 128.  Past d = 256
// bfloat16 takes the FMA tiles' column passes too.  It is bound by the bytes at
// CLIP's shapes (L <= 201: about L / 2 operations per byte, under the
// H100's ridge of about 295).
//
// float32 keeps this file's first version, fp32 FMAs on the CUDA cores (the
// agreement checks' fp32 limits are tighter than TF32 tensor cores can
// meet), bound by those FMAs.  One CTA of 128 threads per (b*h, 64-query
// tile) walks the key tiles (the TPU's sequential kv grid axis becomes this
// loop).  Tile traits per D: 8 column groups and 64-key tiles at D = 32 and
// 64; 32-key tiles at D = 128, which keeps the fp32 tiles at 77 KiB (two
// CTAs per SM) and a thread's accumulator at 4 x 16: in fp32 the tile walk
// changes only the order of sums, not a rounding.  At D = 192 and 256, 16
// column groups of 32 query rows and 64-key tiles (177 KiB at 256, one CTA
// per SM; a thread's accumulator 4 x 16): 64 keys as the bf16 forward, so
// that bf16 past d = 256, which rounds P on these tiles, walks the same
// key tiles as the plain version.  Q and K are transposed
// (Q broadcast and K read as consecutive 16-byte vectors in the S loop), V
// and P row-major.

#include <math.h>

#include "blockwise_attn.cuh"
#include "mma_flash_fwd.cuh"

namespace {

using namespace blockwise;

template <int D> struct FwdTile;
template <> struct FwdTile<32> { static constexpr int kCG = 8, kBK = 64; };
template <> struct FwdTile<64> { static constexpr int kCG = 8, kBK = 64; };
template <> struct FwdTile<128> { static constexpr int kCG = 8, kBK = 32; };
template <> struct FwdTile<192> { static constexpr int kCG = 16, kBK = 64; };
template <> struct FwdTile<256> { static constexpr int kCG = 16, kBK = 64; };

template <int D>
struct Fwd {
  static constexpr int kCG = FwdTile<D>::kCG;   // column groups
  static constexpr int kBK = FwdTile<D>::kBK;   // keys per tile
  static constexpr int kBQ = kThreads / kCG * kRows;  // queries per CTA
  static constexpr int kSC = kBK / kCG;         // key columns of S per thread
  static constexpr int kDC = D / kCG;           // head dims of O per thread
  static constexpr int kQS = kBQ + 4;           // row stride of the transposed Q tile
  static constexpr int kKS = kBK + 4;           // row stride of the transposed K tile
  static constexpr int kPS = kBK + 4;           // row stride of the P tile
  static constexpr int kSmemBytes =
      (D * kQS + D * kKS + kBK * D + kBQ * kPS) * (int)sizeof(float);
  static_assert(kSC % 4 == 0 && kDC % 4 == 0, "columns come in chunks of four");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
blockwise_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ mask,
                          T* __restrict__ o, float* __restrict__ lse, int H, int L, int d,
                          float scale, Strides st) {
  using F = Fwd<D>;
  constexpr int kCG = F::kCG;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][kQS]   Q tile, transposed
  float* Kt = Qt + D * F::kQS;                  // [D][kKS]   K tile, transposed
  float* Vs = Kt + D * F::kKS;                  // [kBK][D]   V tile
  float* Ps = Vs + F::kBK * D;                  // [kBQ][kPS] P tile

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * F::kBQ;
  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;

  const int nd = passes(d, D), c0 = blockIdx.z * D;
  const T* qp = q + b * st.s[0][0] + h * st.s[0][1];
  const T* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const T* vp = v + b * st.s[2][0] + h * st.s[2][1];
  if (nd == 1) load_rows_t<F::kBQ, D>(Qt, F::kQS, qp, st.s[0][2], q0, L, d);

  float m[kRows], l[kRows], acc[kRows][F::kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMInit;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < F::kDC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += F::kBK) {
    // S = Q K^T for this thread's 4 rows x kSC keys, fp32, D columns of the
    // head dim at a time; V's output columns come with the last
    float s[kRows][F::kSC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < F::kSC; ++j) s[i][j] = 0.f;
    for (int cb = 0; cb < nd; ++cb) {
      const int cd = cb * D;
      __syncthreads();  // the previous tile's Q, K, V and P are no longer read
      if (nd > 1) load_rows_t<F::kBQ, D>(Qt, F::kQS, qp + cd, st.s[0][2], q0, L, d - cd);
      load_rows_t<F::kBK, D>(Kt, F::kKS, kp + cd, st.s[1][2], k0, L, d - cd);
      if (cb == nd - 1) load_rows<F::kBK, D>(Vs, D, vp + c0, st.s[2][2], k0, L, d - c0);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float4 qa = *reinterpret_cast<const float4*>(&Qt[c * F::kQS + rg * kRows]);
        const float qr[kRows] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
        for (int t = 0; t < F::kSC / 4; ++t) {
          const float4 ka = *reinterpret_cast<const float4*>(&Kt[c * F::kKS + t * 4 * kCG + cg * 4]);
          const float kc[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][t * 4 + e] = fmaf(qr[i], kc[e], s[i][t * 4 + e]);
        }
      }
    }

    // online softmax; the kCG lanes of a row group hold one row's kBK keys
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + rg * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < F::kSC; ++j) {
        const int key = k0 + chunk_col<kCG>(cg, j);
        float x = s[i][j] * scale;
        if (key >= L)
          x = -INFINITY;
        else if (mask != nullptr && row < L)
          x += mask[(long long)row * L + key];
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kCG; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < F::kSC; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < kCG; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < F::kDC; ++c) acc[i][c] *= alpha;
    }

    // P, rounded to the input dtype, to shared memory (row-major)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int t = 0; t < F::kSC / 4; ++t)
        *reinterpret_cast<float4*>(&Ps[(rg * kRows + i) * F::kPS + t * 4 * kCG + cg * 4]) =
            make_float4(to_f(from_f<T>(s[i][t * 4])), to_f(from_f<T>(s[i][t * 4 + 1])),
                        to_f(from_f<T>(s[i][t * 4 + 2])), to_f(from_f<T>(s[i][t * 4 + 3])));
    __syncthreads();

    // acc += P V for this thread's 4 rows x kDC head dims
#pragma unroll 2
    for (int j = 0; j < F::kBK; j += 4) {
      float4 pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(rg * kRows + i) * F::kPS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float pr[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          pr[i] = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
#pragma unroll
        for (int t = 0; t < F::kDC / 4; ++t) {
          const float4 va =
              *reinterpret_cast<const float4*>(&Vs[(j + jj) * D + t * 4 * kCG + cg * 4]);
          const float vc[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][t * 4 + e] = fmaf(pr[i], vc[e], acc[i][t * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    if (row < L) {
      const float lg = fmaxf(l[i], kLMin);
      T* orow = o + b * st.s[3][0] + h * st.s[3][1] + row * st.s[3][2] + c0;
#pragma unroll
      for (int c = 0; c < F::kDC; ++c) {
        const int dim = chunk_col<kCG>(cg, c);
        if (dim < d - c0) orow[dim] = from_f<T>(acc[i][c] / lg);
      }
      if (cg == 0 && c0 == 0) lse[(long long)bh * L + row] = m[i] + logf(lg);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
           int B, int H, int L, int d, float scale, const long long* strides,
           cudaStream_t stream) {
  using F = Fwd<D>;
  cudaError_t err = cudaFuncSetAttribute(blockwise_attn_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + F::kBQ - 1) / F::kBQ, passes(d, D));
  blockwise_attn_fwd_kernel<T, D><<<grid, kThreads, F::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(o), static_cast<float*>(lse), H, L, d,
      scale, unpack(strides, 4));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, const void* mask, void* o,
               void* lse, int B, int H, int L, int d, float scale, const long long* strides,
               cudaStream_t stream) {
  switch (padded_dim(d)) {
    case 32: return launch<T, 32>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    case 64: return launch<T, 64>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    case 128: return launch<T, 128>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    case 192: return launch<T, 192>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    case 256: return launch<T, 256>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bf16_dim(const void* q, const void* k, const void* v, const void* mask, void* o,
                    void* lse, int B, int H, int L, int d, float scale, const long long* strides,
                    cudaStream_t stream) {
  using mma_attn::launch_flash;
  switch (padded_dim(d)) {
    case 32: return launch_flash<32>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    case 64: return launch_flash<64>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    case 128: return launch_flash<128>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    case 192: return launch_flash<192>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    case 256:
      if (d <= 256)
        return launch_flash<256>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
      return launch<__nv_bfloat16, 256>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d: the head dim, any d >= 1.  strides: 12
// element strides, the (b, h, l) strides of q, k, v and o in that order.
// mask may be null.  Launches on the current device, which the caller sets
// to the tensors'.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
int fsvlm_blockwise_attn_fwd(int dtype, int d, const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* lse, int B, int H, int L,
                             float scale, const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(q, k, v, mask, o, lse, B, H, L, d, scale, strides, s);
  if (dtype == 1) return launch_bf16_dim(q, k, v, mask, o, lse, B, H, L, d, scale, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
