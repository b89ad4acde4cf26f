// Whole-sequence attention forward at any head dim up to 128, hand-written
// for Hopper (sm_90a).
//
// Replaces fsvlm_tpu/ops/flash_attention.py::_attn_kernel (:32, pallas_call
// at :99, entry fused_attention :73).  Same function, per (batch, head):
//   S = Q K^T * scale + mask  (fp32 accumulation from the input dtype)
//   P = exp(S - rowmax(S)) / rowsum(exp(S - rowmax(S)))   over the WHOLE row
//   O = round(P, v's dtype) . V   (fp32 accumulation), stored in q's dtype
//   q, k, v : (B, H, L, d) float32 or bfloat16, any b/h/l strides, unit d stride
//   mask    : optional (L, L) float32 additive, shared by batch and heads
//   o       : (B, H, L, d) in q's dtype, any b/h/l strides
//   scale   : d ** -0.5 of the unpadded d
// No logsumexp is written.  P is normalized BEFORE it is rounded to v's
// dtype (flash_attention.py:45-47), unlike the flash kernels, which round the
// unnormalized P and divide at the end: in bf16 the two orders differ.  Keys
// past L contribute nothing (the TPU pads them with -1e30; here they are
// never read).  A row whose every key is masked by -inf has l = 0 and gives
// NaN, as the TPU kernel does when L is a multiple of 128.
//
// Design.  The TPU keeps one (Lp, Lp) fp32 score tile per (b*h) in VMEM
// (:99-111); on an SM that does not carry over (L = 201: 170 KB; L = 1024:
// 4 MB, over the 227 KB of shared memory).  So one CTA of 128 threads per
// (b*h, query tile) walks the key tiles twice: pass 1 folds each tile into
// every row's running max m and sum l (online, per thread, then merged over
// the lanes that share a row); pass 2 recomputes S, forms
// P = exp(S - m) / l, rounds it to the input dtype and accumulates P V.
// That is the same function at any L, up to the order of fp32 sums, and no
// tile is sized by L.  The tiles are the backward's (Bwd<D> in
// blockwise_attn.cuh: 64 query rows and 64-key tiles at D = 32 and 64;
// 32 query rows at D = 128), templated on D in {32, 64, 128} with d <= D
// zero-padded in shared memory.
//
// What bounds it on this card: at CLIP's shapes (L <= 201) the bytes,
// 4*B*H*L*d elements (q, k, v read once, o written once) against
// 4*B*H*L^2*d operations.  This first version does its products with fp32
// FMAs on the CUDA cores (no tensor cores, no TMA), computing S twice, so it
// is bound by those FMAs; it keeps S and P on chip.

#include "blockwise_attn.cuh"

namespace {

using namespace blockwise;

template <int D>
struct Fused {
  using F = Bwd<D>;
  // the Q tile, a K and a V tile, and the [key][query] P tile
  static constexpr int kSmemBytes =
      (F::kBO * F::kS + 2 * F::kBS * F::kS + F::kBS * F::kPS) * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ mask, T* __restrict__ o, int H, int L, int d,
                      float scale, Strides st) {
  using F = Bwd<D>;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* Qs = reinterpret_cast<float*>(smem4);  // this CTA's Q tile   [query][d]
  float* Ks = Qs + F::kBO * F::kS;              // streamed K tile     [key][d]
  float* Vs = Ks + F::kBS * F::kS;              // streamed V tile     [key][d]
  float* Ps = Vs + F::kBS * F::kS;              // P                   [key][query]

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

  // pass 1: the whole row's max and sum
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMInit;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += F::kBS) {
    __syncthreads();  // the previous key tile is no longer read
    load_rows<F::kBS, D>(Ks, F::kS, kp, st.s[1][2], k0, L, d);
    __syncthreads();
    float s[kRows][F::kSC];
    rows_dot<D>(s, Qs, rg * kRows, Ks, cg);
    scale_and_mask<D>(s, q0, k0, rg, cg, L, scale, mask);
    fold_row_stats<D, false>(s, s, m, l, nullptr);
  }
  merge_row_stats<F::kCG, false>(m, l, nullptr);

  // pass 2: P = exp(S - m) / l, rounded to the input dtype, then O += P V
  float acc[kRows][F::kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < F::kDC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < L; k0 += F::kBS) {
    __syncthreads();  // the previous K, V and P tiles are no longer read
    load_rows<F::kBS, D>(Ks, F::kS, kp, st.s[1][2], k0, L, d);
    load_rows<F::kBS, D>(Vs, F::kS, vp, st.s[2][2], k0, L, d);
    __syncthreads();
    float s[kRows][F::kSC];
    rows_dot<D>(s, Qs, rg * kRows, Ks, cg);
    scale_and_mask<D>(s, q0, k0, rg, cg, L, scale, mask);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < F::kSC; ++j) s[i][j] = to_f(from_f<T>(expf(s[i][j] - m[i]) / l[i]));
    store_transposed<D>(Ps, s, rg, cg);
    __syncthreads();
    cols_dot<D>(acc, Ps, rg * kRows, Vs, cg);
  }

  store_rows<D>(o, st.s[3][0], st.s[3][1], st.s[3][2], b, h, q0, rg, cg, L, d, acc, 1.f);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, int B, int H,
           int L, int d, float scale, const long long* strides, cudaStream_t stream) {
  constexpr int kSmem = Fused<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fused_attn_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + Bwd<D>::kBO - 1) / Bwd<D>::kBO);
  fused_attn_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(o), H, L, d, scale, unpack(strides, 4));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
               int H, int L, int d, float scale, const long long* strides, cudaStream_t stream) {
  switch (padded_dim(d)) {
    case 32: return launch<T, 32>(q, k, v, mask, o, B, H, L, d, scale, strides, stream);
    case 64: return launch<T, 64>(q, k, v, mask, o, B, H, L, d, scale, strides, stream);
    case 128: return launch<T, 128>(q, k, v, mask, o, B, H, L, d, scale, strides, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d: the head dim, 1..128.  strides: 12
// element strides, the (b, h, l) strides of q, k, v and o in that order.
// mask may be null.  Launches on the current device, which the caller sets
// to the tensors'.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
int fsvlm_fused_attn_fwd(int dtype, int d, const void* q, const void* k, const void* v,
                         const void* mask, void* o, int B, int H, int L, float scale,
                         const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
