// Whole-sequence attention backward at any head dim up to 128, hand-written
// for Hopper (sm_90a): a row pre-pass, then dK/dV and dQ.
//
// Replaces fsvlm_tpu/ops/flash_attention.py::_attn_bwd_kernel (:116,
// pallas_call at :183), the backward of fused_attention (:163-200).  Same
// function, per (batch, head), from q, k, v and dO alone (the forward saves
// no logsumexp, :159-160):
//   S  = Q K^T * scale + mask      P  = exp(S - rowmax S) / rowsum(...)  (fp32, not rounded)
//   dV = P^T dO                    dP = dO V^T
//   delta = rowsum(dP * P)         dS = P * (dP - delta)
//   dQ = dS K * scale              dK = dS^T Q * scale
//   q, k, v, dO    : (B, H, L, d) float32 or bfloat16, any b/h/l strides, unit d stride
//   mask           : optional (L, L) float32 additive, shared by batch and heads
//   dq, dk, dv     : (B, H, L, d) in q's dtype, any b/h/l strides
// delta comes from the unrounded P, not from rowsum(dO * O) as in the flash
// backward: in bf16 the two differ, since O was computed from a rounded P and
// rounded itself.  dO, V, Q and K are upcast to fp32; each output is cast to
// its input's dtype once, at the end.  The mask takes no gradient.
//
// Design.  The TPU kernel holds the whole (Lp, Lp) P of one (b*h) in VMEM
// (:99-111 and :183-195), which an SM cannot (fused_attn_fwd.cu).  Three
// kernels, each output element with one writer (no atomics):
//   stats: one CTA per (b*h, query tile) walks the key tiles once, computing
//          S and dP, and folds them into each row's max m, sum l and
//          u = sum exp(S - m) dP (online, as the forward's pass 1); it writes
//          m, l and delta = u / l, (B, H, L) fp32 each;
//   dK/dV, dQ: attn_bwd_dkv_kernel / attn_bwd_dq_kernel of blockwise_attn.cuh
//          at kWholeRow = true, which recompute P = exp(S - m) / l from
//          those statistics (the blockwise backward's tiles and loops).
// Templated on D in {32, 64, 128}; d <= D is zero-padded in shared memory.
//
// What bounds it on this card: at CLIP's shapes (L <= 201) the bytes (q, k,
// v, dO read, dq, dk, dv written), against 10 * B*H*L^2*d operations.  This
// first version does every product with fp32 FMAs on the CUDA cores (no
// tensor cores, no TMA), recomputing S three times and dP twice, so it is
// bound by those FMAs.

#include "blockwise_attn.cuh"

namespace {

using namespace blockwise;

template <int D>
struct Stats {
  using F = Bwd<D>;
  // the Q and dO tiles, a K and a V tile
  static constexpr int kSmemBytes = (2 * F::kBO * F::kS + 2 * F::kBS * F::kS) * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_attn_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            const float* __restrict__ mask, float* __restrict__ row_max,
                            float* __restrict__ row_sum, float* __restrict__ delta, int H, int L,
                            int d, float scale, Strides st) {
  using F = Bwd<D>;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* Qs = reinterpret_cast<float*>(smem4);  // this CTA's Q tile   [query][d]
  float* Gs = Qs + F::kBO * F::kS;              // this CTA's dO tile  [query][d]
  float* Ks = Gs + F::kBO * F::kS;              // streamed K tile     [key][d]
  float* Vs = Ks + F::kBS * F::kS;              // streamed V tile     [key][d]

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

  float m[kRows], l[kRows], u[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMInit;
    l[i] = u[i] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += F::kBS) {
    __syncthreads();  // the previous key tile's K and V are no longer read
    load_rows<F::kBS, D>(Ks, F::kS, kp, st.s[1][2], k0, L, d);
    load_rows<F::kBS, D>(Vs, F::kS, vp, st.s[2][2], k0, L, d);
    __syncthreads();
    float s[kRows][F::kSC], dp[kRows][F::kSC];
    rows_dot<D>(s, Qs, rg * kRows, Ks, cg);   // S: this thread's queries x keys
    rows_dot<D>(dp, Gs, rg * kRows, Vs, cg);  // dP = dO V^T
    scale_and_mask<D>(s, q0, k0, rg, cg, L, scale, mask);
    fold_row_stats<D, true>(s, dp, m, l, u);
  }
  merge_row_stats<F::kCG, true>(m, l, u);

  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + rg * kRows + i;
      if (row < L) {
        const long long at = (long long)bh * L + row;
        row_max[at] = m[i];
        row_sum[at] = l[i];
        delta[at] = u[i] / l[i];
      }
    }
  }
}

template <typename T, int D>
int launch_stats(const void* q, const void* k, const void* v, const void* g, const void* mask,
                 void* row_max, void* row_sum, void* delta, int B, int H, int L, int d,
                 float scale, const long long* strides, cudaStream_t stream) {
  constexpr int kSmem = Stats<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fused_attn_bwd_stats_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + Bwd<D>::kBO - 1) / Bwd<D>::kBO);
  fused_attn_bwd_stats_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(mask), static_cast<float*>(row_max),
      static_cast<float*>(row_sum), static_cast<float*>(delta), H, L, d, scale,
      unpack(strides, 4));
  return (int)cudaGetLastError();
}

template <typename T>
int stats_dim(const void* q, const void* k, const void* v, const void* g, const void* mask,
              void* row_max, void* row_sum, void* delta, int B, int H, int L, int d, float scale,
              const long long* st, cudaStream_t s) {
  switch (padded_dim(d)) {
    case 32: return launch_stats<T, 32>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    case 64: return launch_stats<T, 64>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    case 128: return launch_stats<T, 128>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d: the head dim, 1..128.  strides: 12
// element strides, the (b, h, l) strides of q, k, v and dO.  mask may be
// null.  row_max, row_sum and delta: (B, H, L) float32, contiguous, written.
// Launches on the current device, which the caller sets to the tensors'.
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
int fsvlm_fused_attn_bwd_stats(int dtype, int d, const void* q, const void* k, const void* v,
                               const void* g, const void* mask, void* row_max, void* row_sum,
                               void* delta, int B, int H, int L, float scale,
                               const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stats_dim<float>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale,
                            strides, s);
  if (dtype == 1)
    return stats_dim<__nv_bfloat16>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d,
                                    scale, strides, s);
  return (int)cudaErrorInvalidValue;
}

// As the blockwise entries, with the pre-pass's row_max, row_sum and delta:
// strides are the 18 of q, k, v, dO, dK and dV.
int fsvlm_fused_attn_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v,
                             const void* g, const void* row_max, const void* row_sum,
                             const void* delta, const void* mask, void* dk, void* dv, int B,
                             int H, int L, float scale, const long long* strides, void* stream) {
  return blockwise::bwd_entry<true, true>(dtype, d, q, k, v, g, row_max, row_sum, delta, mask,
                                          dk, dv, B, H, L, scale, strides, stream);
}

// As above, with one output: strides are the 15 of q, k, v, dO and dQ.
int fsvlm_fused_attn_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v,
                            const void* g, const void* row_max, const void* row_sum,
                            const void* delta, const void* mask, void* dq, int B, int H, int L,
                            float scale, const long long* strides, void* stream) {
  return blockwise::bwd_entry<true, false>(dtype, d, q, k, v, g, row_max, row_sum, delta, mask,
                                           dq, nullptr, B, H, L, scale, strides, stream);
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
