// Blockwise flash-attention backward at any head dim, hand-written for Hopper
// (sm_90a): two kernels, dK/dV and dQ.
//
// Replaces fsvlm_tpu/ops/flash_attention.py::_blockwise_dkv_kernel (:324,
// pallas_call at :465) and ::_blockwise_dq_kernel (:372, pallas_call at
// :492), the backward of blockwise_attention (:433-513).  Same function, per
// (batch, head), from the forward's LSE and the pre-pass
// delta = rowsum(dO * O) (computed outside any kernel, as at :458-460):
//   S  = Q K^T * scale + mask      P  = exp(S - LSE)      (fp32, P not rounded)
//   dV = P^T dO                    dP = dO V^T
//   dS = P (dP - delta)            dK = dS^T Q * scale    dQ = dS K * scale
//   q, k, v, dO    : (B, H, L, d) float32 or bfloat16, any b/h/l strides, unit d stride
//   lse, delta     : (B, H, L) float32, contiguous
//   mask           : optional (L, L) float32 additive, shared by batch and heads
//   dq, dk, dv     : (B, H, L, d) in q's dtype, any b/h/l strides
// Every product accumulates in fp32, and each output is cast to the input
// dtype once, at the end (TPU kernel :334-369, :380-406).  Keys and queries
// at or past L get P = 0 instead of padding in memory.  A -inf mask entry
// gives P = 0 and so dS = 0; a row whose keys are all masked has LSE ~ -1e30
// from the forward and gets zero gradients.  The head dim d is zero-padded
// in shared memory to the instantiation D in {32, 64, 128, 192, 256} that
// holds it (the TPU pads to 128 lanes, :281); only dims below d are stored.
// Past d = 256 both dtypes run the FMA tiles at D = 256 in column passes
// (blockwise_attn.cuh); bf16 at D = 192 and 256 writes two column passes of
// D / 2 on the tensor cores (mma_attn.cuh).
//
// Grid.  The TPU kernels carry dK/dV (and dQ) in scratch across a
// sequential grid axis (grid=(B*H, n_kv, n_q) at :467, (B*H, n_q, n_kv) at
// :494); Hopper runs blocks in no order, so that axis is a loop inside the
// CTA: dK/dV one CTA per (b*h, key tile) keeps its K and V tile and its fp32
// dK and dV accumulators on chip and walks the query tiles; dQ one CTA per
// (b*h, query tile) walks the key tiles.  Every output element is written
// by exactly one CTA: no atomics, and the result is deterministic.
//
// bfloat16 takes the tensor-core kernels of mma_attn.cuh reading the LSE
// (kLse), the same ones as the d = 64 backward (flash_attn_bwd.cu) and, from
// its row max and sum, the whole-sequence backward (fused_attn_bwd.cu):
// mma.sync m16n8k16 on bf16 tiles copied by cp.async, one warp per 16 own
// rows.  S and dP take the bf16 inputs, whose products the fp32
// accumulator holds exactly; P and dS, fp32 operands on the TPU, go to the
// tensor cores from their accumulator registers split into bf16 hi + lo
// parts, two products each.  L > 32: CTAs of Warps<D> warps, 16 own rows
// each, walk 64-row tiles of the other side, double-buffered; L <= 32 (the
// text passes): every warp one whole (b*h).  The warp counts are the
// faster, at the vision shapes (48, 24 / 12 / 6, 201, D), of 4 and 8 that
// does not spill (compare_bwd_ctas.py times both).  What bounds it on this
// card: at CLIP's shapes (L <= 201) the bytes, q, k, v, dO read and the
// outputs written, against 8 (dK/dV) and 6 (dQ) L^2 d operations per head,
// 1.6x that with the hi/lo products: under the H100's ridge of about 295
// bf16 operations per byte.
//
// float32 keeps the first version, fp32 FMAs on the CUDA cores (the
// agreement checks' fp32 limit of 1e-5 is tighter than TF32 tensor cores
// can meet), bound by those FMAs: attn_bwd_dkv_kernel and
// attn_bwd_dq_kernel of blockwise_attn.cuh at kWholeRow = false (the
// whole-sequence backward runs them at true).  128 threads per CTA; every
// tile lives in shared memory as fp32 rows padded by four floats; own
// tiles of 64 rows at D = 32 and 64, 32 at D = 128 (blockwise_attn.cuh's
// Bwd<D>).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "blockwise_attn.cuh"
#include "mma_attn.cuh"

namespace {

// warps per CTA of the bf16 tiled kernels (L > 32), dK/dV and dQ, per D.  By
// device time on an H100 at the vision shapes: D = 32 dK/dV 4 warps 14%
// faster, dQ 8 warps 7%; D = 64 dK/dV a tie (4, #7's instantiation), dQ 8
// warps 3%; D = 128 8 warps for both, 1.5% and 7% (one 136 KiB CTA per SM,
// each streamed tile copied half as often).  None spills.  D = 192 and 256:
// 4 warps, untimed (8 would take 200 and 264 KiB of shared memory).
template <int D> struct Warps;
template <> struct Warps<32> { static constexpr int kDkv = 4, kDq = 8; };
template <> struct Warps<64> { static constexpr int kDkv = 4, kDq = 8; };
template <> struct Warps<128> { static constexpr int kDkv = 8, kDq = 8; };
template <> struct Warps<192> { static constexpr int kDkv = 4, kDq = 4; };
template <> struct Warps<256> { static constexpr int kDkv = 4, kDq = 4; };

template <int D, bool kDkv>
int launch_bf16(const void* q, const void* k, const void* v, const void* g, const void* lse,
                const void* delta, const void* mask, void* out0, void* out1, int B, int H, int L,
                int d, float scale, const long long* strides, cudaStream_t s) {
  constexpr int W = kDkv ? Warps<D>::kDkv : Warps<D>::kDq;
  return mma_attn::launch_bwd<D, kDkv, /*kLse=*/true, W>(q, k, v, g, lse, nullptr, delta, mask,
                                                         out0, out1, B, H, L, d, scale, strides,
                                                         s);
}

// The dK/dV (kDkv) or dQ kernel over the dtype code (0 = float32 on the
// FMA tiles, 1 = bfloat16 on mma.sync up to d = 256, on the FMA tiles past
// it) at the instantiation that holds d.
template <bool kDkv>
int entry(int dtype, int d, const void* q, const void* k, const void* v, const void* g,
          const void* lse, const void* delta, const void* mask, void* out0, void* out1, int B,
          int H, int L, float scale, const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return blockwise::bwd_dim<float, false, kDkv>(q, k, v, g, lse, nullptr, delta, mask, out0,
                                                  out1, B, H, L, d, scale, strides, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (d > 256)
    return blockwise::bwd_dim<__nv_bfloat16, false, kDkv>(q, k, v, g, lse, nullptr, delta, mask,
                                                          out0, out1, B, H, L, d, scale, strides,
                                                          s);
  switch (blockwise::padded_dim(d)) {
    case 32: return launch_bf16<32, kDkv>(q, k, v, g, lse, delta, mask, out0, out1, B, H, L, d, scale, strides, s);
    case 64: return launch_bf16<64, kDkv>(q, k, v, g, lse, delta, mask, out0, out1, B, H, L, d, scale, strides, s);
    case 128: return launch_bf16<128, kDkv>(q, k, v, g, lse, delta, mask, out0, out1, B, H, L, d, scale, strides, s);
    case 192: return launch_bf16<192, kDkv>(q, k, v, g, lse, delta, mask, out0, out1, B, H, L, d, scale, strides, s);
    case 256: return launch_bf16<256, kDkv>(q, k, v, g, lse, delta, mask, out0, out1, B, H, L, d, scale, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d: the head dim, any d >= 1.  strides: 18
// element strides, the (b, h, l) strides of q, k, v, dO, dK and dV in that
// order.  mask may be null.  Launches on the current device, which the
// caller sets to the tensors'.  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
int fsvlm_blockwise_attn_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, const void* delta,
                                 const void* mask, void* dk, void* dv, int B, int H, int L,
                                 float scale, const long long* strides, void* stream) {
  return entry<true>(dtype, d, q, k, v, g, lse, delta, mask, dk, dv, B, H, L, scale, strides,
                     stream);
}

// As above, with one output: strides are the 15 of q, k, v, dO and dQ.
int fsvlm_blockwise_attn_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v,
                                const void* g, const void* lse, const void* delta,
                                const void* mask, void* dq, int B, int H, int L, float scale,
                                const long long* strides, void* stream) {
  return entry<false>(dtype, d, q, k, v, g, lse, delta, mask, dq, nullptr, B, H, L, scale,
                      strides, stream);
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
