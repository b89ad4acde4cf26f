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
// The kernels are attn_bwd_dkv_kernel and attn_bwd_dq_kernel of
// blockwise_attn.cuh at kWholeRow = false (the whole-sequence backward,
// fused_attn_bwd.cu, runs them at true).  Templated on the head dim D in
// {32, 64, 128}; d <= D is zero-padded in shared memory.  128 threads per
// CTA, thread (rg, cg) = (tid / kCG, tid % kCG) owns rows rg*4 .. rg*4+3 of
// the CTA's own tile, rows cg + kCG*j of the streamed tile, and head dims in
// chunks of four.  Tile traits per D: 8 column groups and own tiles of 64
// rows at D = 32 and 64; at D = 128, 16 column groups and own tiles of 32
// rows, which keep a thread's two accumulators at 4 x 8 each (as at D = 64)
// and the fp32 tiles at 108.5 KiB (two CTAs per SM) instead of 4 x 16 and
// 144 KiB.
//
// What bounds it on this card: at CLIP's shapes (L <= 201) the bytes (q, k,
// v, dO read, the outputs written), against 8 (dK/dV) or 6 (dQ) * B*H*L^2*d
// operations.  This first version does every product with fp32 FMAs on the
// CUDA cores (no tensor cores, no TMA), so it is bound by those FMAs; its
// design only keeps S, P, dP and dS on chip.  Every tile lives in shared
// memory as fp32 rows padded by four floats, so that rows cg + kCG*j fall on
// distinct banks.

#include "blockwise_attn.cuh"

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
  return blockwise::bwd_entry<false, true>(dtype, d, q, k, v, g, lse, nullptr, delta, mask, dk,
                                           dv, B, H, L, scale, strides, stream);
}

// As above, with one output: strides are the 15 of q, k, v, dO and dQ.
int fsvlm_blockwise_attn_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v,
                                const void* g, const void* lse, const void* delta,
                                const void* mask, void* dq, int B, int H, int L, float scale,
                                const long long* strides, void* stream) {
  return blockwise::bwd_entry<false, false>(dtype, d, q, k, v, g, lse, nullptr, delta, mask, dq,
                                            nullptr, B, H, L, scale, strides, stream);
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
