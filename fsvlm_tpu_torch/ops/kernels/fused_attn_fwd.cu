// Whole-sequence attention forward at any head dim, hand-written for Hopper
// (sm_90a).
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
// 4 MB, over the 227 KB of shared memory).  So the keys are walked twice:
// pass 1 folds each key tile into every row's running max m and sum l
// (online, per thread, then merged over the lanes that share a row); pass 2
// recomputes S, forms P = exp(S - m) / l, rounds it to the input dtype and
// accumulates P V.  That is the same function at any L, up to the order of
// fp32 sums, and no tile is sized by L.  Head dims are instantiated at D in
// {32, 64, 128, 192, 256}, d <= D zero-padded in shared memory; past d = 256
// the FMA tiles run at D = 256 in column passes (blockwise_attn.cuh), for
// both dtypes: each pass sums S over the whole head dim, 256 columns at a
// time, and writes 256 columns of O.
//
// bf16 (mma_attn.cuh): one warp owns 16 query rows.  S = Q K^T and O += P V
// are mma.sync m16n8k16 products with fp32 accumulators; P goes from S's
// accumulator registers straight into the A fragment of P V.  Tiles are
// bf16 in shared memory, copied by cp.async.
//   L > 32: a CTA of 4 warps takes 64 rows of one (b*h) and shares 64-key
//     K/V tiles, double-buffered so that the next tile loads while the
//     current one is multiplied; at L <= 64 S is one tile, computed once
//     and reused by pass 2.
//   L <= 32 (CoOp's text 24, CoCoOp's 16): every warp takes one whole
//     (b*h), one or two 16-row tiles, against that head's whole K and V,
//     which it loads itself; no 64-row tile is padded out of 16 rows.
//   D > 128: the tiled layout at every L, Q read from shared memory 16
//     columns at a time rather than held (mma_attn.cuh).
// float32 keeps the FMA tiles of blockwise_attn.cuh (Bwd<D>: 64 query rows,
// 64-key tiles; 32 rows at D = 128): the agreement checks' fp32 limits are
// tighter than TF32 tensor cores can meet.
//
// What bounds it on this card: at CLIP's shapes (L <= 201) the bytes,
// 4*B*H*L*d elements (q, k, v read once, o written once) against
// 4*B*H*L^2*d operations: about L/2 operations per byte, under the H100's
// ridge of about 295 bf16 operations per byte, so mma.sync fed by async
// copies suffices and wgmma/TMA would buy nothing at these lengths.  The
// fp32 version is bound by its FMAs.

#include "blockwise_attn.cuh"
#include "mma_attn.cuh"

namespace {

// ------------------------------------------------------------- bf16: mma.sync
using mma_attn::bf16;

#define FSVLM_FWD_PARAMS                                                                     \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,         \
      const float *__restrict__ mask, bf16 *__restrict__ o, int BH, int H, int L, int d,     \
      float scale, blockwise::Strides st, int vec

// L > 32: one CTA per (b*h, 64-query tile); warp w owns rows 16w .. 16w + 15.
// Steps: pass 1 over the key tiles (K only), then pass 2 (K and V); at
// L <= 64 one step does both.  Step s + 1's tiles load while step s computes.
template <int D>
__global__ void __launch_bounds__(mma_attn::kThreads) fwd_tiled_kernel(FSVLM_FWD_PARAMS) {
  using namespace mma_attn;
  constexpr int kT = kTile * Tile<D>::kS, NT = kTile / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // own Q            [query][d]
  bf16* Ks = Qs + kT;                         // 2 x streamed K   [key][d]
  bf16* Vs = Ks + 2 * kT;                     // 2 x streamed V   [key][d]
  int q0;
  const int bh = tiled_head(L, q0), b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const bf16* vp = v + b * st.s[2][0] + h * st.s[2][1];
  const int n = (L + kTile - 1) / kTile;
  const bool single = n == 1;
  const int steps = single ? 1 : 2 * n;
  auto prefetch = [&](int s) {
    const int k0 = (s % n) * kTile;
    load_tile<kTile, D>(Ks + (s & 1) * kT, kp, st.s[1][2], k0, L, d, tid, kThreads, vec);
    if (single || s >= n)
      load_tile<kTile, D>(Vs + (s & 1) * kT, vp, st.s[2][2], k0, L, d, tid, kThreads, vec);
    cp_async_commit();
  };
  load_tile<kTile, D>(Qs, q + b * st.s[0][0] + h * st.s[0][1], st.s[0][2], q0, L, d, tid, kThreads, vec);
  prefetch(0);
  const int own = 16 * warp, row0 = q0 + own;
  const bool active = row0 < L;
  uint32_t qa[D <= 128 ? D / 16 : 1][4];
  float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f}, acc[D / 8][4];
  zero_acc<D>(acc);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) prefetch(s + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const int k0 = (s % n) * kTile;
      float x[NT][4];
      scores_from<D, NT>(x, qa, s == 0, Qs, own, Ks + (s & 1) * kT, 0, lane);
      scores_log2<NT>(x, row0, k0, L, scale * kLog2e, mask, lane);
      if (s < n) {
        fold<NT, false>(x, x, m, l, nullptr);
        if (s == n - 1) merge_quad<false>(m, l, nullptr);
      }
      if (single || s >= n) pv<D, NT>(acc, x, m, l, Vs + (s & 1) * kT, k0, L, lane);
    }
    __syncthreads();
  }
  if (active)
    store_acc<D>(o + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], row0, L, d, acc, 1.f, lane, vec);
}

// L <= R (16 or 32): every warp one whole (b*h): its Q, K and V in tiles of R
// rows, S of each 16-row tile computed once.  (At least one CTA per SM: with
// the default register budget D = 32, R = 32 spilled.)
template <int D, int R>
__global__ void __launch_bounds__(mma_attn::kThreads, 1) fwd_packed_kernel(FSVLM_FWD_PARAMS) {
  using namespace mma_attn;
  constexpr int kT = R * Tile<D>::kS, NT = R / 8;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x * (kThreads / 32) + warp;
  if (bh >= BH) return;
  const int b = bh / H, h = bh - b * H;
  bf16* Qs = reinterpret_cast<bf16*>(smem4) + warp * 3 * kT;
  bf16* Ks = Qs + kT;
  bf16* Vs = Ks + kT;
  load_tile<R, D>(Qs, q + b * st.s[0][0] + h * st.s[0][1], st.s[0][2], 0, L, d, lane, 32, vec);
  load_tile<R, D>(Ks, k + b * st.s[1][0] + h * st.s[1][1], st.s[1][2], 0, L, d, lane, 32, vec);
  load_tile<R, D>(Vs, v + b * st.s[2][0] + h * st.s[2][1], st.s[2][2], 0, L, d, lane, 32, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
#pragma unroll 1
  for (int mt = 0; mt < R / 16; ++mt) {
    if (16 * mt >= L) break;
    uint32_t qa[D / 16][4];
    load_a<D>(qa, Qs, 16 * mt, lane);
    float x[NT][4];
    mma_abt<D, NT>(x, qa, Ks, 0, lane);
    scores_log2<NT>(x, 16 * mt, 0, L, scale * kLog2e, mask, lane);
    float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f}, acc[D / 8][4];
    fold<NT, false>(x, x, m, l, nullptr);
    merge_quad<false>(m, l, nullptr);
    zero_acc<D>(acc);
    pv<D, NT>(acc, x, m, l, Vs, 0, L, lane);
    store_acc<D>(o + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], 16 * mt, L, d, acc, 1.f, lane, vec);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
                int H, int L, int d, float scale, const long long* strides, cudaStream_t stream) {
  using namespace mma_attn;
  const void* ptrs[4] = {q, k, v, o};
  const int vec = vec_ok(ptrs, 4, strides, 12);
  const int BH = B * H;
  auto run = [&](auto kernel, dim3 grid, int smem) {
    return mma_attn::launch(kernel, grid, smem, stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const float*>(mask), static_cast<bf16*>(o), BH, H, L, d, scale,
                  blockwise::unpack(strides, 4), vec);
  };
  const dim3 packed((BH + kThreads / 32 - 1) / (kThreads / 32));
  if constexpr (D <= 128) {
    switch (pack_rows(L)) {
      case 16: return run(fwd_packed_kernel<D, 16>, packed, packed_smem<D, 16>(3));
      case 32: return run(fwd_packed_kernel<D, 32>, packed, packed_smem<D, 32>(3));
      default: break;
    }
  }
  return run(fwd_tiled_kernel<D>, tiled_grid(BH, L), 5 * Tile<D>::kRowsBytes);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, int B, int H,
           int L, int d, float scale, const long long* strides, cudaStream_t stream);

int launch_bf16_dim(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
                    int H, int L, int d, float scale, const long long* strides, cudaStream_t s) {
  switch (blockwise::padded_dim(d)) {
    case 32: return launch_bf16<32>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
    case 64: return launch_bf16<64>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
    case 128: return launch_bf16<128>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
    case 192: return launch_bf16<192>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
    case 256:
      if (d <= 256) return launch_bf16<256>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
      return launch<bf16, 256>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------- float32: FMA tiles
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

  const int nd = passes(d, D), c0 = blockIdx.z * D;
  const T* qp = q + b * st.s[0][0] + h * st.s[0][1];
  const T* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const T* vp = v + b * st.s[2][0] + h * st.s[2][1];
  if (nd == 1) load_rows<F::kBO, D>(Qs, F::kS, qp, st.s[0][2], q0, L, d);

  // pass 1: the whole row's max and sum (each key tile's S over the whole
  // head dim; the barrier at its start: the previous key tile is no longer read)
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMInit;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += F::kBS) {
    float s[kRows][F::kSC];
    dots_over_d<D, false>(s, s, Qs, nullptr, Ks, nullptr, qp, qp, st.s[0][2], 0, q0, kp, kp,
                          st.s[1][2], 0, k0, L, d, nd, rg, cg);
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
    float s[kRows][F::kSC];
    if (nd == 1) {  // K and V in one step
      __syncthreads();  // the previous K, V and P tiles are no longer read
      load_rows<F::kBS, D>(Ks, F::kS, kp, st.s[1][2], k0, L, d);
      load_rows<F::kBS, D>(Vs, F::kS, vp, st.s[2][2], k0, L, d);
      __syncthreads();
      rows_dot<D>(s, Qs, rg * kRows, Ks, cg);
    } else {  // S over the head dim, then V's output columns
      dots_over_d<D, false>(s, s, Qs, nullptr, Ks, nullptr, qp, qp, st.s[0][2], 0, q0, kp, kp,
                            st.s[1][2], 0, k0, L, d, nd, rg, cg);
      out_columns<D, false>(Vs, nullptr, vp, vp, st.s[2][2], 0, k0, L, d, nd, c0);
    }
    scale_and_mask<D>(s, q0, k0, rg, cg, L, scale, mask);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < F::kSC; ++j) s[i][j] = to_f(from_f<T>(expf(s[i][j] - m[i]) / l[i]));
    store_transposed<D>(Ps, s, rg, cg);
    __syncthreads();
    cols_dot<D>(acc, Ps, rg * kRows, Vs, cg);
  }

  store_rows<D>(o + c0, st.s[3][0], st.s[3][1], st.s[3][2], b, h, q0, rg, cg, L, d - c0, acc, 1.f);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, int B, int H,
           int L, int d, float scale, const long long* strides, cudaStream_t stream) {
  constexpr int kSmem = Fused<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fused_attn_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + Bwd<D>::kBO - 1) / Bwd<D>::kBO, passes(d, D));
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
    case 192: return launch<T, 192>(q, k, v, mask, o, B, H, L, d, scale, strides, stream);
    case 256: return launch<T, 256>(q, k, v, mask, o, B, H, L, d, scale, strides, stream);
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
int fsvlm_fused_attn_fwd(int dtype, int d, const void* q, const void* k, const void* v,
                         const void* mask, void* o, int B, int H, int L, float scale,
                         const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(q, k, v, mask, o, B, H, L, d, scale, strides, s);
  if (dtype == 1) return launch_bf16_dim(q, k, v, mask, o, B, H, L, d, scale, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
