// Whole-sequence attention backward at any head dim, hand-written for Hopper
// (sm_90a): a row pre-pass, then dK/dV and dQ.
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
//   dK/dV, dQ: recompute P = exp(S - m) / l from those statistics; dK/dV
//          one CTA per (b*h, key tile) walking the query tiles, dQ one per
//          (b*h, query tile) walking the key tiles.
// Templated on D in {32, 64, 128, 192, 256}; d <= D is zero-padded in shared
// memory; past d = 256 the FMA tiles run at D = 256 in column passes
// (blockwise_attn.cuh) for both dtypes, the pre-pass summing S and dP over
// the whole head dim 256 columns at a time.  bf16 at D = 192 and 256 reads
// Q and dO from shared memory rather than holding them (mma_attn.cuh), and
// its dK/dV and dQ kernels write two column passes of D / 2.
//
// bf16: every product is mma.sync m16n8k16 bf16 -> fp32 (mma_attn.cuh), on
// bf16 tiles copied into shared memory by cp.async, with the forward's work
// layout (fused_attn_fwd.cu): one warp per 16 own rows, CTAs of 64 rows
// sharing double-buffered 64-row streamed tiles at L > 32, and one whole
// (b*h) per warp at L <= 32.  The stats pre-pass is below; dK/dV (one warp
// per 16 keys, on S^T = K Q^T and dP^T = V dO^T) and dQ (one warp per 16
// queries) are mma_attn.cuh's dkv/dq kernels.  P and dS, fp32 on the TPU,
// enter dV = P^T dO, dK = dS^T Q and dQ = dS K from their accumulator
// registers split into bf16 hi + lo parts, two products each.
// float32: the FMA tiles, the pre-pass below and attn_bwd_dkv_kernel /
// attn_bwd_dq_kernel of blockwise_attn.cuh at kWholeRow = true.
//
// What bounds it on this card: at CLIP's shapes (L <= 201) the bytes (q, k,
// v, dO read, dq, dk, dv written), against 10 * B*H*L^2*d operations (16
// with the hi/lo products): at most about 1.6 * 10 L / 8 operations per
// byte, under the H100's ridge of about 295 bf16 operations per byte at
// L <= 147 and near it at 201, so mma.sync fed by async copies suffices.
// The three kernels recompute S three times and dP twice; at these
// lengths those products are cheap on the tensor cores.

#include "blockwise_attn.cuh"
#include "mma_attn.cuh"

namespace {

// ------------------------------------------------------------- bf16: mma.sync
using mma_attn::bf16;

#define FSVLM_STATS_PARAMS                                                                     \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,         \
      const bf16 *__restrict__ g, const float *__restrict__ mask, float *__restrict__ row_max, \
      float *__restrict__ row_sum, float *__restrict__ delta, int BH, int H, int L, int d,     \
      float scale, blockwise::Strides st, int vec

// Fold a key tile (rows 0 .. 8 * NT - 1 of Ks and Vs, keys key0 ..) into one
// warp's running m, l and u = sum exp(S - m) dP, 16 keys at a time; Q and dO
// from the held A fragments qa, ga at D <= 128, else from rows own .. of the
// Qs, Gs tiles.
template <int D, int NT>
__device__ __forceinline__ void stats_tile(uint32_t (&qa)[D <= 128 ? D / 16 : 1][4],
                                           uint32_t (&ga)[D <= 128 ? D / 16 : 1][4],
                                           const bf16* Qs, const bf16* Gs, int own,
                                           const bf16* Ks, const bf16* Vs, int row0, int key0,
                                           int L, float scale, const float* __restrict__ mask,
                                           float m[2], float l[2], float u[2], int lane) {
  using namespace mma_attn;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (key0 + 16 * kk >= L) break;
    float s[2][4], dp[2][4];
    scores_from<D, 2>(s, qa, false, Qs, own, Ks, 16 * kk, lane);   // S = Q K^T
    scores_from<D, 2>(dp, ga, false, Gs, own, Vs, 16 * kk, lane);  // dP = dO V^T
    scores_log2<2>(s, row0, key0 + 16 * kk, L, scale * kLog2e, mask, lane);
    fold<2, true>(s, dp, m, l, u);
  }
}

// After merge_quad: m, l and delta = u / l of rows row0 + g, + 8 (lane t = 0).
__device__ __forceinline__ void write_stats(float* row_max, float* row_sum, float* delta,
                                            long long at, int row0, int L, const float m[2],
                                            const float l[2], const float u[2], int lane) {
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row < L) {
      row_max[at + row] = m[r] * mma_attn::kLn2;  // natural units
      row_sum[at + row] = l[r];
      delta[at + row] = u[r] / l[r];
    }
  }
}

// L > 32: one CTA per (b*h, 64-query tile), warp w owning rows 16w ..; the
// K and V tiles double-buffered.
template <int D>
__global__ void __launch_bounds__(mma_attn::kThreads) stats_tiled_kernel(FSVLM_STATS_PARAMS) {
  using namespace mma_attn;
  constexpr int kT = kTile * Tile<D>::kS;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // own Q            [query][d]
  bf16* Gs = Qs + kT;                         // own dO           [query][d]
  bf16* Ks = Gs + kT;                         // 2 x streamed K   [key][d]
  bf16* Vs = Ks + 2 * kT;                     // 2 x streamed V   [key][d]
  int q0;
  const int bh = tiled_head(L, q0), b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const bf16* vp = v + b * st.s[2][0] + h * st.s[2][1];
  load_tile<kTile, D>(Qs, q + b * st.s[0][0] + h * st.s[0][1], st.s[0][2], q0, L, d, tid, kThreads, vec);
  load_tile<kTile, D>(Gs, g + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], q0, L, d, tid, kThreads, vec);
  auto prefetch = [&](int s) {
    load_tile<kTile, D>(Ks + (s & 1) * kT, kp, st.s[1][2], s * kTile, L, d, tid, kThreads, vec);
    load_tile<kTile, D>(Vs + (s & 1) * kT, vp, st.s[2][2], s * kTile, L, d, tid, kThreads, vec);
    cp_async_commit();
  };
  prefetch(0);
  const int own = 16 * warp, row0 = q0 + own;
  const bool active = row0 < L;
  uint32_t qa[D <= 128 ? D / 16 : 1][4], ga[D <= 128 ? D / 16 : 1][4];
  float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  const int n = (L + kTile - 1) / kTile;
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) prefetch(s + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      if constexpr (D <= 128) {
        if (s == 0) {
          load_a<D>(qa, Qs, own, lane);
          load_a<D>(ga, Gs, own, lane);
        }
      }
      stats_tile<D, kTile / 8>(qa, ga, Qs, Gs, own, Ks + (s & 1) * kT, Vs + (s & 1) * kT, row0,
                               s * kTile, L, scale, mask, m, l, u, lane);
    }
    __syncthreads();
  }
  if (active) {
    merge_quad<true>(m, l, u);
    write_stats(row_max, row_sum, delta, (long long)bh * L, row0, L, m, l, u, lane);
  }
}

// L <= R (16 or 32): every warp one whole (b*h), its Q, dO, K and V in tiles
// of R rows.
template <int D, int R>
__global__ void __launch_bounds__(mma_attn::kThreads) stats_packed_kernel(FSVLM_STATS_PARAMS) {
  using namespace mma_attn;
  constexpr int kT = R * Tile<D>::kS;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x * (kThreads / 32) + warp;
  if (bh >= BH) return;
  const int b = bh / H, h = bh - b * H;
  bf16* Qs = reinterpret_cast<bf16*>(smem4) + warp * 4 * kT;
  bf16* Gs = Qs + kT;
  bf16* Ks = Gs + kT;
  bf16* Vs = Ks + kT;
  load_tile<R, D>(Qs, q + b * st.s[0][0] + h * st.s[0][1], st.s[0][2], 0, L, d, lane, 32, vec);
  load_tile<R, D>(Gs, g + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], 0, L, d, lane, 32, vec);
  load_tile<R, D>(Ks, k + b * st.s[1][0] + h * st.s[1][1], st.s[1][2], 0, L, d, lane, 32, vec);
  load_tile<R, D>(Vs, v + b * st.s[2][0] + h * st.s[2][1], st.s[2][2], 0, L, d, lane, 32, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
#pragma unroll 1
  for (int mt = 0; mt < R / 16; ++mt) {
    if (16 * mt >= L) break;
    uint32_t qa[D / 16][4], ga[D / 16][4];
    load_a<D>(qa, Qs, 16 * mt, lane);
    load_a<D>(ga, Gs, 16 * mt, lane);
    float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
    stats_tile<D, R / 8>(qa, ga, Qs, Gs, 16 * mt, Ks, Vs, 16 * mt, 0, L, scale, mask, m, l, u,
                         lane);
    merge_quad<true>(m, l, u);
    write_stats(row_max, row_sum, delta, (long long)bh * L, 16 * mt, L, m, l, u, lane);
  }
}

template <int D>
int launch_stats_bf16(const void* q, const void* k, const void* v, const void* g,
                      const void* mask, void* row_max, void* row_sum, void* delta, int B, int H,
                      int L, int d, float scale, const long long* strides, cudaStream_t stream) {
  using namespace mma_attn;
  const void* ptrs[4] = {q, k, v, g};
  const int vec = vec_ok(ptrs, 4, strides, 12);
  const int BH = B * H;
  auto run = [&](auto kernel, dim3 grid, int smem) {
    return mma_attn::launch(kernel, grid, smem, stream, static_cast<const bf16*>(q),
                            static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                            static_cast<const bf16*>(g), static_cast<const float*>(mask),
                            static_cast<float*>(row_max), static_cast<float*>(row_sum),
                            static_cast<float*>(delta), BH, H, L, d, scale,
                            blockwise::unpack(strides, 4), vec);
  };
  const dim3 packed((BH + kThreads / 32 - 1) / (kThreads / 32));
  if constexpr (D <= 128) {
    switch (pack_rows(L)) {
      case 16: return run(stats_packed_kernel<D, 16>, packed, packed_smem<D, 16>(4));
      case 32: return run(stats_packed_kernel<D, 32>, packed, packed_smem<D, 32>(4));
      default: break;
    }
  }
  return run(stats_tiled_kernel<D>, tiled_grid(BH, L), 6 * Tile<D>::kRowsBytes);
}

int stats_bf16_dim(const void* q, const void* k, const void* v, const void* g, const void* mask,
                   void* row_max, void* row_sum, void* delta, int B, int H, int L, int d,
                   float scale, const long long* st, cudaStream_t s) {
  switch (blockwise::padded_dim(d)) {
    case 32: return launch_stats_bf16<32>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    case 64: return launch_stats_bf16<64>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    case 128: return launch_stats_bf16<128>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    case 192: return launch_stats_bf16<192>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    case 256: return launch_stats_bf16<256>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------- float32: FMA tiles
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

  const int nd = passes(d, D);
  const T* qp = q + b * st.s[0][0] + h * st.s[0][1];
  const T* gp = g + b * st.s[3][0] + h * st.s[3][1];
  const T* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const T* vp = v + b * st.s[2][0] + h * st.s[2][1];
  if (nd == 1) {
    load_rows<F::kBO, D>(Qs, F::kS, qp, st.s[0][2], q0, L, d);
    load_rows<F::kBO, D>(Gs, F::kS, gp, st.s[3][2], q0, L, d);
  }

  float m[kRows], l[kRows], u[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMInit;
    l[i] = u[i] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += F::kBS) {
    // S and dP = dO V^T: this thread's queries x keys, over the whole head dim
    // (the previous key tile's K and V are no longer read past the first barrier)
    float s[kRows][F::kSC], dp[kRows][F::kSC];
    dots_over_d<D, true>(s, dp, Qs, Gs, Ks, Vs, qp, gp, st.s[0][2], st.s[3][2], q0, kp, vp,
                         st.s[1][2], st.s[2][2], k0, L, d, nd, rg, cg);
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
    case 192: return launch_stats<T, 192>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    case 256: return launch_stats<T, 256>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dK/dV (kDkv) or dQ kernel over the dtype code: float32 on the FMA
// tiles (blockwise_attn.cuh, kWholeRow), bfloat16 on mma.sync (mma_attn.cuh)
// up to d = 256 and on the FMA tiles past it.
template <bool kDkv>
int whole_row_bwd(int dtype, int d, const void* q, const void* k, const void* v, const void* g,
                  const void* row_max, const void* row_sum, const void* delta, const void* mask,
                  void* out0, void* out1, int B, int H, int L, float scale,
                  const long long* strides, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return blockwise::bwd_dim<float, true, kDkv>(q, k, v, g, row_max, row_sum, delta, mask, out0,
                                                 out1, B, H, L, d, scale, strides, s);
  if (dtype == 1 && d > 256)
    return blockwise::bwd_dim<__nv_bfloat16, true, kDkv>(q, k, v, g, row_max, row_sum, delta,
                                                         mask, out0, out1, B, H, L, d, scale,
                                                         strides, s);
  if (dtype == 1)
    return mma_attn::bwd_entry<kDkv>(d, q, k, v, g, row_max, row_sum, delta, mask, out0, out1, B,
                                     H, L, scale, strides, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  d: the head dim, any d >= 1.  strides: 12
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
  if (dtype == 1 && d > 256)
    return stats_dim<__nv_bfloat16>(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale,
                                    strides, s);
  if (dtype == 1)
    return stats_bf16_dim(q, k, v, g, mask, row_max, row_sum, delta, B, H, L, d, scale, strides,
                          s);
  return (int)cudaErrorInvalidValue;
}

// As the blockwise entries, with the pre-pass's row_max, row_sum and delta:
// strides are the 18 of q, k, v, dO, dK and dV.
int fsvlm_fused_attn_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v,
                             const void* g, const void* row_max, const void* row_sum,
                             const void* delta, const void* mask, void* dk, void* dv, int B,
                             int H, int L, float scale, const long long* strides, void* stream) {
  return whole_row_bwd<true>(dtype, d, q, k, v, g, row_max, row_sum, delta, mask, dk, dv, B, H, L,
                             scale, strides, stream);
}

// As above, with one output: strides are the 15 of q, k, v, dO and dQ.
int fsvlm_fused_attn_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v,
                            const void* g, const void* row_max, const void* row_sum,
                            const void* delta, const void* mask, void* dq, int B, int H, int L,
                            float scale, const long long* strides, void* stream) {
  return whole_row_bwd<false>(dtype, d, q, k, v, g, row_max, row_sum, delta, mask, dq, nullptr, B,
                              H, L, scale, strides, stream);
}

const char* fsvlm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
