// The bf16 flash-attention forward on the tensor cores, one pass over the
// keys with an online softmax, shared by two entries: flash_attn_fwd.cu
// (#6, fsvlm_tpu/ops/flash_attention.py::_hp_fwd_kernel :544, D = 64) and
// blockwise_attn_fwd.cu (#3, ::_blockwise_fwd_kernel :232, D = 32, 64,
// 128, 192, 256).  On the TPU the two differ only in head packing (:520-534), which
// the port does not carry over.  Per (batch, head), for each key tile:
//   S = Q K^T * scale + mask                     (fp32 accumulation)
//   m_new = max(m, rowmax S), m from -1e30;  alpha = exp(m - m_new)
//   p = exp(S - m_new);  l = l * alpha + sum p  (the unrounded p)
//   acc = acc * alpha + round(p, bf16) . V      (fp32 accumulation)
// then O = acc / max(l, 1e-30) in bf16 and LSE = m + log(max(l, 1e-30)) in
// fp32 (TPU kernels :245-271, :565-596).  P is rounded once, unnormalized,
// against the running max of its own key tile: the tile walk decides the
// bf16 rounding, so the plain version walks the same 64-key tiles at every
// D (flash_attention.py's BLOCK_K and BW_TILES).  Keys past L contribute
// nothing; rows past L are computed but not stored.
//
// Layout (the building blocks are mma_attn.cuh's): one warp owns 16 query
// rows; S = Q K^T and O += P V are mma.sync m16n8k16 products, and P goes
// from S's accumulator registers straight into the A fragment of P V.
//   L > 32: a CTA of 8 warps takes 128 rows of one (b*h) (Q loaded once and
//     held as A fragments) and walks 64-key K/V tiles, double-buffered by
//     cp.async so that the next tile loads while the current one is used.
//     8 warps rather than #1's 4: each K/V tile is copied once per 128 rows,
//     which halves the copies and barrier waits per row; it ran faster at
//     CLIP's vision shapes than 64-row CTAs of 4 warps (PERF.md section 6).
//   L <= 32 (the text passes): every warp takes one whole (b*h), one or two
//     16-row tiles against that head's whole K and V in one key tile.
//   D > 128: the tiled layout at every L, Q read from shared memory 16
//     columns at a time (mma_abt_s) rather than held: a warp's 16 x 256 fp32
//     accumulator alone is 128 registers a thread.
// The 4 lanes of a quad hold one row's columns of S and of acc, so they
// must rescale by one alpha: the row's max over a tile is taken across the
// quad (two shuffles per row) before it is exponentiated, and each lane's
// part of l is summed over the quad only at the end.  Scores are in log2
// units (scores_log2; one ex2 per exponential) and so is m, whose start is
// -1e30 in natural units: a row with no finite score keeps it, and gets
// O = 0 and LSE = -1e30 + log(1e-30) exactly, as the plain version does;
// the backward kernels read that LSE.
//
// What bounds it on this card: at CLIP's shapes (L <= 201) the bytes, q,
// k, v read once and O written once, against 4 L^2 d operations per head:
// about L / 2 operations per byte, under the H100's ridge of about 295.

#pragma once

#include "mma_attn.cuh"

namespace mma_attn {

constexpr float kMInitLog2 = kMInit * kLog2e;  // -1e30 in natural units
using blockwise::kLMin;
constexpr int kFlashWarps = 8;  // per CTA of the tiled kernel (L > 32)
constexpr int kFlashThreads = 32 * kFlashWarps, kFlashRows = 16 * kFlashWarps;

#define FSVLM_FLASH_PARAMS                                                                    \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,          \
      const float *__restrict__ mask, bf16 *__restrict__ o, float *__restrict__ lse, int BH,  \
      int H, int L, int d, float scale, Strides st, int vec

// One key tile of the online softmax for a warp's rows g and g + 8 (index
// r = 0, 1): x, the tile's scores in log2 units (keys key0 + ...), becomes
// p; m, this lane's part of l and acc are carried from tile to tile.
template <int D, int NT>
__device__ __forceinline__ void online_tile(float acc[D / 8][4], float m[2], float l[2],
                                            float x[NT][4], const bf16* v_tile, int key0, int L,
                                            int lane) {
  float alpha[2], se[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) mt = fmaxf(mt, fmaxf(x[j][2 * r], x[j][2 * r + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[r], mt);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[j][e] = ex2(x[j][e] - m[e >> 1]);
      se[e >> 1] += x[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], se[r]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
  // acc += round(p) V, 16 keys at a time; chunks wholly past L are skipped
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (key0 + 16 * kk >= L) break;
    uint32_t a[4];
    c_to_a(a, x[2 * kk], x[2 * kk + 1]);
    mma_ab<D, false>(acc, a, a, v_tile, 16 * kk, lane);
  }
}

// The end of a warp's rows row0 + g, + 8: l summed over the quad,
// O = acc / max(l, 1e-30) into one (b, h) slice of o, and from the quad's
// first lane LSE in natural units into lse_bh, this (b*h)'s row of LSE.
template <int D>
__device__ __forceinline__ void flash_store(bf16* o, long long sl, float* lse_bh, int row0, int L,
                                            int d, float acc[D / 8][4], const float m[2],
                                            float l[2], int lane, bool vec) {
  float lg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lg[r] = fmaxf(l[r], kLMin);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] /= lg[e >> 1];
  store_acc<D>(o, sl, row0, L, d, acc, 1.f, lane, vec);
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    // l = 0: no finite score, m still its start (m * ln 2 would round off -1e30)
    if (row < L) lse_bh[row] = (l[r] > 0.f ? m[r] * kLn2 : kMInit) + logf(lg[r]);
  }
}

// L > 32: one CTA per (b*h, 128-query tile); warp w owns rows 16w .. 16w + 15.
template <int D>
__global__ void __launch_bounds__(kFlashThreads) flash_tiled_kernel(FSVLM_FLASH_PARAMS) {
  constexpr int kT = kTile * Tile<D>::kS, NT = kTile / 8, kThreads = kFlashThreads;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // own Q (kFlashRows)  [query][d]
  bf16* Ks = Qs + 2 * kT;                     // 2 x streamed K      [key][d]
  bf16* Vs = Ks + 2 * kT;                     // 2 x streamed V      [key][d]
  int q0;
  const int bh = tiled_head(L, q0, kFlashRows), b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const bf16* vp = v + b * st.s[2][0] + h * st.s[2][1];
  auto prefetch = [&](int s) {
    load_tile<kTile, D>(Ks + (s & 1) * kT, kp, st.s[1][2], s * kTile, L, d, tid, kThreads, vec);
    load_tile<kTile, D>(Vs + (s & 1) * kT, vp, st.s[2][2], s * kTile, L, d, tid, kThreads, vec);
    cp_async_commit();
  };
  load_tile<kFlashRows, D>(Qs, q + b * st.s[0][0] + h * st.s[0][1], st.s[0][2], q0, L, d, tid,
                           kThreads, vec);
  prefetch(0);
  const int own = 16 * warp, row0 = q0 + own;
  const bool active = row0 < L;
  uint32_t qa[D <= 128 ? D / 16 : 1][4];
  float m[2] = {kMInitLog2, kMInitLog2}, l[2] = {0.f, 0.f}, acc[D / 8][4];
  zero_acc<D>(acc);
  const int n = (L + kTile - 1) / kTile;
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) prefetch(s + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      float x[NT][4];
      scores_from<D, NT>(x, qa, s == 0, Qs, own, Ks + (s & 1) * kT, 0, lane);
      scores_log2<NT>(x, row0, s * kTile, L, scale * kLog2e, mask, lane);
      online_tile<D, NT>(acc, m, l, x, Vs + (s & 1) * kT, s * kTile, L, lane);
    }
    __syncthreads();
  }
  if (active)
    flash_store<D>(o + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], lse + (long long)bh * L, row0,
                   L, d, acc, m, l, lane, vec);
}

// L <= R (16 or 32): every warp one whole (b*h), its Q, K and V in tiles of
// R rows, all keys in one tile.  (At least one CTA per SM, as #1's packed
// forward: the default register budget spilled there at D = 32, R = 32.)
template <int D, int R>
__global__ void __launch_bounds__(kThreads, 1) flash_packed_kernel(FSVLM_FLASH_PARAMS) {
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
    float m[2] = {kMInitLog2, kMInitLog2}, l[2] = {0.f, 0.f}, acc[D / 8][4];
    zero_acc<D>(acc);
    online_tile<D, NT>(acc, m, l, x, Vs, 0, L, lane);
    flash_store<D>(o + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], lse + (long long)bh * L,
                   16 * mt, L, d, acc, m, l, lane, vec);
  }
}

// The bf16 forward at head-dim instantiation D: q, k, v, o (B, H, L, d) with
// the 12 (b, h, l) strides of q, k, v and o; lse (B, H, L) fp32 contiguous.
template <int D>
int launch_flash(const void* q, const void* k, const void* v, const void* mask, void* o,
                 void* lse, int B, int H, int L, int d, float scale, const long long* strides,
                 cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, o};
  const int vec = vec_ok(ptrs, 4, strides, 12);
  const int BH = B * H;
  auto run = [&](auto kernel, dim3 grid, int threads, int smem) {
    return launch_threads(kernel, grid, threads, smem, stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const float*>(mask), static_cast<bf16*>(o),
                  static_cast<float*>(lse), BH, H, L, d, scale, blockwise::unpack(strides, 4), vec);
  };
  const dim3 packed((BH + kThreads / 32 - 1) / (kThreads / 32));
  if constexpr (D <= 128) {
    switch (pack_rows(L)) {
      case 16: return run(flash_packed_kernel<D, 16>, packed, kThreads, packed_smem<D, 16>(3));
      case 32: return run(flash_packed_kernel<D, 32>, packed, kThreads, packed_smem<D, 32>(3));
      default: break;
    }
  }
  return run(flash_tiled_kernel<D>, tiled_grid(BH, L, kFlashRows), kFlashThreads,
             6 * Tile<D>::kRowsBytes);
}

}  // namespace mma_attn
