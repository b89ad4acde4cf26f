// Tensor-core building blocks for the bf16 attention kernels, and the bf16
// backward's dK/dV and dQ kernels built from them, which serve three
// backwards: the whole-sequence one (#2, fused_attn_bwd.cu, from its row
// pre-pass's max and sum), and from the forward's LSE the flash one at
// d = 64 (#7/#8, flash_attn_bwd.cu) and the blockwise one at D = 32, 64,
// 128, 192 and 256 (#4/#5, blockwise_attn_bwd.cu, warp counts per D; at
// D = 64 the same instantiations as #7/#8).  fused_attn_fwd.cu holds the
// whole-sequence forward and the pre-pass; mma_flash_fwd.cuh the flash
// forward behind #3 and #6.  fp32 inputs keep the FMA tiles.
//
// Tiles live in shared memory as bf16 rows of D + 8 elements: the 16-byte
// pad puts the 8 rows that one ldmatrix reads on 8 distinct groups of 4
// banks.  They arrive by 16-byte cp.async copies (zero-filled past L and
// past d) when every base pointer is 16-byte aligned and every (b, h, l)
// stride is a multiple of 8 elements ("vec", checked by the host), else by
// plain element copies.  Products are mma.sync m16n8k16 bf16 -> fp32.  One
// warp owns 16 rows of its tile; the accumulator fragment of a product
// (C: rows g and g + 8, columns 2t and 2t + 1 of each 8-column tile, with
// g = lane / 4, t = lane % 4) is also the A fragment of the next product
// over those columns, so P and dS go from registers to the tensor cores
// without a trip through shared memory.
//
// P and dS are fp32 operands on the TPU (flash_attention.py:130-156).  As
// A operands they are split into hi = bf16(x) and lo = bf16(x - hi), and
// each product is run twice: about 16 bits of each are kept, well under
// the bf16 output's own rounding.  S and dP take bf16 inputs, whose
// products the fp32 accumulator holds exactly, so they are not split.
// Scores are kept in log2 units, (S * scale + mask) * log2 e, so that each
// exponential is one ex2.approx (about 1e-6 relative at these arguments, far
// below a bf16 output's 2^-8); the pre-pass's row max and the forward's
// LSE arrive in natural units.
//
// Past D = 128 a warp's own A fragments (D / 16 x 4 registers) and its fp32
// accumulators (D / 8 x 4) would not fit its 255 registers together: the
// kernels there read A from shared memory 16 columns at a time (mma_abt_s)
// instead of holding it, run every 16-row tile over 64 keys (no packed
// layout: its per-warp tiles would pass the 227 KiB of shared memory), and
// the backward's dK/dV and dQ kernels write their outputs in two column
// passes of D / 2 (kOut<D>), each recomputing S and dP over the whole head
// dim.  Past D = 256 the FMA tiles of blockwise_attn.cuh take bf16 too.
//
// Why mma.sync and not wgmma/TMA: at CLIP's lengths these kernels do about
// L/2 (forward) to 1.6 * 10 L / 8 (backward) operations per byte read,
// below the H100's ridge of about 295 bf16 operations per byte, so they
// are bound by the bytes, and mma.sync fed by async copies can reach it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blockwise_attn.cuh"

namespace mma_attn {

using bf16 = __nv_bfloat16;
using blockwise::kMInit;
using blockwise::Strides;

constexpr int kThreads = 128;  // 4 warps per CTA
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;      // rows of a CTA's own tile and of a streamed tile (L > 32)

template <int D>
struct Tile {
  static constexpr int kS = D + 8;  // row stride in elements
  static constexpr int kRowsBytes = kTile * kS * (int)sizeof(bf16);
};

// ---------------------------------------------------------------- copies
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0+R-1 of one (b, h) slice into dst[r * kS + c]; rows at or
// past L and dims at or past d are 0.  Threads t, t + nt, ... of the caller
// share the work; with vec the copies are asynchronous (commit and wait).
template <int R, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, long long sl,
                                          int row0, int L, int d, int t, int nt, bool vec) {
  constexpr int kS = Tile<D>::kS, kCh = D / 8;
  for (int i = t; i < R * kCh; i += nt) {
    const int r = i / kCh, c = (i % kCh) * 8;
    const int row = row0 + r;
    const bool ok = row < L && c < d;
    bf16* dp = dst + r * kS + c;
    if (vec) {
      cp_async16(dp, ok ? src + row * sl + c : src, ok ? min(8, d - c) * 2 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dp[e] = (ok && c + e < d) ? src[row * sl + c + e] : __float2bfloat16_rn(0.f);
    }
  }
}

// ------------------------------------------------------------- fragments
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) rounded to bf16, x in the low half: the element of the lower column
__device__ __forceinline__ uint32_t pack(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}

// hi = bf16(x, y), lo = bf16((x, y) - hi)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x - hf.x, y - hf.y);
}

// A fragments of rows r0 .. r0+15 of a [row][d] tile, one per 16 dims
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4], const bf16* tile, int r0, int lane) {
  const bf16* p = tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tile<D>::kS + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) ldsm_x4(a[kc], p + kc * 16);
}

// c[j] = A . B[r0 + 8j .. r0 + 8j + 7]^T for j < NT (NT even): the scores of
// 16 rows against NT * 8 rows of a [row][d] tile
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float c[NT][4], const uint32_t a[D / 16][4],
                                        const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const int i = lane >> 3;
  const bf16* p = tile + (r0 + (lane & 7) + (i >> 1) * 8) * Tile<D>::kS + (i & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, p + jp * 16 * Tile<D>::kS + kc * 16);
      mma(c[2 * jp], a[kc], b[0], b[1]);
      mma(c[2 * jp + 1], a[kc], b[2], b[3]);
    }
  }
}

// as mma_abt, with A read 16 columns at a time from rows a_r0 .. a_r0+15 of
// a [row][d] tile instead of held in registers (the D > 128 kernels)
template <int D, int NT>
__device__ __forceinline__ void mma_abt_s(float c[NT][4], const bf16* a_tile, int a_r0,
                                          const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const int i = lane >> 3;
  const bf16* pa = a_tile + (a_r0 + (lane & 7) + (i & 1) * 8) * Tile<D>::kS + (lane >> 4) * 8;
  const bf16* p = tile + (r0 + (lane & 7) + (i >> 1) * 8) * Tile<D>::kS + (i & 1) * 8;
#pragma unroll 2
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, pa + kc * 16);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, p + jp * 16 * Tile<D>::kS + kc * 16);
      mma(c[2 * jp], a, b[0], b[1]);
      mma(c[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// The scores of a warp's 16 rows (own_r in the own tile) against NT * 8 rows
// of a streamed tile: from the held A fragments a at D <= 128 (loaded from the
// own tile when `load`), else from the own tile itself.
template <int D, int NT>
__device__ __forceinline__ void scores_from(float c[NT][4], uint32_t (&a)[D <= 128 ? D / 16 : 1][4],
                                            bool load, const bf16* own, int own_r,
                                            const bf16* tile, int r0, int lane) {
  if constexpr (D <= 128) {
    if (load) load_a<D>(a, own, own_r, lane);
    mma_abt<D, NT>(c, a, tile, r0, lane);
  } else {
    mma_abt_s<D, NT>(c, own, own_r, tile, r0, lane);
  }
}

// acc += A . B[r0 .. r0+15][:] over the first D columns of a [row][d] tile of
// row stride kS, for one A (kSplit: A = a + a_lo, two products per B fragment)
template <int D, bool kSplit, int kS = Tile<D>::kS>
__device__ __forceinline__ void mma_ab(float acc[D / 8][4], const uint32_t a[4],
                                       const uint32_t a_lo[4], const bf16* tile, int r0, int lane) {
  const int i = lane >> 3;
  const bf16* p = tile + (r0 + (lane & 7) + (i & 1) * 8) * kS + (i >> 1) * 8;
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, p + np * 16);
    mma(acc[2 * np], a, b[0], b[1]);
    mma(acc[2 * np + 1], a, b[2], b[3]);
    if (kSplit) {
      mma(acc[2 * np], a_lo, b[0], b[1]);
      mma(acc[2 * np + 1], a_lo, b[2], b[3]);
    }
  }
}

// the A fragment (16 rows x 16 columns) of accumulator tiles c[j0], c[j0 + 1]
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}
__device__ __forceinline__ void c_to_a_split(uint32_t hi[4], uint32_t lo[4], const float c0[4],
                                             const float c1[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// ------------------------------------------------------ row statistics
// x = (S * scale + mask) * log2(e) in place for an m-tile at global row row0
// against keys key0 + 8j + ...: the scores in log2 units, so that one ex2
// gives each exponential (c = scale * log2(e)); -inf at keys past L; rows
// past L take no mask (computed, never stored).  A whole tile without a
// mask takes one multiply per score.
template <int NT>
__device__ __forceinline__ void scores_log2(float s[NT][4], int row0, int key0, int L, float c,
                                            const float* __restrict__ mask, int lane) {
  if (mask == nullptr && key0 + 8 * NT <= L) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= c;
    return;
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + (e >> 1) * 8, key = key0 + 8 * j + 2 * t + (e & 1);
      float x = s[j][e] * c;
      if (key >= L)
        x = -INFINITY;
      else if (mask != nullptr && row < L)
        x = fmaf(mask[(long long)row * L + key], kLog2e, x);
      s[j][e] = x;
    }
}

// Fold x (log2 units) into this thread's running max m (from -1e30), sum
// l = sum 2^(x - m) and, with kU, u = sum 2^(x - m) * w, for its rows g
// (index 0) and g + 8 (index 1), rescaling by 2^(m_old - m_new).  In
// natural units m * ln 2 is the row max, and l and u are unchanged.
template <int NT, bool kU>
__device__ __forceinline__ void fold(const float x[NT][4], const float w[NT][4], float m[2],
                                     float l[2], float u[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) mt = fmaxf(mt, fmaxf(x[j][2 * r], x[j][2 * r + 1]));
    const float m_new = fmaxf(m[r], mt);
    const float alpha = ex2(m[r] - m_new);
    float se = 0.f, su = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float ex = ex2(x[j][e] - m_new);
        se += ex;
        if (kU) su = fmaf(ex, w[j][e], su);
      }
    l[r] = fmaf(l[r], alpha, se);
    if (kU) u[r] = fmaf(u[r], alpha, su);
    m[r] = m_new;
  }
}

// combine the 4 lanes of a quad (each saw its own columns)
template <bool kU>
__device__ __forceinline__ void merge_quad(float m[2], float l[2], float u[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float m_new = fmaxf(m[r], mo);
      const float a = ex2(m[r] - m_new), c = ex2(mo - m_new);
      l[r] = l[r] * a + lo * c;
      if (kU) {
        const float uo = __shfl_xor_sync(0xffffffffu, u[r], off);
        u[r] = u[r] * a + uo * c;
      }
      m[r] = m_new;
    }
}

// O += round(P) V for one tile of scores x (log2 units; keys key0 ..):
// P = 2^(x - m) / l, rounded to bf16 (flash_attention.py:45-47), 16 keys at
// a time; chunks wholly past L are skipped (their P is 0)
template <int D, int NT>
__device__ __forceinline__ void pv(float acc[D / 8][4], const float x[NT][4], const float m[2],
                                   const float l[2], const bf16* v_tile, int key0, int L,
                                   int lane) {
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (key0 + 16 * kk >= L) break;
    float p[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[jj][e] = ex2(x[2 * kk + jj][e] - m[e >> 1]) * inv[e >> 1];
    uint32_t a[4];
    c_to_a(a, p[0], p[1]);
    mma_ab<D, false>(acc, a, a, v_tile, 16 * kk, lane);
  }
}

// rows row0 + g, row0 + g + 8 of an accumulator, times mult, into one (b, h)
// slice of out (q's dtype), dims below d only
template <int D>
__device__ __forceinline__ void store_acc(bf16* out, long long sl, int row0, int L, int d,
                                          const float acc[D / 8][4], float mult, int lane,
                                          bool vec) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    bf16* dst = out + row * sl;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float x = acc[j][2 * r] * mult, y = acc[j][2 * r + 1] * mult;
      if (vec && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < d) dst[col] = __float2bfloat16_rn(x);
        if (col + 1 < d) dst[col + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// Whether every tensor's base is 16-byte aligned and every (b, h, l) stride a
// multiple of 8 elements, so that 16-byte copies and paired stores line up.
inline bool vec_ok(const void* const* ptrs, int n_ptrs, const long long* strides, int n_strides) {
  for (int i = 0; i < n_ptrs; ++i)
    if (ptrs[i] != nullptr && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

// The work layout of a launch from L: 16 or 32 (every warp one whole (b*h),
// one or two 16-row tiles, CTAs of 4 heads), else 0 (CTAs of 64 rows of one
// (b*h), 64-row streamed tiles double-buffered).
inline int pack_rows(int L) { return L <= 16 ? 16 : L <= 32 ? 32 : 0; }

// The (b*h, tile of `rows` rows) of a tiled CTA: blockIdx.x = bh * tiles +
// tile, so that the tiles of one head run side by side (their K and V stay
// in L2) and a head's short last tile shares each wave with full ones.
__device__ __forceinline__ int tiled_head(int L, int& row0, int rows = kTile) {
  const int tiles = (L + rows - 1) / rows;
  const int bh = blockIdx.x / tiles;
  row0 = (blockIdx.x - bh * tiles) * rows;
  return bh;
}

inline dim3 tiled_grid(int BH, int L, int rows = kTile) {
  return dim3(BH * ((L + rows - 1) / rows));
}

// Launch kernel on checked arguments, `threads` threads per CTA, with its
// dynamic shared memory.
template <typename... KArgs, typename... Args>
int launch_threads(void (*kernel)(KArgs...), dim3 grid, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ... with kThreads threads per CTA.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), dim3 grid, int smem, cudaStream_t stream, Args... args) {
  return launch_threads(kernel, grid, kThreads, smem, stream, args...);
}

// ------------------------------------------------------- backward, bf16
// Two functions, one set of kernels, told apart by kLse:
//   false, the whole-sequence backward (#2, _attn_bwd_kernel,
//     flash_attention.py:128-156): P = exp(S * scale + mask - m) / l from the
//     pre-pass's row max m and row sum l (fused_attn_bwd.cu);
//   true, the flash backwards (#7/#8, _hp_bwd_dkv_kernel / _hp_bwd_dq_kernel,
//     :609-685, flash_attn_bwd.cu; #4/#5, _blockwise_dkv_kernel /
//     _blockwise_dq_kernel, :324-406, blockwise_attn_bwd.cu):
//     P = exp(S * scale + mask - LSE) from the
//     forward's logsumexp, whose row sum is 1: no row sum is read, and the
//     multiply by 1 / l is by the constant 1, which the compiler drops.
// Then dS = P (dP - delta), the exponential as 2^((S * scale + mask) * log2 e
// - m * log2 e): a row that the flash forward saw with no finite score has
// LSE = -1e30 + log(1e-30), which rounds to -1e30, and with a -inf mask
// P = 2^-inf = 0; with a finite -1e30 mask the score (fmaf(mask, log2 e,
// S * scale * log2 e)) and LSE * log2 e round alike, so P = 1 as in the plain
// version's exp(-1e30 - (-1e30)).  Every kernel below takes
//   (q, k, v, dO, m, l, delta, mask, out0, out1, B*H, H, L, d, scale,
//    strides, vec)
// with m = row max or LSE, l = row sum (not read under kLse), out0/out1 =
// dK/dV or dQ/unused, and strides the (b, h, l) strides of q, k, v, dO, out0
// (and out1).

// The output columns of one backward pass at head-dim instantiation D: all
// D up to 128, else D / 2 (two passes, each recomputing S and dP), which
// keeps dK's and dV's fp32 accumulators at 2 x 64 registers a thread.
template <int D> constexpr int kOut = D <= 128 ? D : D / 2;

// dK, dV of 16 own keys (own_r: their first row in the own K/V tiles, key0:
// its global index), output columns c0 .. c0 + DO - 1, += one 16-query chunk
// (qr: its first row in the Q/dO tiles, qry0: its global index).  Works on
// S^T = K Q^T and dP^T = V dO^T over all D columns, so that P^T and dS^T are
// the A fragments of dV += P^T dO and dK += dS^T Q.  rm, rs, dl: this
// (b*h)'s row max (or LSE), row sum (not read under kLse) and delta.
template <int D, bool kLse, int DO = D>
__device__ __forceinline__ void dkv_chunk(float dk[DO / 8][4], float dv[DO / 8][4], int c0,
                                          const bf16* Ks, const bf16* Vs, int own_r, int key0,
                                          const bf16* Qs,
                                          const bf16* Gs, int qr, int qry0,
                                          const float* __restrict__ rm,
                                          const float* __restrict__ rs,
                                          const float* __restrict__ dl,
                                          const float* __restrict__ mask, int L, float scale,
                                          int lane) {
  float s[2][4], dp[2][4];
  {
    uint32_t a[D <= 128 ? D / 16 : 1][4];
    scores_from<D, 2>(s, a, true, Ks, own_r, Qs, qr, lane);
    scores_from<D, 2>(dp, a, true, Vs, own_r, Gs, qr, lane);
  }
  const int g = lane >> 2, t = lane & 3;
  const float sc = scale * kLog2e;
  const bool full = mask == nullptr && qry0 + 16 <= L && key0 + 16 <= L;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int qry = qry0 + 8 * j + 2 * t + c;
      const bool ok_q = qry < L;
      const float mq = ok_q ? rm[qry] * kLog2e : 0.f;
      const float iq = kLse ? 1.f : ok_q ? 1.f / rs[qry] : 0.f;
      const float dq = ok_q ? dl[qry] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 2 * r + c, key = key0 + g + 8 * r;
        float p = 0.f;
        if (full) {
          p = ex2(fmaf(s[j][e], sc, -mq)) * iq;
        } else if (ok_q && key < L) {
          float x = s[j][e] * sc;
          if (mask != nullptr) x = fmaf(mask[(long long)qry * L + key], kLog2e, x);
          p = ex2(x - mq) * iq;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dq);
      }
    }
  uint32_t hi[4], lo[4];
  c_to_a_split(hi, lo, s[0], s[1]);
  mma_ab<DO, true, Tile<D>::kS>(dv, hi, lo, Gs + c0, qr, lane);
  c_to_a_split(hi, lo, dp[0], dp[1]);
  mma_ab<DO, true, Tile<D>::kS>(dk, hi, lo, Qs + c0, qr, lane);
}

// dQ of 16 own queries (own_r in the own Q/dO tiles, row0 global), output
// columns c0 .. c0 + DO - 1, += one 16-key chunk (kr in the K/V tiles, key0
// global); m, il, dl: the own rows' max or LSE (log2 units), 1 / sum (not
// read under kLse) and delta (rows g and g + 8)
template <int D, bool kLse, int DO = D>
__device__ __forceinline__ void dq_chunk(float dq[DO / 8][4], int c0, const bf16* Qs, const bf16* Gs,
                                         int own_r, int row0, const bf16* Ks, const bf16* Vs,
                                         int kr, int key0, const float m[2], const float il[2],
                                         const float dl[2], const float* __restrict__ mask,
                                         int L, float scale, int lane) {
  float s[2][4], dp[2][4];
  {
    uint32_t a[D <= 128 ? D / 16 : 1][4];
    scores_from<D, 2>(s, a, true, Qs, own_r, Ks, kr, lane);
    scores_from<D, 2>(dp, a, true, Gs, own_r, Vs, kr, lane);
  }
  const int g = lane >> 2, t = lane & 3;
  const float sc = scale * kLog2e;
  const bool full = mask == nullptr && row0 + 16 <= L && key0 + 16 <= L;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, row = row0 + g + 8 * r, key = key0 + 8 * j + 2 * t + (e & 1);
      float p = 0.f;
      if (full) {
        p = ex2(fmaf(s[j][e], sc, -m[r])) * il[r];
      } else if (row < L && key < L) {
        float x = s[j][e] * sc;
        if (mask != nullptr) x = fmaf(mask[(long long)row * L + key], kLog2e, x);
        p = ex2(x - m[r]) * il[r];
      }
      dp[j][e] = p * (dp[j][e] - dl[r]);
    }
  uint32_t hi[4], lo[4];
  c_to_a_split(hi, lo, dp[0], dp[1]);
  mma_ab<DO, true, Tile<D>::kS>(dq, hi, lo, Ks + c0, kr, lane);
}

template <int D>
__device__ __forceinline__ void zero_acc(float acc[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

#define FSVLM_BWD_PARAMS                                                                         \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,             \
      const bf16 *__restrict__ g, const float *__restrict__ rm, const float *__restrict__ rs,     \
      const float *__restrict__ dl, const float *__restrict__ mask, bf16 *__restrict__ out0,     \
      bf16 *__restrict__ out1, int BH, int H, int L, int d, float scale, Strides st, int vec

// shared memory of a tiled CTA of W warps: its two own tiles of 16 W rows and
// two double-buffered streamed tiles of kTile rows
template <int D, int W>
constexpr int tiled_smem() {
  return (2 * 16 * W + 4 * kTile) * Tile<D>::kS * (int)sizeof(bf16);
}

// dK/dV, L > 32 (any L past D = 128): one CTA of W warps per (b*h, 16 W-key
// tile, column pass), warp w owning keys 16w .. 16w + 15 of it, walks
// 64-query tiles of Q and dO, double-buffered.
template <int D, bool kLse, int W>
__global__ void __launch_bounds__(32 * W) dkv_tiled_kernel(FSVLM_BWD_PARAMS) {
  constexpr int kT = kTile * Tile<D>::kS, kOwn = 16 * W, kN = 32 * W, DO = kOut<D>;
  const int c0 = blockIdx.y * DO;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // own K   [key][d]
  bf16* Vs = Ks + kOwn * Tile<D>::kS;         // own V   [key][d]
  bf16* Qs = Vs + kOwn * Tile<D>::kS;         // 2 x streamed Q   [query][d]
  bf16* Gs = Qs + 2 * kT;                     // 2 x streamed dO  [query][d]
  int k0;
  const int bh = tiled_head(L, k0, kOwn), b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qp = q + b * st.s[0][0] + h * st.s[0][1];
  const bf16* gp = g + b * st.s[3][0] + h * st.s[3][1];
  load_tile<kOwn, D>(Ks, k + b * st.s[1][0] + h * st.s[1][1], st.s[1][2], k0, L, d, tid, kN, vec);
  load_tile<kOwn, D>(Vs, v + b * st.s[2][0] + h * st.s[2][1], st.s[2][2], k0, L, d, tid, kN, vec);
  auto prefetch = [&](int s) {
    load_tile<kTile, D>(Qs + (s & 1) * kT, qp, st.s[0][2], s * kTile, L, d, tid, kN, vec);
    load_tile<kTile, D>(Gs + (s & 1) * kT, gp, st.s[3][2], s * kTile, L, d, tid, kN, vec);
    cp_async_commit();
  };
  prefetch(0);
  const long long at = (long long)bh * L;
  const int own = 16 * warp;
  const bool active = k0 + own < L;
  float dk_acc[DO / 8][4], dv_acc[DO / 8][4];
  zero_acc<DO>(dk_acc);
  zero_acc<DO>(dv_acc);
  const int n = (L + kTile - 1) / kTile;
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) prefetch(s + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* Qb = Qs + (s & 1) * kT;
      const bf16* Gb = Gs + (s & 1) * kT;
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (s * kTile + 16 * kk >= L) break;
        dkv_chunk<D, kLse, DO>(dk_acc, dv_acc, c0, Ks, Vs, own, k0 + own, Qb, Gb, 16 * kk,
                               s * kTile + 16 * kk, rm + at, rs + at, dl + at, mask, L, scale,
                               lane);
      }
    }
    __syncthreads();
  }
  if (active) {
    store_acc<DO>(out0 + b * st.s[4][0] + h * st.s[4][1] + c0, st.s[4][2], k0 + own, L, d - c0,
                  dk_acc, scale, lane, vec);
    store_acc<DO>(out1 + b * st.s[5][0] + h * st.s[5][1] + c0, st.s[5][2], k0 + own, L, d - c0,
                  dv_acc, 1.f, lane, vec);
  }
}

// The per-warp slices of a packed CTA (L <= R): warp w takes (b*h)
// 4 * blockIdx.x + w whole, its Q, K, V and dO in [row][d] tiles of R rows.
template <int D, int R>
__device__ __forceinline__ bool load_head(bf16*& Qs, bf16*& Ks, bf16*& Vs, bf16*& Gs, int& b,
                                          int& h, int& bh, FSVLM_BWD_PARAMS) {
  constexpr int kT = R * Tile<D>::kS;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bh = blockIdx.x * (kThreads / 32) + warp;
  if (bh >= BH) return false;
  b = bh / H;
  h = bh - b * H;
  Qs = reinterpret_cast<bf16*>(smem4) + warp * 4 * kT;
  Ks = Qs + kT;
  Vs = Ks + kT;
  Gs = Vs + kT;
  load_tile<R, D>(Qs, q + b * st.s[0][0] + h * st.s[0][1], st.s[0][2], 0, L, d, lane, 32, vec);
  load_tile<R, D>(Ks, k + b * st.s[1][0] + h * st.s[1][1], st.s[1][2], 0, L, d, lane, 32, vec);
  load_tile<R, D>(Vs, v + b * st.s[2][0] + h * st.s[2][1], st.s[2][2], 0, L, d, lane, 32, vec);
  load_tile<R, D>(Gs, g + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], 0, L, d, lane, 32, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  return true;
}

#define FSVLM_BWD_ARGS q, k, v, g, rm, rs, dl, mask, out0, out1, BH, H, L, d, scale, st, vec

// dK/dV, L <= R (16 or 32): every warp one whole (b*h)
template <int D, int R, bool kLse>
__global__ void __launch_bounds__(kThreads) dkv_packed_kernel(FSVLM_BWD_PARAMS) {
  bf16 *Qs, *Ks, *Vs, *Gs;
  int b, h, bh;
  if (!load_head<D, R>(Qs, Ks, Vs, Gs, b, h, bh, FSVLM_BWD_ARGS)) return;
  const int lane = threadIdx.x & 31;
  const long long at = (long long)bh * L;
#pragma unroll 1
  for (int mt = 0; mt < R / 16; ++mt) {
    if (16 * mt >= L) break;
    float dk_acc[D / 8][4], dv_acc[D / 8][4];
    zero_acc<D>(dk_acc);
    zero_acc<D>(dv_acc);
    for (int kc = 0; kc < R / 16; ++kc) {
      if (16 * kc >= L) break;
      dkv_chunk<D, kLse>(dk_acc, dv_acc, 0, Ks, Vs, 16 * mt, 16 * mt, Qs, Gs, 16 * kc, 16 * kc,
                         rm + at, rs + at, dl + at, mask, L, scale, lane);
    }
    store_acc<D>(out0 + b * st.s[4][0] + h * st.s[4][1], st.s[4][2], 16 * mt, L, d, dk_acc, scale,
                 lane, vec);
    store_acc<D>(out1 + b * st.s[5][0] + h * st.s[5][1], st.s[5][2], 16 * mt, L, d, dv_acc, 1.f,
                 lane, vec);
  }
}

// the own rows' statistics: max or LSE (log2 units), 1 / sum (not under
// kLse) and delta of rows row0 + g, + 8
template <bool kLse>
__device__ __forceinline__ void row_stats(float m[2], float il[2], float dd[2],
                                          const float* __restrict__ rm,
                                          const float* __restrict__ rs,
                                          const float* __restrict__ dl, int row0, int L, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    const bool ok = row < L;
    m[r] = ok ? rm[row] * kLog2e : 0.f;
    il[r] = kLse ? 1.f : ok ? 1.f / rs[row] : 0.f;
    dd[r] = ok ? dl[row] : 0.f;
  }
}

// dQ, L > 32 (any L past D = 128): one CTA of W warps per (b*h, 16 W-query
// tile, column pass), warp w owning queries 16w .. 16w + 15 of it, walks
// 64-key tiles of K and V, double-buffered.
template <int D, bool kLse, int W>
__global__ void __launch_bounds__(32 * W) dq_tiled_kernel(FSVLM_BWD_PARAMS) {
  constexpr int kT = kTile * Tile<D>::kS, kOwn = 16 * W, kN = 32 * W, DO = kOut<D>;
  const int c0 = blockIdx.y * DO;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // own Q   [query][d]
  bf16* Gs = Qs + kOwn * Tile<D>::kS;         // own dO  [query][d]
  bf16* Ks = Gs + kOwn * Tile<D>::kS;         // 2 x streamed K  [key][d]
  bf16* Vs = Ks + 2 * kT;                     // 2 x streamed V  [key][d]
  int q0;
  const int bh = tiled_head(L, q0, kOwn), b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kp = k + b * st.s[1][0] + h * st.s[1][1];
  const bf16* vp = v + b * st.s[2][0] + h * st.s[2][1];
  load_tile<kOwn, D>(Qs, q + b * st.s[0][0] + h * st.s[0][1], st.s[0][2], q0, L, d, tid, kN, vec);
  load_tile<kOwn, D>(Gs, g + b * st.s[3][0] + h * st.s[3][1], st.s[3][2], q0, L, d, tid, kN, vec);
  auto prefetch = [&](int s) {
    load_tile<kTile, D>(Ks + (s & 1) * kT, kp, st.s[1][2], s * kTile, L, d, tid, kN, vec);
    load_tile<kTile, D>(Vs + (s & 1) * kT, vp, st.s[2][2], s * kTile, L, d, tid, kN, vec);
    cp_async_commit();
  };
  prefetch(0);
  const long long at = (long long)bh * L;
  const int own = 16 * warp;
  const bool active = q0 + own < L;
  float m[2], il[2], dd[2];
  row_stats<kLse>(m, il, dd, rm + at, rs + at, dl + at, q0 + own, L, lane);
  float dq_acc[DO / 8][4];
  zero_acc<DO>(dq_acc);
  const int n = (L + kTile - 1) / kTile;
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) prefetch(s + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* Kb = Ks + (s & 1) * kT;
      const bf16* Vb = Vs + (s & 1) * kT;
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (s * kTile + 16 * kk >= L) break;
        dq_chunk<D, kLse, DO>(dq_acc, c0, Qs, Gs, own, q0 + own, Kb, Vb, 16 * kk,
                              s * kTile + 16 * kk, m, il, dd, mask, L, scale, lane);
      }
    }
    __syncthreads();
  }
  if (active)
    store_acc<DO>(out0 + b * st.s[4][0] + h * st.s[4][1] + c0, st.s[4][2], q0 + own, L, d - c0,
                  dq_acc, scale, lane, vec);
}

// dQ, L <= R (16 or 32): every warp one whole (b*h)
// (one CTA per SM at the least: at D = 128, R = 32 the default register
// budget spilled)
template <int D, int R, bool kLse>
__global__ void __launch_bounds__(kThreads, 1) dq_packed_kernel(FSVLM_BWD_PARAMS) {
  bf16 *Qs, *Ks, *Vs, *Gs;
  int b, h, bh;
  if (!load_head<D, R>(Qs, Ks, Vs, Gs, b, h, bh, FSVLM_BWD_ARGS)) return;
  const int lane = threadIdx.x & 31;
  const long long at = (long long)bh * L;
#pragma unroll 1
  for (int mt = 0; mt < R / 16; ++mt) {
    if (16 * mt >= L) break;
    float m[2], il[2], dd[2];
    row_stats<kLse>(m, il, dd, rm + at, rs + at, dl + at, 16 * mt, L, lane);
    float dq_acc[D / 8][4];
    zero_acc<D>(dq_acc);
    for (int kc = 0; kc < R / 16; ++kc) {
      if (16 * kc >= L) break;
      dq_chunk<D, kLse>(dq_acc, 0, Qs, Gs, 16 * mt, 16 * mt, Ks, Vs, 16 * kc, 16 * kc, m, il, dd,
                        mask, L, scale, lane);
    }
    store_acc<D>(out0 + b * st.s[4][0] + h * st.s[4][1], st.s[4][2], 16 * mt, L, d, dq_acc, scale,
                 lane, vec);
  }
}

// shared memory of a packed CTA: kTiles [row][d] tiles of R rows per warp
template <int D, int R>
constexpr int packed_smem(int kTiles) {
  return (kThreads / 32) * kTiles * R * Tile<D>::kS * (int)sizeof(bf16);
}

// The dK/dV (kDkv) or dQ kernel for bf16 at head-dim instantiation D, from
// the row max and sum or (kLse) the LSE; W warps per tiled CTA (L > 32, and
// every L past D = 128), D / kOut<D> column passes.
template <int D, bool kDkv, bool kLse = false, int W = 4>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const void* rm,
               const void* rs, const void* dl, const void* mask, void* out0, void* out1, int B,
               int H, int L, int d, float scale, const long long* strides, cudaStream_t stream) {
  const int n_t = kDkv ? 6 : 5;
  const void* ptrs[6] = {q, k, v, g, out0, out1};
  const int vec = vec_ok(ptrs, n_t, strides, 3 * n_t);
  const int BH = B * H;
  const dim3 packed((BH + kThreads / 32 - 1) / (kThreads / 32));
  dim3 tiled = tiled_grid(BH, L, 16 * W);
  tiled.y = D / kOut<D>;
  const int R = D <= 128 ? pack_rows(L) : 0;
  auto run = [&](auto kernel, dim3 grid, int threads, int smem) {
    return launch_threads(kernel, grid, threads, smem, stream, static_cast<const bf16*>(q),
                          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<const bf16*>(g), static_cast<const float*>(rm),
                          static_cast<const float*>(rs), static_cast<const float*>(dl),
                          static_cast<const float*>(mask), static_cast<bf16*>(out0),
                          static_cast<bf16*>(out1), BH, H, L, d, scale,
                          blockwise::unpack(strides, n_t), vec);
  };
  if constexpr (kDkv) {
    if constexpr (D <= 128) {
      if (R == 16) return run(dkv_packed_kernel<D, 16, kLse>, packed, kThreads, packed_smem<D, 16>(4));
      if (R == 32) return run(dkv_packed_kernel<D, 32, kLse>, packed, kThreads, packed_smem<D, 32>(4));
    }
    return run(dkv_tiled_kernel<D, kLse, W>, tiled, 32 * W, tiled_smem<D, W>());
  } else {
    if constexpr (D <= 128) {
      if (R == 16) return run(dq_packed_kernel<D, 16, kLse>, packed, kThreads, packed_smem<D, 16>(4));
      if (R == 32) return run(dq_packed_kernel<D, 32, kLse>, packed, kThreads, packed_smem<D, 32>(4));
    }
    return run(dq_tiled_kernel<D, kLse, W>, tiled, 32 * W, tiled_smem<D, W>());
  }
}

template <bool kDkv>
int bwd_entry(int d, const void* q, const void* k, const void* v, const void* g, const void* rm,
              const void* rs, const void* dl, const void* mask, void* out0, void* out1, int B,
              int H, int L, float scale, const long long* strides, cudaStream_t s) {
  switch (blockwise::padded_dim(d)) {
    case 32: return launch_bwd<32, kDkv>(q, k, v, g, rm, rs, dl, mask, out0, out1, B, H, L, d, scale, strides, s);
    case 64: return launch_bwd<64, kDkv>(q, k, v, g, rm, rs, dl, mask, out0, out1, B, H, L, d, scale, strides, s);
    case 128: return launch_bwd<128, kDkv>(q, k, v, g, rm, rs, dl, mask, out0, out1, B, H, L, d, scale, strides, s);
    case 192: return launch_bwd<192, kDkv>(q, k, v, g, rm, rs, dl, mask, out0, out1, B, H, L, d, scale, strides, s);
    case 256: return launch_bwd<256, kDkv>(q, k, v, g, rm, rs, dl, mask, out0, out1, B, H, L, d, scale, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mma_attn
