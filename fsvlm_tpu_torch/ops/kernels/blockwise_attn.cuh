// Device helpers shared by the blockwise flash-attention kernels
// (blockwise_attn_fwd.cu, blockwise_attn_bwd.cu).  build.py hashes every
// header in this directory into each library's name, so an edited header
// rebuilds both.
//
// Every kernel runs 128 threads per CTA.  Thread tid is (row group rg,
// column group cg) = (tid / kCG, tid % kCG): it owns kRows = 4 rows of the
// CTA's own tile and, against a streamed tile, its columns in chunks of
// four, chunk t at t * 4 * kCG + cg * 4, so that the kCG threads of a row
// group (neighbouring lanes of one warp) read consecutive 16-byte vectors.
// A head dim d below the kernel's instantiation D is zero-padded in shared
// memory (the TPU pads to 128 lanes the same way); only dims below d are
// stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace blockwise {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // rows of the CTA's own tile per thread
constexpr float kMInit = -1e30f;
constexpr float kLMin = 1e-30f;

// strides (in elements) of the (b, h, l) axes of up to six tensors
struct Strides {
  long long s[6][3];
};

inline Strides unpack(const long long* flat, int n) {
  Strides st{};
  for (int t = 0; t < n; ++t)
    for (int i = 0; i < 3; ++i) st.s[t][i] = flat[3 * t + i];
  return st;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the c-th column of column group cg (chunks of four, kCG groups)
template <int kCG>
__device__ __forceinline__ int chunk_col(int cg, int c) {
  return (c >> 2) * (4 * kCG) + cg * 4 + (c & 3);
}

// rows row0 .. row0+R-1 of one (b, h) slice of src, head dims 0 .. D-1, into
// dst[r * stride + c] (fp32); rows at or past L and dims at or past d are 0
template <int R, int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* __restrict__ src,
                                          long long stride_l, int row0, int L, int d) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * stride + c] = (row < L && c < d) ? to_f(src[(long long)row * stride_l + c]) : 0.f;
  }
}

// as load_rows, transposed: dst[c * stride + r]
template <int R, int D, typename T>
__device__ __forceinline__ void load_rows_t(float* dst, int stride, const T* __restrict__ src,
                                            long long stride_l, int row0, int L, int d) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[c * stride + r] = (row < L && c < d) ? to_f(src[(long long)row * stride_l + c]) : 0.f;
  }
}

// the head-dim instantiation that holds d (0: none)
inline int padded_dim(int d) { return d < 1 ? 0 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0; }

}  // namespace blockwise
