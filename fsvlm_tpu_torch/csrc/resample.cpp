// One separable pass of Pillow's 8-bit resampling (Resample.c
// ImagingResample{Horizontal,Vertical}_8bpc), for fsvlm_tpu_torch/data/imageops.py,
// which computes the taps (each output index's first source index and its
// fixed-point weights, 22 fractional bits) and calls this through ctypes
// with the GIL released.
//
// src: contiguous uint8 (in, other, channels) for axis 0 (vertical) or
// (other, in, channels) for axis 1 (horizontal); dst likewise with `out` in
// place of `in`.  Each output sample is clip8((2^21 + sum_t src[xmin + t] *
// taps[t]) >> 22), the sum in 64 bits (Pillow sums in 32 and never reaches
// 2^31 on these weights).  A tap past the source's end weighs 0 (imageops
// zeroes those) and is skipped.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int fsvlm_resample_pass(const uint8_t* src, int64_t in_size, int64_t other, int64_t channels,
                        int axis, const int64_t* xmin, const int64_t* taps, int64_t ksize,
                        int64_t out_size, uint8_t* dst) {
  const int64_t half = int64_t(1) << 21;
  auto clip8 = [](int64_t acc) {
    acc >>= 22;
    return static_cast<uint8_t>(acc < 0 ? 0 : acc > 255 ? 255 : acc);
  };
  if (axis == 1) {  // along each row: (other, in, channels) -> (other, out, channels)
    for (int64_t j = 0; j < other; ++j) {
      const uint8_t* row = src + j * in_size * channels;
      uint8_t* drow = dst + j * out_size * channels;
      for (int64_t o = 0; o < out_size; ++o) {
        const int64_t* k = taps + o * ksize;
        const int64_t n = std::min(ksize, in_size - xmin[o]);
        const uint8_t* s = row + xmin[o] * channels;
        for (int64_t c = 0; c < channels; ++c) {
          int64_t acc = half;
          for (int64_t t = 0; t < n; ++t) acc += static_cast<int64_t>(s[t * channels + c]) * k[t];
          drow[o * channels + c] = clip8(acc);
        }
      }
    }
    return 0;
  }
  if (axis != 0) return 1;
  // down the columns: (in, other, channels) -> (out, other, channels), a row at a time
  const int64_t width = other * channels;
  std::vector<int64_t> acc(static_cast<size_t>(width));
  for (int64_t o = 0; o < out_size; ++o) {
    const int64_t* k = taps + o * ksize;
    const int64_t n = std::min(ksize, in_size - xmin[o]);
    std::fill(acc.begin(), acc.end(), half);
    for (int64_t t = 0; t < n; ++t) {
      const uint8_t* s = src + (xmin[o] + t) * width;
      const int64_t w = k[t];
      for (int64_t i = 0; i < width; ++i) acc[i] += static_cast<int64_t>(s[i]) * w;
    }
    uint8_t* d = dst + o * width;
    for (int64_t i = 0; i < width; ++i) d[i] = clip8(acc[i]);
  }
  return 0;
}

}  // extern "C"
