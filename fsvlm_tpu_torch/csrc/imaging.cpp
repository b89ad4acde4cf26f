// Pillow's 8-bit RGB image passes, for fsvlm_tpu_torch/data/imageops.py,
// which calls each through ctypes with the GIL released.  Every pass
// reproduces the arithmetic of Pillow's C code (libImaging) byte for byte:
// the same types (float where Pillow computes in float, double where it
// computes in double), the same order of operations, and no contraction
// into fused multiply-adds (the library is built with -ffp-contract=off).
//
// Images are contiguous uint8 (H, W, C) arrays; Pillow keeps RGB in 4
// bytes a pixel, which changes nothing here since every pass treats the
// bands alike.
//
// - fsvlm_resample: Image.resize(size, BILINEAR or BICUBIC, box)
//   (Resample.c ImagingResampleInner, precompute_coeffs,
//   normalize_coeffs_8bpc, ImagingResample{Horizontal,Vertical}_8bpc): taps
//   centred at box0 + (x + 0.5) * scale, scale = box width / out width, in
//   fixed point with 22 fractional bits; the horizontal pass over the rows
//   the vertical pass reads, then the vertical pass.
// - fsvlm_affine_nearest: Image.transform(size, AFFINE, data, NEAREST)
//   (Geometry.c affine_transform: ImagingScaleAffine when the matrix has no
//   shear, affine_fixed in 16.16 fixed point when the corners fit, else
//   floating point); pixels whose source lies outside keep dst's contents
//   (the caller fills dst with the fill colour).
// - fsvlm_gaussian_blur: ImageFilter.GaussianBlur(radius) (BoxBlur.c:
//   _gaussian_blur_radius, three passes of the extended box blur along the
//   rows, then three along the columns).
// - fsvlm_rgb_to_hsv / fsvlm_hsv_to_rgb: convert("HSV") and back
//   (Convert.c rgb2hsv_row, hsv2rgb).
// - fsvlm_filter3x3: Image.filter of a 3x3 kernel (Filter.c ImagingFilter,
//   the float path; border pixels copied).
// - fsvlm_blend: Image.blend (Blend.c ImagingBlend).
// - fsvlm_grayscale: convert("L") (Convert.c rgb2l, L24), optionally
//   replicated to 3 bands as convert("L").convert("RGB").
// - fsvlm_lut: Image.point of an integer table per band.
//
// Each returns 0, or nonzero for arguments it refuses.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

inline uint8_t clip8_fixed(int64_t acc) {
  acc >>= kPrecisionBits;
  return static_cast<uint8_t>(acc < 0 ? 0 : acc > 255 ? 255 : acc);
}

// precompute_coeffs + normalize_coeffs_8bpc: per output index its first
// source index and tap count (bounds) and ksize fixed-point taps.
int precompute_coeffs(int in_size, float in0, float in1, int out_size, int filter,
                      std::vector<int>* bounds, std::vector<int32_t>* kk) {
  double (*fn)(double) = filter == 2 ? bilinear_filter : bicubic_filter;
  const double fsupport = filter == 2 ? 1.0 : 2.0;
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = fsupport * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> pre(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds->assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    (*bounds)[xx * 2] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk->resize(pre.size());
  for (size_t i = 0; i < pre.size(); ++i) {
    (*kk)[i] = pre[i] < 0 ? static_cast<int32_t>(-0.5 + pre[i] * (1 << kPrecisionBits))
                          : static_cast<int32_t>(0.5 + pre[i] * (1 << kPrecisionBits));
  }
  return ksize;
}

// rows [row0, row0 + rows) of src (width in_w) -> dst (rows, out_w)
void resample_horizontal(const uint8_t* src, int64_t in_w, int64_t c, int64_t row0, int64_t rows,
                         int out_w, int ksize, const std::vector<int>& bounds,
                         const std::vector<int32_t>& kk, uint8_t* dst) {
  const int64_t half = int64_t(1) << (kPrecisionBits - 1);
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* row = src + (row0 + y) * in_w * c;
    uint8_t* drow = dst + y * out_w * c;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
      const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
      const uint8_t* s = row + static_cast<int64_t>(xmin) * c;
      for (int64_t ch = 0; ch < c; ++ch) {
        int64_t acc = half;
        for (int x = 0; x < xmax; ++x) acc += static_cast<int64_t>(s[x * c + ch]) * k[x];
        drow[xx * c + ch] = clip8_fixed(acc);
      }
    }
  }
}

// src (any rows, width w) -> dst (out_h, w); bounds index src's rows from
// ``shift`` on
void resample_vertical(const uint8_t* src, int64_t w, int64_t c, int out_h, int ksize,
                       const std::vector<int>& bounds, int shift, const std::vector<int32_t>& kk,
                       uint8_t* dst) {
  const int64_t half = int64_t(1) << (kPrecisionBits - 1);
  const int64_t width = w * c;
  std::vector<int64_t> acc(static_cast<size_t>(width));
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = bounds[yy * 2] - shift, ymax = bounds[yy * 2 + 1];
    const int32_t* k = &kk[static_cast<size_t>(yy) * ksize];
    std::fill(acc.begin(), acc.end(), half);
    for (int y = 0; y < ymax; ++y) {
      const uint8_t* s = src + static_cast<int64_t>(ymin + y) * width;
      const int64_t wt = k[y];
      for (int64_t i = 0; i < width; ++i) acc[i] += static_cast<int64_t>(s[i]) * wt;
    }
    uint8_t* d = dst + static_cast<int64_t>(yy) * width;
    for (int64_t i = 0; i < width; ++i) d[i] = clip8_fixed(acc[i]);
  }
}

// ImagingLineBoxBlur32 over one line of n pixels (``stride`` bytes apart,
// c bands) into ``out`` (n * c bytes, packed).
void line_box_blur(const uint8_t* in, int64_t stride, int64_t c, int lastx, int radius,
                   int edge_a, int edge_b, uint32_t ww, uint32_t fw, uint8_t* out) {
  uint32_t acc[4], bulk[4];
  auto px = [&](int x, int64_t ch) -> uint32_t { return in[x * stride + ch]; };
  for (int64_t ch = 0; ch < c; ++ch) acc[ch] = px(0, ch) * (radius + 1);
  for (int x = 0; x < edge_a - 1; ++x)
    for (int64_t ch = 0; ch < c; ++ch) acc[ch] += px(x, ch);
  for (int64_t ch = 0; ch < c; ++ch) acc[ch] += px(lastx, ch) * (radius - edge_a + 1);

  auto step = [&](int x, int subtract, int add, int left, int right) {
    for (int64_t ch = 0; ch < c; ++ch) {
      acc[ch] += px(add, ch) - px(subtract, ch);
      bulk[ch] = (acc[ch] * ww) + (px(left, ch) + px(right, ch)) * fw;
      out[x * c + ch] = static_cast<uint8_t>((bulk[ch] + (1 << 23)) >> 24);
    }
  };
  if (edge_a <= edge_b) {
    for (int x = 0; x < edge_a; ++x) step(x, 0, x + radius, 0, x + radius + 1);
    for (int x = edge_a; x < edge_b; ++x)
      step(x, x - radius - 1, x + radius, x - radius - 1, x + radius + 1);
    for (int x = edge_b; x <= lastx; ++x) step(x, x - radius - 1, lastx, x - radius - 1, lastx);
  } else {
    for (int x = 0; x < edge_b; ++x) step(x, 0, x + radius, 0, x + radius + 1);
    for (int x = edge_b; x < edge_a; ++x) step(x, 0, lastx, 0, lastx);
    for (int x = edge_a; x <= lastx; ++x) step(x, x - radius - 1, lastx, x - radius - 1, lastx);
  }
}

// ImagingHorizontalBoxBlur along ``lines`` lines of ``n`` pixels each, in
// place: pixel x of line l at img[l * line_stride + x * px_stride].
void box_blur_lines(uint8_t* img, int64_t lines, int64_t n, int64_t line_stride,
                    int64_t px_stride, int64_t c, float float_radius) {
  const int radius = static_cast<int>(float_radius);
  const uint32_t ww = static_cast<uint32_t>(static_cast<uint32_t>(1 << 24) /
                                            (float_radius * 2 + 1));
  const uint32_t fw = ((1 << 24) - (radius * 2 + 1) * ww) / 2;
  const int lastx = static_cast<int>(n) - 1;
  const int edge_a = std::min(radius + 1, static_cast<int>(n));
  const int edge_b = std::max(static_cast<int>(n) - radius - 1, 0);
  std::vector<uint8_t> line(static_cast<size_t>(n * c));
  for (int64_t l = 0; l < lines; ++l) {
    uint8_t* base = img + l * line_stride;
    line_box_blur(base, px_stride, c, lastx, radius, edge_a, edge_b, ww, fw, line.data());
    for (int64_t x = 0; x < n; ++x)
      std::memcpy(base + x * px_stride, &line[x * c], static_cast<size_t>(c));
  }
}

float gaussian_blur_radius(float radius, int passes) {
  float sigma2, L, l, a;
  sigma2 = radius * radius / passes;
  L = std::sqrt(12.0 * sigma2 + 1.0);
  l = std::floor((L - 1.0) / 2.0);
  a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2);
  a /= 6 * (sigma2 - (l + 1) * (l + 1));
  return l + a;
}

inline int coord(double v) { return v < 0.0 ? -1 : static_cast<int>(v); }
inline int floor_int(double v) {
  return v < 0.0 ? static_cast<int>(std::floor(v)) : static_cast<int>(v);
}

bool check_fixed(const double* a, int x, int y) {
  return std::fabs(x * a[0] + y * a[1] + a[2]) < 32768.0 &&
         std::fabs(x * a[3] + y * a[4] + a[5]) < 32768.0;
}

inline uint8_t clip8_float(float v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return static_cast<uint8_t>(v);
}

inline int clip8_int(int v) { return v <= 0 ? 0 : v >= 255 ? 255 : v; }

}  // namespace

extern "C" {

// filter: 2 bilinear, 3 bicubic (Pillow's numbers).  box: (x0, y0, x1, y1)
// in source pixels.  need_h/need_v as Pillow decides them; with neither,
// a copy.
int fsvlm_resample(const uint8_t* src, int64_t h, int64_t w, int64_t c, int filter, float box0,
                   float box1, float box2, float box3, int64_t out_w, int64_t out_h,
                   uint8_t* dst) {
  if ((filter != 2 && filter != 3) || out_w < 1 || out_h < 1 || c < 1) return 1;
  const bool need_h = out_w != w || box0 != 0 || box2 != out_w;
  const bool need_v = out_h != h || box1 != 0 || box3 != out_h;
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  const int ksize_h = precompute_coeffs(static_cast<int>(w), box0, box2, static_cast<int>(out_w),
                                        filter, &bh, &kh);
  const int ksize_v = precompute_coeffs(static_cast<int>(h), box1, box3, static_cast<int>(out_h),
                                        filter, &bv, &kv);
  const int ybox_first = bv[0];
  const int ybox_last = bv[out_h * 2 - 2] + bv[out_h * 2 - 1];
  if (need_h && need_v) {
    std::vector<uint8_t> tmp(static_cast<size_t>((ybox_last - ybox_first) * out_w * c));
    resample_horizontal(src, w, c, ybox_first, ybox_last - ybox_first, static_cast<int>(out_w),
                        ksize_h, bh, kh, tmp.data());
    resample_vertical(tmp.data(), out_w, c, static_cast<int>(out_h), ksize_v, bv, ybox_first, kv,
                      dst);
  } else if (need_h) {
    // the temporary holds rows ybox_first..ybox_last of the output height
    // (all of them: no vertical pass means out_h == h and box1 == 0)
    resample_horizontal(src, w, c, ybox_first, ybox_last - ybox_first, static_cast<int>(out_w),
                        ksize_h, bh, kh, dst);
  } else if (need_v) {
    resample_vertical(src, w, c, static_cast<int>(out_h), ksize_v, bv, 0, kv, dst);
  } else {
    std::memcpy(dst, src, static_cast<size_t>(h * w * c));
  }
  return 0;
}

// a: the six coefficients of Image.transform's AFFINE data (output pixel
// (x, y) samples the source at (a0 x + a1 y + a2, a3 x + a4 y + a5)).
int fsvlm_affine_nearest(const uint8_t* src, int64_t h, int64_t w, int64_t c, const double* a,
                         int64_t out_h, int64_t out_w, uint8_t* dst) {
  if (c < 1) return 1;
  const int xsize = static_cast<int>(w), ysize = static_cast<int>(h);
  const int x1 = static_cast<int>(out_w), y1 = static_cast<int>(out_h);
  auto put = [&](int y, int x, int yin, int xin) {
    std::memcpy(dst + (static_cast<int64_t>(y) * out_w + x) * c,
                src + (static_cast<int64_t>(yin) * w + xin) * c, static_cast<size_t>(c));
  };
  if (a[1] == 0 && a[3] == 0) {  // ImagingScaleAffine
    std::vector<int> xintab(static_cast<size_t>(x1 > 0 ? x1 : 1), 0);
    double xo = a[2] + a[0] * 0.5;
    double yo = a[5] + a[4] * 0.5;
    int xmin = x1, xmax = 0;
    for (int x = 0; x < x1; ++x) {
      const int xin = coord(xo);
      if (xin >= 0 && xin < xsize) {
        xmax = x + 1;
        if (x < xmin) xmin = x;
        xintab[x] = xin;
      }
      xo += a[0];
    }
    for (int y = 0; y < y1; ++y) {
      const int yi = coord(yo);
      if (yi >= 0 && yi < ysize) {
        for (int x = xmin; x < xmax; ++x) put(y, x, yi, xintab[x]);
      }
      yo += a[4];
    }
    return 0;
  }
  if (check_fixed(a, 0, 0) && check_fixed(a, x1, y1) && check_fixed(a, 0, y1) &&
      check_fixed(a, x1, 0)) {  // affine_fixed, 16.16
    auto fix = [](double v) { return floor_int(v * 65536.0 + 0.5); };
    const int a0 = fix(a[0]), a1 = fix(a[1]), a3 = fix(a[3]), a4 = fix(a[4]);
    int a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5);
    int a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5);
    for (int y = 0; y < y1; ++y) {
      int xx = a2, yy = a5;
      for (int x = 0; x < x1; ++x) {
        const int xin = xx >> 16;
        if (xin >= 0 && xin < xsize) {
          const int yin = yy >> 16;
          if (yin >= 0 && yin < ysize) put(y, x, yin, xin);
        }
        xx += a0;
        yy += a3;
      }
      a2 += a1;
      a5 += a4;
    }
    return 0;
  }
  const double a0 = a[0], a1 = a[1], a3 = a[3], a4 = a[4];
  double a2 = a[2] + a[0] * 0.5 + a[1] * 0.5;
  double a5 = a[5] + a[3] * 0.5 + a[4] * 0.5;
  for (int y = 0; y < y1; ++y) {
    double xx = a2, yy = a5;
    for (int x = 0; x < x1; ++x) {
      const int xin = coord(xx);
      if (xin >= 0 && xin < xsize) {
        const int yin = coord(yy);
        if (yin >= 0 && yin < ysize) put(y, x, yin, xin);
      }
      xx += a0;
      yy += a3;
    }
    a2 += a1;
    a5 += a4;
  }
  return 0;
}

int fsvlm_gaussian_blur(const uint8_t* src, int64_t h, int64_t w, int64_t c, float radius,
                        uint8_t* dst) {
  const int passes = 3;
  if (c < 1 || c > 4 || radius < 0) return 1;
  std::memcpy(dst, src, static_cast<size_t>(h * w * c));
  if (radius == 0) return 0;  // GaussianBlur(0) is a copy
  const float r = gaussian_blur_radius(radius, passes);
  if (r == 0) return 0;
  for (int i = 0; i < passes; ++i) box_blur_lines(dst, h, w, w * c, c, c, r);  // rows
  for (int i = 0; i < passes; ++i) box_blur_lines(dst, w, h, c, w * c, c, r);  // columns
  return 0;
}

int fsvlm_rgb_to_hsv(const uint8_t* src, int64_t n, uint8_t* dst) {
  for (int64_t p = 0; p < n; ++p) {
    const uint8_t r = src[p * 3], g = src[p * 3 + 1], b = src[p * 3 + 2];
    const uint8_t maxc = std::max(r, std::max(g, b));
    const uint8_t minc = std::min(r, std::min(g, b));
    uint8_t uh, us;
    if (minc == maxc) {
      uh = 0;
      us = 0;
    } else {
      float h, s, rc, gc, bc, cr;
      cr = static_cast<float>(maxc - minc);
      s = cr / static_cast<float>(maxc);
      rc = static_cast<float>(maxc - r) / cr;
      gc = static_cast<float>(maxc - g) / cr;
      bc = static_cast<float>(maxc - b) / cr;
      if (r == maxc) {
        h = bc - gc;
      } else if (g == maxc) {
        h = 2.0 + rc - bc;
      } else {
        h = 4.0 + gc - rc;
      }
      // Pillow's fmod(h / 6.0 + 1.0, 1.0): the argument lies in [5/6, 11/6),
      // where subtracting 1 is exact and equal to fmod
      const double wrapped = h / 6.0 + 1.0;
      h = wrapped >= 1.0 ? wrapped - 1.0 : wrapped;
      uh = static_cast<uint8_t>(clip8_int(static_cast<int>(h * 255.0)));
      us = static_cast<uint8_t>(clip8_int(static_cast<int>(s * 255.0)));
    }
    dst[p * 3] = uh;
    dst[p * 3 + 1] = us;
    dst[p * 3 + 2] = maxc;
  }
  return 0;
}

int fsvlm_hsv_to_rgb(const uint8_t* src, int64_t n, uint8_t* dst) {
  for (int64_t px = 0; px < n; ++px) {
    const uint8_t h = src[px * 3], s = src[px * 3 + 1], v = src[px * 3 + 2];
    uint8_t* out = dst + px * 3;
    if (s == 0) {
      out[0] = out[1] = out[2] = v;
      continue;
    }
    int p, q, t, i;
    float f, fs;
    i = static_cast<int>(std::floor(static_cast<float>(h) * 6.0 / 255.0));
    f = static_cast<float>(h) * 6.0 / 255.0 - static_cast<float>(i);
    fs = static_cast<float>(s) / 255.0;
    p = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs)));
    q = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs * f)));
    t = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs * (1.0 - f))));
    const uint8_t up = static_cast<uint8_t>(clip8_int(p));
    const uint8_t uq = static_cast<uint8_t>(clip8_int(q));
    const uint8_t ut = static_cast<uint8_t>(clip8_int(t));
    switch (i % 6) {
      case 0: out[0] = v; out[1] = ut; out[2] = up; break;
      case 1: out[0] = uq; out[1] = v; out[2] = up; break;
      case 2: out[0] = up; out[1] = v; out[2] = ut; break;
      case 3: out[0] = up; out[1] = uq; out[2] = v; break;
      case 4: out[0] = ut; out[1] = up; out[2] = v; break;
      case 5: out[0] = v; out[1] = up; out[2] = uq; break;
    }
  }
  return 0;
}

// kernel: 9 floats already divided by the divisor, row-major as Pillow
// takes them; offset: Pillow's offset (0 for the builtin filters).
int fsvlm_filter3x3(const uint8_t* src, int64_t h, int64_t w, int64_t c, const float* kernel,
                    float offset, uint8_t* dst) {
  std::memcpy(dst, src, static_cast<size_t>(h * w * c));
  if (w < 3 || h < 3) return 0;  // smaller than the kernel: a copy
  offset += 0.5;
  for (int64_t y = 1; y < h - 1; ++y) {
    const uint8_t* in_1 = src + (y - 1) * w * c;
    const uint8_t* in0 = src + y * w * c;
    const uint8_t* in1 = src + (y + 1) * w * c;
    uint8_t* out = dst + y * w * c;
    auto k1x3 = [&](const uint8_t* row, int64_t i, const float* k) {
      return static_cast<float>(row[i - c]) * k[0] + static_cast<float>(row[i]) * k[1] +
             static_cast<float>(row[i + c]) * k[2];
    };
    for (int64_t x = 1; x < w - 1; ++x) {
      for (int64_t ch = 0; ch < c; ++ch) {
        const int64_t i = x * c + ch;
        float ss = offset;
        ss += k1x3(in1, i, kernel);
        ss += k1x3(in0, i, kernel + 3);
        ss += k1x3(in_1, i, kernel + 6);
        out[i] = clip8_float(ss);
      }
    }
  }
  return 0;
}

int fsvlm_blend(const uint8_t* in1, const uint8_t* in2, int64_t n, float alpha, uint8_t* dst) {
  if (alpha == 0.0) {
    std::memcpy(dst, in1, static_cast<size_t>(n));
  } else if (alpha == 1.0) {
    std::memcpy(dst, in2, static_cast<size_t>(n));
  } else if (alpha >= 0 && alpha <= 1.0) {
    for (int64_t x = 0; x < n; ++x)
      dst[x] = static_cast<uint8_t>(static_cast<int>(in1[x]) +
                                    alpha * (static_cast<int>(in2[x]) - static_cast<int>(in1[x])));
  } else {
    for (int64_t x = 0; x < n; ++x) {
      const float temp = static_cast<float>(
          static_cast<int>(in1[x]) + alpha * (static_cast<int>(in2[x]) - static_cast<int>(in1[x])));
      dst[x] = temp <= 0.0 ? 0 : temp >= 255.0 ? 255 : static_cast<uint8_t>(temp);
    }
  }
  return 0;
}

// RGB -> L (bands_out 1) or L replicated to RGB (bands_out 3)
int fsvlm_grayscale(const uint8_t* src, int64_t n, int bands_out, uint8_t* dst) {
  if (bands_out != 1 && bands_out != 3) return 1;
  for (int64_t p = 0; p < n; ++p) {
    const uint8_t* s = src + p * 3;
    const uint8_t l = static_cast<uint8_t>(
        (static_cast<uint32_t>(s[0]) * 19595 + s[1] * 38470u + s[2] * 7471u + 0x8000u) >> 16);
    for (int b = 0; b < bands_out; ++b) dst[p * bands_out + b] = l;
  }
  return 0;
}

// table: c * 256 entries, band-major (Pillow's flat lut)
int fsvlm_lut(const uint8_t* src, int64_t n, int64_t c, const uint8_t* table, uint8_t* dst) {
  for (int64_t p = 0; p < n; ++p)
    for (int64_t ch = 0; ch < c; ++ch) dst[p * c + ch] = table[ch * 256 + src[p * c + ch]];
  return 0;
}

}  // extern "C"
