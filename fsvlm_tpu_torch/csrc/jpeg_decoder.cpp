// The port's JPEG decoder: baseline, extended, progressive and lossless
// JPEG, Huffman and arithmetic coded, with no library, its output
// byte-equal to libjpeg-turbo's (8-bit samples) for the two views the data
// layer reads.
//
//  - fsvlm_jpeg_decode_full: the full-resolution RGB image that Pillow's
//    Image.open(path).convert("RGB") gives (its libjpeg-turbo 3.1):
//    libjpeg's integer IDCT (JDCT_ISLOW, jidctint.c), its "fancy" triangle
//    upsampling (jdsample.c: h2v1, h1v2, h2v2, with their alternating
//    rounding biases; box replication for other integral factors), its
//    fixed-point YCbCr->RGB (jdcolor.c); grayscale replicated to three
//    channels; CMYK and YCCK (Adobe) through Pillow's inverted CMYK and its
//    CMYK->RGB.
//  - fsvlm_jpeg_decode_resize_crop: the device-aug cache view that
//    native/decoder.cpp computes through libjpeg (the system's 2.1): decode
//    at the largest DCT scale 1/2^k (k <= 3) whose shorter edge stays >=
//    pre_size (jidctred.c's 4x4, 2x2 and 1x1 IDCTs; a subsampled component
//    takes a larger IDCT instead of upsampling where libjpeg does,
//    jdmaster.c), a separable float bilinear resize of the shorter edge to
//    pre_size, the centre crop.  libjpeg has no CMYK->RGB conversion, so a
//    CMYK or YCCK file returns kNoRgb here, as the libjpeg build returns its
//    error code; so does a lossless file, which that build does not read.
//  - Arithmetic coding (SOF9, SOF10; jdarith.c): the QM coder with libjpeg's
//    statistics bins and DAC conditioning (defaults L 0, U 1, K 5), its
//    restart intervals, and after a decoding error the rest of the interval
//    left as it is, as libjpeg leaves it.
//  - Block smoothing (jdcoefct.c decompress_smooth_data): a progressive
//    file whose scans leave any of the first 9 AC coefficients unrefined is
//    smoothed from each block's 5x5 DC neighbourhood, with the edge rules of
//    libjpeg-turbo 3 for the full decode and of 2.1 for the cache view.
//  - Lossless (SOF3; jdlossls.c, jdlhuff.c, jdpred.c): Huffman-coded
//    differences, predictors 1-7, the point transform, restarts at row
//    boundaries; components of 1x1 sampling.  A three-component frame read
//    as YCbCr is refused, as libjpeg-turbo 3 converts no colour of a
//    lossless frame.
//
// Every call is reentrant and allocates its own buffers, so a Python thread
// pool decodes in parallel (ctypes releases the GIL around the call).
// Corrupt or truncated data returns kCorrupt; the variants this decoder
// does not read return kUnsupported: hierarchical frames, arithmetic
// lossless and 12-bit samples (which Pillow 12.1 refuses too) and lossless
// frames with subsampled components.  Nothing is guessed.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off (the port's
// fsvlm_tpu_torch/native.py does this at first use).  The float resize
// writes its fused multiply-adds out with std::fma, the contraction the
// libjpeg build's compiler makes, so that the result does not depend on the
// compiler's flags.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "host_common.h"

namespace {

enum Status {
  kOk = 0,
  kNoRgb = 1,        // CMYK / YCCK: libjpeg gives no RGB output
  kCorrupt = 2,      // malformed or truncated data
  kUnsupported = 3,  // a JPEG variant this decoder does not read
  kNotJpeg = 4,      // no SOI marker
  kNoMemory = 5,     // an allocation failed
  kTooLarge = 6,     // more than kMaxPixels pixels
  kRefused = 7,      // a file libjpeg-turbo 3 (Pillow's) refuses too
  kOpen = 10,
  kRead = 11,
};

// Pillow refuses an image of more than twice Image.MAX_IMAGE_PIXELS as a
// decompression bomb, so the JAX package reads none: neither does this
// decoder, which keeps a corrupt header from sizing its buffers.
constexpr int64_t kMaxPixels = 2 * int64_t(89478485);

// zigzag position -> natural (row-major) position; 16 spare entries catch a
// run past 63 in corrupt data, as libjpeg's jpeg_natural_order does
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jaricom.c jpeg_aritab: the QM coder's Qe values and its probability
// estimation state machine (ITU-T T.81 table D.2), packed as libjpeg packs
// them: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS.
// Entry 113 is the fixed 0.5 estimate of sign and refinement bits.
#define V(i, qe, lps, mps, sw) ((int64_t(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),     V(1, 0x2586, 14, 2, 0),    V(2, 0x1114, 16, 3, 0),
    V(3, 0x080b, 18, 4, 0),    V(4, 0x03d8, 20, 5, 0),    V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),    V(7, 0x006f, 28, 8, 0),    V(8, 0x0036, 30, 9, 0),
    V(9, 0x001a, 33, 10, 0),   V(10, 0x000d, 35, 11, 0),  V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),  V(13, 0x0001, 12, 13, 0),  V(14, 0x5a7f, 15, 15, 1),
    V(15, 0x3f25, 36, 16, 0),  V(16, 0x2cf2, 38, 17, 0),  V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),  V(19, 0x1182, 42, 20, 0),  V(20, 0x0cef, 43, 21, 0),
    V(21, 0x09a1, 45, 22, 0),  V(22, 0x072f, 46, 23, 0),  V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),  V(25, 0x0303, 51, 26, 0),  V(26, 0x0240, 52, 27, 0),
    V(27, 0x01b1, 54, 28, 0),  V(28, 0x0144, 56, 29, 0),  V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),  V(31, 0x008a, 60, 32, 0),  V(32, 0x0068, 62, 33, 0),
    V(33, 0x004e, 63, 34, 0),  V(34, 0x003b, 32, 35, 0),  V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),  V(37, 0x484c, 64, 38, 0),  V(38, 0x3a0d, 65, 39, 0),
    V(39, 0x2ef1, 67, 40, 0),  V(40, 0x261f, 68, 41, 0),  V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),  V(43, 0x1518, 72, 44, 0),  V(44, 0x1177, 73, 45, 0),
    V(45, 0x0e74, 74, 46, 0),  V(46, 0x0bfb, 75, 47, 0),  V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),  V(49, 0x0706, 79, 50, 0),  V(50, 0x05cd, 48, 51, 0),
    V(51, 0x04de, 50, 52, 0),  V(52, 0x040f, 50, 53, 0),  V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),  V(55, 0x025c, 53, 56, 0),  V(56, 0x01f8, 54, 57, 0),
    V(57, 0x01a4, 55, 58, 0),  V(58, 0x0160, 56, 59, 0),  V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),  V(61, 0x00cb, 59, 62, 0),  V(62, 0x00ab, 61, 63, 0),
    V(63, 0x008f, 61, 32, 0),  V(64, 0x5b12, 65, 65, 1),  V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),  V(67, 0x37d8, 82, 68, 0),  V(68, 0x2fe8, 83, 69, 0),
    V(69, 0x293c, 84, 70, 0),  V(70, 0x2379, 86, 71, 0),  V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),  V(73, 0x174e, 72, 74, 0),  V(74, 0x1424, 72, 75, 0),
    V(75, 0x119c, 74, 76, 0),  V(76, 0x0f6b, 74, 77, 0),  V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),  V(79, 0x0a40, 77, 48, 0),  V(80, 0x5832, 80, 81, 1),
    V(81, 0x4d1c, 88, 82, 0),  V(82, 0x438e, 89, 83, 0),  V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),  V(85, 0x2eae, 92, 86, 0),  V(86, 0x299a, 93, 87, 0),
    V(87, 0x2516, 86, 71, 0),  V(88, 0x5570, 88, 89, 1),  V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),  V(91, 0x3e22, 97, 92, 0),  V(92, 0x3824, 99, 93, 0),
    V(93, 0x32b4, 99, 94, 0),  V(94, 0x2e17, 93, 86, 0),  V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0), V(97, 0x47e5, 102, 98, 0), V(98, 0x41cf, 103, 99, 0),
    V(99, 0x3c3d, 104, 100, 0), V(100, 0x375e, 99, 93, 0), V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0),
    V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1),
    V(111, 0x5522, 112, 109, 0), V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// ------------------------------------------------------------ range limits
// libjpeg's sample_range_limit (jdmaster.c prepare_range_limit_table): the
// "simple" table clamps [-256, 511] to [0, 255]; the post-IDCT table is
// indexed by (value & 1023) with the value centred on 0.
struct RangeTables {
  uint8_t simple[256 * 3];  // index x + 256
  uint8_t post_idct[1024];
  RangeTables() {
    for (int i = 0; i < 768; ++i)
      simple[i] = static_cast<uint8_t>(std::min(255, std::max(0, i - 256)));
    for (int i = 0; i < 1024; ++i) {
      const int s = i >= 512 ? i - 1024 : i;  // the 10-bit value, signed
      post_idct[i] = static_cast<uint8_t>(std::min(255, std::max(0, s + 128)));
    }
  }
};
const RangeTables kRange;

inline uint8_t clamp_simple(int x) { return kRange.simple[x + 256]; }
inline uint8_t clamp_idct(int64_t x) { return kRange.post_idct[static_cast<int>(x) & 1023]; }

// ----------------------------------------------------------- colour tables
// jdcolor.c build_ycc_rgb_table: SCALEBITS 16, FIX(x) = x * 2^16 + 0.5.
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + one_half);
    }
  }
};
const YccTables kYcc;

// ------------------------------------------------------------------ IDCTs
// jidctint.c jpeg_idct_islow and jidctred.c jpeg_idct_4x4 / 2x2 / 1x1, in
// integer arithmetic as libjpeg computes them (CONST_BITS 13, PASS1_BITS 2).
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

constexpr int64_t F_0_211164243 = 1730, F_0_298631336 = 2446, F_0_390180644 = 3196,
                  F_0_509795579 = 4176, F_0_541196100 = 4433, F_0_601344887 = 4926,
                  F_0_720959822 = 5906, F_0_765366865 = 6270, F_0_850430095 = 6967,
                  F_0_899976223 = 7373, F_1_061594337 = 8697, F_1_175875602 = 9633,
                  F_1_272758580 = 10426, F_1_451774981 = 11893, F_1_501321110 = 12299,
                  F_1_847759065 = 15137, F_1_961570560 = 16069, F_2_053119869 = 16819,
                  F_2_172734803 = 17799, F_2_562915447 = 20995, F_3_072711026 = 25172,
                  F_3_624509785 = 29692;

void idct_8x8(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp_idct(descale(tmp10 + tmp3, sh));
    op[7] = clamp_idct(descale(tmp10 - tmp3, sh));
    op[1] = clamp_idct(descale(tmp11 + tmp2, sh));
    op[6] = clamp_idct(descale(tmp11 - tmp2, sh));
    op[2] = clamp_idct(descale(tmp12 + tmp1, sh));
    op[5] = clamp_idct(descale(tmp12 - tmp1, sh));
    op[3] = clamp_idct(descale(tmp13 + tmp0, sh));
    op[4] = clamp_idct(descale(tmp13 - tmp0, sh));
  }
}

void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // the second pass does not read column 4
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 4; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t tmp0 = int64_t(ip[0] * qp[0]) * (int64_t(1) << (kConstBits + 1));
    const int64_t z2e = ip[16] * qp[16], z3e = ip[48] * qp[48];
    const int64_t tmp2e = z2e * F_1_847759065 + z3e * -F_0_765366865;
    const int64_t tmp10 = tmp0 + tmp2e, tmp12 = tmp0 - tmp2e;
    const int64_t z1 = ip[56] * qp[56], z2 = ip[40] * qp[40], z3 = ip[24] * qp[24],
                  z4 = ip[8] * qp[8];
    tmp0 = z1 * -F_0_211164243 + z2 * F_1_451774981 + z3 * -F_2_172734803 + z4 * F_1_061594337;
    const int64_t tmp2 =
        z1 * -F_0_509795579 + z2 * -F_0_601344887 + z3 * F_0_899976223 + z4 * F_2_562915447;
    const int sh = kConstBits - kPass1Bits + 1;
    wp[0] = static_cast<int>(descale(tmp10 + tmp2, sh));
    wp[24] = static_cast<int>(descale(tmp10 - tmp2, sh));
    wp[8] = static_cast<int>(descale(tmp12 + tmp0, sh));
    wp[16] = static_cast<int>(descale(tmp12 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3 + 1;
  for (int r = 0; r < 4; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    int64_t tmp0 = int64_t(wp[0]) * (int64_t(1) << (kConstBits + 1));
    const int64_t tmp2e = int64_t(wp[2]) * F_1_847759065 + int64_t(wp[6]) * -F_0_765366865;
    const int64_t tmp10 = tmp0 + tmp2e, tmp12 = tmp0 - tmp2e;
    const int64_t z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * -F_0_211164243 + z2 * F_1_451774981 + z3 * -F_2_172734803 + z4 * F_1_061594337;
    const int64_t tmp2 =
        z1 * -F_0_509795579 + z2 * -F_0_601344887 + z3 * F_0_899976223 + z4 * F_2_562915447;
    op[0] = clamp_idct(descale(tmp10 + tmp2, sh));
    op[3] = clamp_idct(descale(tmp10 - tmp2, sh));
    op[1] = clamp_idct(descale(tmp12 + tmp0, sh));
    op[2] = clamp_idct(descale(tmp12 - tmp0, sh));
  }
}

void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;  // columns the second pass does not read
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[24] && !ip[40] && !ip[56]) {
      const int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      wp[0] = wp[8] = dc;
      continue;
    }
    const int64_t tmp10 = int64_t(ip[0] * qp[0]) * (int64_t(1) << (kConstBits + 2));
    const int64_t tmp0 = int64_t(ip[56] * qp[56]) * -F_0_720959822 +
                         int64_t(ip[40] * qp[40]) * F_0_850430095 +
                         int64_t(ip[24] * qp[24]) * -F_1_272758580 +
                         int64_t(ip[8] * qp[8]) * F_3_624509785;
    const int sh = kConstBits - kPass1Bits + 2;
    wp[0] = static_cast<int>(descale(tmp10 + tmp0, sh));
    wp[8] = static_cast<int>(descale(tmp10 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3 + 2;
  for (int r = 0; r < 2; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    const int64_t tmp10 = int64_t(wp[0]) * (int64_t(1) << (kConstBits + 2));
    const int64_t tmp0 = int64_t(wp[7]) * -F_0_720959822 + int64_t(wp[5]) * F_0_850430095 +
                         int64_t(wp[3]) * -F_1_272758580 + int64_t(wp[1]) * F_3_624509785;
    op[0] = clamp_idct(descale(tmp10 + tmp0, sh));
    op[1] = clamp_idct(descale(tmp10 - tmp0, sh));
  }
}

void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
  out[0] = clamp_idct(descale(in[0] * q[0], 3));
}

// ------------------------------------------------------------ the decoder
constexpr int kLookahead = 8;  // libjpeg's HUFF_LOOKAHEAD

struct Huffman {
  bool defined = false;
  int max_symbol = 0;  // a DC table's largest size category (15, or 16 lossless)
  uint8_t counts[17] = {0};  // codes of each length 1-16
  uint8_t values[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  // the next kLookahead bits -> (code length << 8) | symbol, 0 for a longer code
  uint16_t look[1 << kLookahead];
};

// jdhuff.c jpeg_make_d_derived_tbl; false for an invalid table
bool derive(Huffman& t, bool is_dc) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = t.counts[l];
    if (p + i > 256) return false;
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (code >= (1 << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.counts[l]) {
      t.valoffset[l] = p - huffcode[p];
      p += t.counts[l];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look, 0, sizeof t.look);
  p = 0;
  for (int l = 1; l <= kLookahead; ++l) {
    for (int i = 1; i <= t.counts[l]; ++i, ++p) {
      int lookbits = huffcode[p] << (kLookahead - l);
      for (int ctr = 1 << (kLookahead - l); ctr > 0; --ctr)
        t.look[lookbits++] = static_cast<uint16_t>((l << 8) | t.values[p]);
    }
  }
  t.max_symbol = 0;
  if (is_dc)
    for (int i = 0; i < numsymbols; ++i) t.max_symbol = std::max<int>(t.max_symbol, t.values[i]);
  return true;
}

// Zero-filled coefficient storage from calloc: its pages are committed as
// scans write them, not when a (possibly corrupt) frame header sizes them.
struct Coefs {
  int16_t* p = nullptr;
  Coefs() = default;
  Coefs(const Coefs&) = delete;
  Coefs& operator=(const Coefs&) = delete;
  ~Coefs() { std::free(p); }
  void allocate(size_t n) {
    p = static_cast<int16_t*>(std::calloc(n, sizeof(int16_t)));
    if (!p) throw std::bad_alloc();
  }
  void release() {
    std::free(p);
    p = nullptr;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int width_in_blocks = 0, height_in_blocks = 0;
  int bw = 0, bh = 0;  // blocks in the coefficient buffer (MCU-padded)
  Coefs coef;
  uint16_t qt[64];
  bool latched = false;
  int dc_pred = 0;
  int coef_bits[64];
  // output geometry at the chosen scale
  int ss = 8;  // this component's IDCT size
  int dw = 0, dh = 0;  // downsampled width / height after IDCT scaling
  std::vector<uint8_t> plane;
  int pstride = 0;
  std::vector<uint16_t> samples;  // a lossless frame's undifferenced samples
  int16_t* block(int bx, int by) { return coef.p + (static_cast<size_t>(by) * bw + bx) * 64; }
  const int16_t* block(int bx, int by) const {
    return coef.p + (static_cast<size_t>(by) * bw + bx) * 64;
  }
  int pt = 0;  // a lossless scan's point transform
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t len) : data_(data), len_(len) {
    for (int i = 0; i < 16; ++i) {
      arith_dc_l_[i] = 0;
      arith_dc_u_[i] = 1;
      arith_ac_k_[i] = 5;
    }
  }

  // Parse up to the first SOS (or through every scan when `full`).
  int parse(bool full);
  // `libjpeg3`: smooth as libjpeg-turbo 3 (Pillow) does, else as 2.1 (the
  // JAX package's build)
  int decode_rgb(int denom, bool cmyk_ok, bool libjpeg3, std::vector<uint8_t>& out, int* ow,
                 int* oh);

  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, arith = false, lossless = false;
  // libtiff's JPEG codec (tif_jpeg.c) sets the stream's colour space: -1
  // none (libjpeg's own default), 0 JCS_UNKNOWN (samples as stored), 1
  // JCS_YCbCr; (tiff_hs, tiff_vs) the sampling it expects of the first
  // component (the YCbCrSubsampling at YCbCr, else 1, 1), the others' 1
  int tiff_space = -1, tiff_hs = 1, tiff_vs = 1;
  // libjpeg's raw_data_out (old-style JPEG-in-TIFF): decode_rgb stops after
  // the IDCT, each component's MCU-padded plane left in raw_plane(i)
  bool raw_out = false;
  const Component& raw_plane(int i) const { return comp_[i]; }
  int max_h() const { return max_h_; }
  int max_v() const { return max_v_; }

 private:
  const uint8_t* data_;
  size_t len_, pos_ = 0;
  Huffman dc_[4], ac_[4];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Component comp_[4];
  int max_h_ = 1, max_v_ = 1;
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  bool frame_ = false;
  int mcus_x_ = 0, mcus_y_ = 0;

  // bit reader over the entropy-coded segment
  uint64_t bitbuf_ = 0;
  int bits_ = 0;
  bool at_marker_ = false;
  bool bad_data_ = false;  // the segment ran out, or held no valid code
  int eobrun_ = 0;

  // arithmetic decoding (jdarith.c): the C and A registers, the bit
  // counter (-1 after an error, as libjpeg's ct), the statistics bins and
  // the DAC conditioning (libjpeg's defaults L 0, U 1, K 5)
  int64_t ac_c_ = 0, ac_a_ = 0;
  int ac_ct_ = 0;
  uint8_t dc_stats_[16][64], ac_stats_[16][256], fixed_bin_[4] = {113, 0, 0, 0};
  int dc_context_[4] = {0, 0, 0, 0};
  uint8_t arith_dc_l_[16], arith_dc_u_[16], arith_ac_k_[16];

  int u8() { return pos_ < len_ ? data_[pos_++] : -1; }
  int u16() {
    const int a = u8(), b = u8();
    return (a < 0 || b < 0) ? -1 : (a << 8) | b;
  }
  int next_marker();
  int read_sof(int marker);
  int read_dht();
  int read_dqt();
  int read_sos();
  int read_dac();
  int read_app(int marker);

  void reset_bits() {
    bitbuf_ = 0;
    bits_ = 0;
    at_marker_ = false;
  }
  void fill() {
    while (bits_ <= 56) {
      if (at_marker_ || pos_ >= len_) return;
      int b = data_[pos_];
      if (b == 0xFF) {
        size_t p = pos_ + 1;
        while (p < len_ && data_[p] == 0xFF) ++p;
        if (p < len_ && data_[p] == 0x00) {
          pos_ = p + 1;
        } else {
          at_marker_ = true;  // leave pos_ at the marker
          return;
        }
      } else {
        ++pos_;
      }
      bitbuf_ |= static_cast<uint64_t>(b) << (56 - bits_);
      bits_ += 8;
    }
  }
  int get_bits(int n) {
    if (n == 0) return 0;
    if (bits_ < n) {
      fill();
      if (bits_ < n) {
        bad_data_ = true;
        bits_ = n;  // zero bits past the end; the decode fails at its end
      }
    }
    const int v = static_cast<int>(bitbuf_ >> (64 - n));
    bitbuf_ <<= n;
    bits_ -= n;
    return v;
  }
  int decode_huff(const Huffman& t) {
    if (bits_ < 16) fill();
    const int e = t.look[bitbuf_ >> (64 - kLookahead)];
    if (e) {  // a code of at most kLookahead bits
      const int nb = e >> 8;
      if (nb > bits_) {  // it ran past the segment's data
        bad_data_ = true;
        bits_ = nb;
      }
      bitbuf_ <<= nb;
      bits_ -= nb;
      return e & 0xFF;
    }
    int l = kLookahead + 1;
    int code = get_bits(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      if (++l > 16) {
        bad_data_ = true;  // no such code: corrupt data
        return 0;
      }
    }
    return t.values[(code + t.valoffset[l]) & 0xFF];
  }
  static int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

  int decode_scan(Component** sc, int n, int ss, int se, int ah, int al);
  int decode_lossless(Component** sc, int n, int predictor, int pt);
  int restart(int& expected, Component** sc, int n, int ss, int ah);
  void arith_reset(Component** sc, int n, int ss, int ah);
  int arith_byte();
  int arith_decode(uint8_t* st);
  int arith_dc_diff(int tbl, int ci, int* v);
  int arith_ac_value(int tbl, int k, uint8_t* st, int* v);
  void arith_sequential(Component& c, int ci, int16_t* blk);
  void arith_dc_first(Component& c, int ci, int16_t* blk, int al);
  void arith_ac_first(Component& c, int16_t* blk, int ss, int se, int al);
  void arith_ac_refine(Component& c, int16_t* blk, int ss, int se, int al);
  void decode_block_baseline(Component& c, int16_t* blk);
  void dc_first(Component& c, int16_t* blk, int al);
  void dc_refine(int16_t* blk, int al);
  void ac_first(Component& c, int16_t* blk, int ss, int se, int al);
  void ac_refine(Component& c, int16_t* blk, int ss, int se, int al);
};

int Decoder::next_marker() {
  // skip to the next 0xFF xx (xx not 0x00 / 0xFF), as libjpeg's next_marker
  while (pos_ < len_) {
    if (data_[pos_] != 0xFF) {
      ++pos_;
      continue;
    }
    while (pos_ < len_ && data_[pos_] == 0xFF) ++pos_;
    if (pos_ >= len_) return -1;
    const int m = data_[pos_++];
    if (m != 0x00) return m;
  }
  return -1;
}

int Decoder::read_app(int marker) {
  const int len = u16();
  if (len < 2 || pos_ + (len - 2) > len_) return kCorrupt;
  const uint8_t* d = data_ + pos_;
  const int n = len - 2;
  if (marker == 0xE0 && n >= 14 && d[0] == 'J' && d[1] == 'F' && d[2] == 'I' && d[3] == 'F' &&
      d[4] == 0)
    saw_jfif_ = true;
  if (marker == 0xEE && n >= 12 && d[0] == 'A' && d[1] == 'd' && d[2] == 'o' && d[3] == 'b' &&
      d[4] == 'e') {
    saw_adobe_ = true;
    adobe_transform_ = d[11];
  }
  pos_ += n;
  return kOk;
}

int Decoder::read_dqt() {
  int len = u16();
  if (len < 2 || pos_ + (len - 2) > len_) return kCorrupt;
  len -= 2;
  while (len > 0) {
    const int pq = u8();
    const int prec = pq >> 4, id = pq & 15;
    if (id > 3 || prec > 1) return kCorrupt;
    const int need = 1 + 64 * (prec + 1);
    if (len < need) return kCorrupt;
    for (int i = 0; i < 64; ++i) {
      const int v = prec ? u16() : u8();
      qt_[id][kNaturalOrder[i]] = static_cast<uint16_t>(v);
    }
    qt_defined_[id] = true;
    len -= need;
  }
  return len == 0 ? kOk : kCorrupt;
}

int Decoder::read_dht() {
  int len = u16();
  if (len < 2 || pos_ + (len - 2) > len_) return kCorrupt;
  len -= 2;
  while (len > 16) {
    const int tc_th = u8();
    const int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) return kCorrupt;
    Huffman& t = tc == 0 ? dc_[th] : ac_[th];
    int count = 0;
    t.counts[0] = 0;
    for (int l = 1; l <= 16; ++l) {
      t.counts[l] = static_cast<uint8_t>(u8());
      count += t.counts[l];
    }
    len -= 17;
    if (count > 256 || count > len) return kCorrupt;
    std::memset(t.values, 0, sizeof t.values);
    for (int i = 0; i < count; ++i) t.values[i] = static_cast<uint8_t>(u8());
    len -= count;
    if (!derive(t, tc == 0)) return kCorrupt;
    t.defined = true;
  }
  return len == 0 ? kOk : kCorrupt;
}

int Decoder::read_sof(int marker) {
  if (frame_) return kCorrupt;
  // SOF0/1 sequential, SOF2 progressive, SOF3 lossless (Huffman); SOF9 and
  // SOF10 their arithmetic-coded forms; hierarchical frames (SOF5-7,
  // 13-15) and arithmetic lossless (SOF11), which libjpeg-turbo refuses
  // too, are not read
  if (marker == 0xC2 || marker == 0xCA) {
    progressive = true;
  } else if (marker == 0xC3) {
    lossless = true;
  } else if (marker != 0xC0 && marker != 0xC1 && marker != 0xC9) {
    return kUnsupported;
  }
  arith = marker == 0xC9 || marker == 0xCA;
  const int len = u16();
  if (len < 8 || pos_ + (len - 2) > len_) return kCorrupt;
  const int precision = u8();
  height = u16();
  width = u16();
  ncomp = u8();
  if (precision != 8) return kUnsupported;
  if (height <= 0) return kUnsupported;  // a DNL-defined height
  if (width <= 0) return kCorrupt;
  if (int64_t(width) * height > kMaxPixels) return kTooLarge;
  if (ncomp != 1 && ncomp != 3 && ncomp != 4) return kUnsupported;
  if (len != 8 + 3 * ncomp) return kCorrupt;
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    c.id = u8();
    const int hv = u8();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = u8();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kCorrupt;
    max_h_ = std::max(max_h_, c.h);
    max_v_ = std::max(max_v_, c.v);
  }
  if (lossless && (max_h_ > 1 || max_v_ > 1)) return kUnsupported;  // subsampled lossless
  mcus_x_ = (width + 8 * max_h_ - 1) / (8 * max_h_);
  mcus_y_ = (height + 8 * max_v_ - 1) / (8 * max_v_);
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    c.width_in_blocks = static_cast<int>((int64_t(width) * c.h + 8 * max_h_ - 1) / (8 * max_h_));
    c.height_in_blocks = static_cast<int>((int64_t(height) * c.v + 8 * max_v_ - 1) / (8 * max_v_));
    c.bw = mcus_x_ * c.h;
    c.bh = mcus_y_ * c.v;
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  frame_ = true;
  return kOk;
}

// jdmarker.c get_dac: AC conditioning K and DC conditioning (L, U) by table
int Decoder::read_dac() {
  int len = u16();
  if (len < 2 || pos_ + (len - 2) > len_) return kCorrupt;
  len -= 2;
  while (len > 0) {
    if (len < 2) return kCorrupt;
    const int index = u8(), val = u8();
    len -= 2;
    if (index >= 32) return kCorrupt;
    if (index >= 16) {
      arith_ac_k_[index - 16] = static_cast<uint8_t>(val);
    } else {
      arith_dc_l_[index] = static_cast<uint8_t>(val & 15);
      arith_dc_u_[index] = static_cast<uint8_t>(val >> 4);
      if (arith_dc_l_[index] > arith_dc_u_[index]) return kCorrupt;
    }
  }
  return kOk;
}

int Decoder::read_sos() {
  if (!frame_) return kCorrupt;
  const int len = u16();
  const int n = u8();
  if (n < 1 || n > 4 || n > ncomp || len != 6 + 2 * n || pos_ + (len - 3) > len_) return kCorrupt;
  Component* sc[4];
  for (int i = 0; i < n; ++i) {
    const int id = u8(), t = u8();
    Component* c = nullptr;
    for (int k = 0; k < ncomp; ++k)
      if (comp_[k].id == id) c = &comp_[k];
    if (!c) return kCorrupt;
    for (int k = 0; k < i; ++k)
      if (sc[k] == c) return kCorrupt;
    c->td = t >> 4;
    c->ta = t & 15;
    if (!arith && (c->td > 3 || c->ta > 3)) return kCorrupt;
    sc[i] = c;
  }
  const int ss = u8(), se = u8(), a = u8();
  const int ah = a >> 4, al = a & 15;
  if (progressive) {  // jdphuff.c start_pass_phuff's checks (and jdarith.c's)
    if (ss == 0 ? se != 0 : (se < ss || se > 63 || n != 1)) return kCorrupt;
    if ((ah != 0 && al != ah - 1) || al > 13) return kCorrupt;
  } else if (lossless) {  // jdlossls.c: a predictor 1-7 and a point transform
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8) return kCorrupt;
  }  // a sequential scan's Ss, Se, Ah and Al are not read, as in libjpeg
  // blocks in an MCU: libjpeg's limit of 10
  if (n > 1) {
    int blocks = 0;
    for (int i = 0; i < n; ++i) blocks += sc[i]->h * sc[i]->v;
    if (blocks > 10) return kCorrupt;
  }
  if (lossless) {
    for (int i = 0; i < n; ++i) {
      Component& c = *sc[i];
      if (c.samples.empty()) c.samples.assign(static_cast<size_t>(width) * height, 0);
      c.latched = true;
    }
    return decode_lossless(sc, n, ss, al);
  }
  for (int i = 0; i < n; ++i) {
    Component& c = *sc[i];
    if (!c.latched) {  // jdinput.c latch_quant_tables: the table at the component's first scan
      if (!qt_defined_[c.tq]) return kCorrupt;
      std::memcpy(c.qt, qt_[c.tq], sizeof c.qt);
      c.latched = true;
    }
    if (!c.coef.p) c.coef.allocate(static_cast<size_t>(c.bw) * c.bh * 64);
  }
  return progressive ? decode_scan(sc, n, ss, se, ah, al) : decode_scan(sc, n, 0, 63, 0, 0);
}

void Decoder::decode_block_baseline(Component& c, int16_t* blk) {
  int s = decode_huff(dc_[c.td]);
  if (s) s = extend(get_bits(s), s);
  c.dc_pred += s;
  blk[0] = static_cast<int16_t>(c.dc_pred);
  const Huffman& t = ac_[c.ta];
  for (int k = 1; k < 64; ++k) {
    s = decode_huff(t);
    int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      r = get_bits(s);
      blk[kNaturalOrder[k]] = static_cast<int16_t>(extend(r, s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void Decoder::dc_first(Component& c, int16_t* blk, int al) {
  int s = decode_huff(dc_[c.td]);
  if (s) s = extend(get_bits(s), s);
  c.dc_pred += s;
  blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(c.dc_pred) << al));
}

void Decoder::dc_refine(int16_t* blk, int al) {
  if (get_bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
}

void Decoder::ac_first(Component& c, int16_t* blk, int ss, int se, int al) {
  if (eobrun_ > 0) {
    --eobrun_;
    return;
  }
  const Huffman& t = ac_[c.ta];
  for (int k = ss; k <= se; ++k) {
    int s = decode_huff(t);
    int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      r = get_bits(s);
      blk[kNaturalOrder[k]] =
          static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(extend(r, s)) << al));
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun_ = 1 << r;
      if (r) eobrun_ += get_bits(r);
      --eobrun_;
      break;
    }
  }
}

void Decoder::ac_refine(Component& c, int16_t* blk, int ss, int se, int al) {
  const int p1 = 1 << al;
  const int m1 = -1 * (1 << al);
  int k = ss;
  const Huffman& t = ac_[c.ta];
  if (eobrun_ == 0) {
    for (; k <= se; ++k) {
      int s = decode_huff(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        s = get_bits(1) ? p1 : m1;  // a newly nonzero coefficient (size 1)
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        break;
      }
      do {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef != 0) {
          if (get_bits(1) && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se; ++k) {
      int16_t* coef = blk + kNaturalOrder[k];
      if (*coef != 0 && get_bits(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    --eobrun_;
  }
}

int Decoder::restart(int& expected, Component** sc, int n, int ss, int ah) {
  // jdhuff.c / jdarith.c process_restart: drop the buffered bits, read
  // RSTn, reset the predictions (and the arithmetic coder's statistics)
  reset_bits();
  const int m = next_marker();
  if (m != 0xD0 + expected) return kCorrupt;
  expected = (expected + 1) & 7;
  for (int i = 0; i < ncomp; ++i) comp_[i].dc_pred = 0;
  eobrun_ = 0;
  if (arith) arith_reset(sc, n, ss, ah);
  return kOk;
}

// jdarith.c start_pass / process_restart: the statistics of the scan's
// tables zeroed, the DC predictions and contexts reset, the coder re-armed
// to read two bytes
void Decoder::arith_reset(Component** sc, int n, int ss, int ah) {
  for (int i = 0; i < n; ++i) {
    const Component& c = *sc[i];
    if (!progressive || (ss == 0 && ah == 0)) {
      std::memset(dc_stats_[c.td], 0, sizeof dc_stats_[c.td]);
      sc[i]->dc_pred = 0;
      dc_context_[i] = 0;
    }
    if (!progressive || ss) std::memset(ac_stats_[c.ta], 0, sizeof ac_stats_[c.ta]);
  }
  ac_c_ = 0;
  ac_a_ = 0;
  ac_ct_ = -16;
}

// jdarith.c get_byte with arith_decode's marker rule: past a marker the
// coder reads zeros; past the data's end the file is truncated
int Decoder::arith_byte() {
  if (at_marker_) return 0;
  if (pos_ >= len_) {
    bad_data_ = true;
    return 0;
  }
  const int b = data_[pos_];
  if (b != 0xFF) {
    ++pos_;
    return b;
  }
  size_t p = pos_ + 1;
  while (p < len_ && data_[p] == 0xFF) ++p;
  if (p >= len_) {
    bad_data_ = true;
    return 0;
  }
  if (data_[p] == 0) {
    pos_ = p + 1;
    return 0xFF;
  }
  at_marker_ = true;  // leave pos_ at the marker
  return 0;
}

// jdarith.c arith_decode: one binary decision in the statistics bin `st`
int Decoder::arith_decode(uint8_t* st) {
  while (ac_a_ < 0x8000) {
    if (--ac_ct_ < 0) {
      ac_c_ = (ac_c_ << 8) | arith_byte();
      if ((ac_ct_ += 8) < 0 && ++ac_ct_ == 0) ac_a_ = 0x8000;  // the two initial bytes
    }
    ac_a_ <<= 1;
  }
  int sv = *st;
  int64_t qe = kAritab[sv & 0x7F];
  const int nl = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  const int nm = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  int64_t temp = ac_a_ - qe;
  ac_a_ = temp;
  temp <<= ac_ct_;
  if (ac_c_ >= temp) {
    ac_c_ -= temp;
    if (ac_a_ < qe) {  // conditional LPS exchange
      ac_a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    } else {
      ac_a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (ac_a_ < 0x8000) {  // conditional MPS exchange
    if (ac_a_ < qe) {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

// A DC difference (T.81 F.1.4.4.1, jdarith.c), its conditioning updated;
// false after a magnitude overflow, which leaves the coder in its error state
int Decoder::arith_dc_diff(int tbl, int ci, int* v) {
  uint8_t* st = dc_stats_[tbl] + dc_context_[ci];
  if (arith_decode(st) == 0) {
    dc_context_[ci] = 0;
    *v = 0;
    return true;
  }
  const int sign = arith_decode(st + 1);
  st += 2 + sign;
  int m = arith_decode(st);
  if (m != 0) {
    st = dc_stats_[tbl] + 20;
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) {
        ac_ct_ = -1;
        return false;
      }
      st += 1;
    }
  }
  if (m < ((1 << arith_dc_l_[tbl]) >> 1))
    dc_context_[ci] = 0;
  else if (m > ((1 << arith_dc_u_[tbl]) >> 1))
    dc_context_[ci] = 12 + sign * 4;
  else
    dc_context_[ci] = 4 + sign * 4;
  int x = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(st)) x |= m;
  x += 1;
  *v = sign ? -x : x;
  return true;
}

// An AC value after its nonzero decision at `st` (T.81 F.1.4.4.2)
int Decoder::arith_ac_value(int tbl, int k, uint8_t* st, int* v) {
  const int sign = arith_decode(fixed_bin_);
  st += 2;
  int m = arith_decode(st);
  if (m != 0 && arith_decode(st)) {
    m <<= 1;
    st = ac_stats_[tbl] + (k <= arith_ac_k_[tbl] ? 189 : 217);
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) {
        ac_ct_ = -1;
        return false;
      }
      st += 1;
    }
  }
  int x = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(st)) x |= m;
  x += 1;
  *v = sign ? -x : x;
  return true;
}

void Decoder::arith_sequential(Component& c, int ci, int16_t* blk) {
  int v;
  if (!arith_dc_diff(c.td, ci, &v)) return;
  c.dc_pred = (c.dc_pred + v) & 0xffff;
  blk[0] = static_cast<int16_t>(c.dc_pred);
  const int tbl = c.ta;
  int k = 0;
  do {
    uint8_t* st = ac_stats_[tbl] + 3 * k;
    if (arith_decode(st)) break;  // end of block
    for (;;) {
      ++k;
      if (arith_decode(st + 1)) break;
      st += 3;
      if (k >= 63) {
        ac_ct_ = -1;  // spectral overflow
        return;
      }
    }
    if (!arith_ac_value(tbl, k, st, &v)) return;
    blk[kNaturalOrder[k]] = static_cast<int16_t>(v);
  } while (k < 63);
}

void Decoder::arith_dc_first(Component& c, int ci, int16_t* blk, int al) {
  int v;
  if (!arith_dc_diff(c.td, ci, &v)) return;
  c.dc_pred = (c.dc_pred + v) & 0xffff;
  blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(c.dc_pred) << al));
}

void Decoder::arith_ac_first(Component& c, int16_t* blk, int ss, int se, int al) {
  const int tbl = c.ta;
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
    if (arith_decode(st)) break;  // end of band
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > se) {
        ac_ct_ = -1;
        return;
      }
    }
    int v;
    if (!arith_ac_value(tbl, k, st, &v)) return;
    blk[kNaturalOrder[k]] =
        static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
  }
}

void Decoder::arith_ac_refine(Component& c, int16_t* blk, int ss, int se, int al) {
  const int tbl = c.ta;
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  int kex = se;  // the previous stage's end of block
  for (; kex > 0; --kex)
    if (blk[kNaturalOrder[kex]]) break;
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
    if (k > kex && arith_decode(st)) break;
    for (;;) {
      int16_t* coef = blk + kNaturalOrder[k];
      if (*coef) {  // a coefficient nonzero before: its correction bit
        if (arith_decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (arith_decode(st + 1)) {  // newly nonzero
        *coef = static_cast<int16_t>(arith_decode(fixed_bin_) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) {
        ac_ct_ = -1;
        return;
      }
    }
  }
}

// A lossless scan (jdlhuff.c, jddiffct.c, jdpred.c): Huffman-coded
// differences, undifferenced row by row with the scan's predictor, the
// first row of the scan and of each restart interval from its left
// neighbour (its first sample from 2^(P - Pt - 1)), every first column
// from the sample above; samples wrap at 16 bits.
int Decoder::decode_lossless(Component** sc, int n, int predictor, int pt) {
  for (int i = 0; i < n; ++i) {
    const Huffman& t = dc_[sc[i]->td];
    if (!t.defined || t.max_symbol > 16) return kCorrupt;
    sc[i]->pt = pt;
  }
  // libjpeg-turbo's lossless restarts fall on row boundaries only
  if (restart_interval_ % width) return kCorrupt;
  const int restart_rows = restart_interval_ / width;
  reset_bits();
  bad_data_ = false;
  std::vector<int> diff(static_cast<size_t>(n) * width);
  int rows_left = restart_rows, expected_rst = 0;
  bool first = true;
  for (int y = 0; y < height; ++y) {
    if (restart_interval_) {
      if (rows_left == 0) {
        if (restart(expected_rst, sc, n, 0, 0) != kOk) return kCorrupt;
        rows_left = restart_rows;
        first = true;
      }
      --rows_left;
    }
    for (int x = 0; x < width; ++x)
      for (int i = 0; i < n; ++i) {
        const int s = decode_huff(dc_[sc[i]->td]);
        diff[static_cast<size_t>(i) * width + x] =
            s == 0 ? 0 : s == 16 ? 32768 : extend(get_bits(s), s);
      }
    if (bad_data_) return kCorrupt;
    for (int i = 0; i < n; ++i) {
      const int* df = diff.data() + static_cast<size_t>(i) * width;
      uint16_t* row = sc[i]->samples.data() + static_cast<size_t>(y) * width;
      if (first) {
        int64_t ra = (df[0] + (1 << (8 - pt - 1))) & 0xFFFF;
        row[0] = static_cast<uint16_t>(ra);
        for (int x = 1; x < width; ++x) row[x] = static_cast<uint16_t>(ra = (df[x] + ra) & 0xFFFF);
        continue;
      }
      const uint16_t* prev = row - width;
      int64_t rb = prev[0], ra = (df[0] + rb) & 0xFFFF, rc;
      row[0] = static_cast<uint16_t>(ra);
      for (int x = 1; x < width; ++x) {
        rc = rb;
        rb = prev[x];
        int64_t p;
        switch (predictor) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        row[x] = static_cast<uint16_t>(ra = (df[x] + p) & 0xFFFF);
      }
    }
    first = false;
  }
  return kOk;
}

int Decoder::decode_scan(Component** sc, int n, int ss, int se, int ah, int al) {
  for (int i = 0; i < n; ++i) {
    Component& c = *sc[i];
    c.dc_pred = 0;
    const bool needs_dc = !progressive || (ss == 0 && ah == 0);
    const bool needs_ac = !progressive || ss > 0;
    if (!arith && ((needs_dc && (!dc_[c.td].defined || dc_[c.td].max_symbol > 15)) ||
                   (needs_ac && !ac_[c.ta].defined)))
      return kCorrupt;
    if (progressive) {
      // jdphuff.c: each coefficient's last successive-approximation bit
      for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
    }
  }
  eobrun_ = 0;
  reset_bits();
  bad_data_ = false;
  if (arith) arith_reset(sc, n, ss, ah);
  int mx, my;
  if (n == 1) {
    mx = sc[0]->width_in_blocks;
    my = sc[0]->height_in_blocks;
  } else {
    mx = mcus_x_;
    my = mcus_y_;
  }
  int restarts_left = restart_interval_;
  int expected_rst = 0;
  for (int y = 0; y < my; ++y) {
    for (int x = 0; x < mx; ++x) {
      if (restart_interval_) {
        if (restarts_left == 0) {
          if (restart(expected_rst, sc, n, ss, ah) != kOk) return kCorrupt;
          restarts_left = restart_interval_;
        }
        --restarts_left;
      }
      for (int i = 0; i < n; ++i) {
        Component& c = *sc[i];
        const int bh = n == 1 ? 1 : c.v, bwn = n == 1 ? 1 : c.h;
        for (int v = 0; v < bh; ++v) {
          for (int h = 0; h < bwn; ++h) {
            int16_t* blk = n == 1 ? c.block(x, y) : c.block(x * c.h + h, y * c.v + v);
            if (arith) {
              // after a decoding error libjpeg leaves the rest of the
              // restart interval as it is (jdarith.c's ct == -1)
              if (ac_ct_ == -1) continue;
              if (!progressive) arith_sequential(c, i, blk);
              else if (ss == 0 && ah == 0) arith_dc_first(c, i, blk, al);
              else if (ss == 0) {
                if (arith_decode(fixed_bin_)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
              } else if (ah == 0) {
                arith_ac_first(c, blk, ss, se, al);
              } else {
                arith_ac_refine(c, blk, ss, se, al);
              }
            } else if (!progressive) {
              decode_block_baseline(c, blk);
            } else if (ss == 0) {
              if (ah == 0) dc_first(c, blk, al);
              else dc_refine(blk, al);
            } else if (ah == 0) {
              ac_first(c, blk, ss, se, al);
            } else {
              ac_refine(c, blk, ss, se, al);
            }
          }
        }
      }
      if (bad_data_) return kCorrupt;
    }
  }
  // leave pos_ at the marker that ends the scan
  return kOk;
}

int Decoder::parse(bool full) {
  pos_ = 0;
  if (len_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8) return kNotJpeg;
  pos_ = 2;
  for (;;) {
    const int m = next_marker();
    if (m < 0) {  // no EOI: the data ends after the last scan
      if (!full) return frame_ ? kOk : kCorrupt;
      break;
    }
    int rc = kOk;
    if (m == 0xD8) {
      return kCorrupt;
    } else if (m == 0xD9) {
      break;
    } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      rc = read_sof(m);
    } else if (m == 0xC4) {
      rc = read_dht();
    } else if (m == 0xCC) {
      rc = read_dac();
    } else if (m == 0xDB) {
      rc = read_dqt();
    } else if (m == 0xDD) {
      if (u16() != 4 || pos_ + 2 > len_) return kCorrupt;
      restart_interval_ = u16();
    } else if (m == 0xDA) {
      if (!full) return frame_ ? kOk : kCorrupt;
      rc = read_sos();
    } else if (m >= 0xD0 && m <= 0xD7) {
      // a stray RSTn between scans: no parameters
    } else if (m == 0x01) {
      // TEM: no parameters
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC || m == 0xDE || m == 0xDF ||
               (m >= 0xF0 && m <= 0xFD)) {
      rc = read_app(m);
    } else {
      return kCorrupt;
    }
    if (rc != kOk) return rc;
    if (!full && frame_ && m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) return kOk;
  }
  if (!frame_) return kCorrupt;
  for (int i = 0; i < ncomp; ++i)
    if (lossless ? comp_[i].samples.empty() : !comp_[i].coef.p)
      return kCorrupt;  // a component no scan coded
  return kOk;
}

// ------------------------------------------------------------- upsampling
enum class Up { kFull, kInt, kH2V1Fancy, kH1V2Fancy, kH2V2Fancy };

enum class Space { kGray, kYcc, kRgb, kCmyk, kYcck };

struct UpPlan {
  Up kind = Up::kFull;
  int hx = 1, vx = 1;
};

// One output row of component c at output row y, out_w samples.
void upsample_row(const Component& c, const UpPlan& u, int y, int out_w, uint8_t* dst) {
  const uint8_t* plane = c.plane.data();
  const int stride = c.pstride;
  switch (u.kind) {
    case Up::kFull:
      std::memcpy(dst, plane + static_cast<size_t>(y) * stride, out_w);
      return;
    case Up::kInt: {
      const uint8_t* src = plane + static_cast<size_t>(y / u.vx) * stride;
      for (int x = 0; x < out_w; ++x) dst[x] = src[x / u.hx];
      return;
    }
    case Up::kH2V1Fancy: {
      // jdsample.c h2v1_fancy_upsample
      const uint8_t* in = plane + static_cast<size_t>(y) * stride;
      std::vector<uint8_t> row(static_cast<size_t>(c.dw) * 2);
      uint8_t* o = row.data();
      int v = in[0];
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < c.dw - 1; ++i) {
        v = in[i] * 3;
        *o++ = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
      }
      v = in[c.dw - 1];
      *o++ = static_cast<uint8_t>((v * 3 + in[c.dw - 2] + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
      std::memcpy(dst, row.data(), out_w);
      return;
    }
    case Up::kH1V2Fancy:
    case Up::kH2V2Fancy: {
      const int r = y / 2;
      const bool above = (y & 1) == 0;
      const int nb = std::min(c.dh - 1, std::max(0, above ? r - 1 : r + 1));
      const uint8_t* in0 = plane + static_cast<size_t>(r) * stride;
      const uint8_t* in1 = plane + static_cast<size_t>(nb) * stride;
      if (u.kind == Up::kH1V2Fancy) {
        // jdsample.c h1v2_fancy_upsample: bias 1 above, 2 below
        const int bias = above ? 1 : 2;
        for (int x = 0; x < out_w; ++x)
          dst[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
        return;
      }
      // jdsample.c h2v2_fancy_upsample
      std::vector<uint8_t> row(static_cast<size_t>(c.dw) * 2);
      uint8_t* o = row.data();
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int i = 2; i < c.dw; ++i) {
        next_sum = in0[i] * 3 + in1[i];
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      std::memcpy(dst, row.data(), out_w);
      return;
    }
  }
}

using IdctFn = void (*)(const int16_t*, const uint16_t*, uint8_t*, int);

// jdcoefct.c smoothing_ok: libjpeg smooths a progressive file's output when
// its scans leave any of a component's first 9 AC coefficients unrefined
// (or unsent), every DC at least partly known and the quantizers of those
// ten coefficients nonzero.
bool smoothing_ok(const Component* comp, int ncomp) {
  bool useful = false;
  for (int i = 0; i < ncomp; ++i) {
    const uint16_t* q = comp[i].qt;
    for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
      if (q[pos] == 0) return false;
    if (comp[i].coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (comp[i].coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
// block's unrefined low coefficients estimated from the DC values of the
// 5x5 blocks around it, then its IDCT.  Where no AC coefficient of the
// first nine was sent, the DC is re-estimated too (change_dc).  The edges
// follow each version's sliding registers: libjpeg-turbo 3 (Pillow's,
// `v3`) picks the rows around a block by its index in the image, counted
// by iMCU row, and fills both right registers from the second column;
// 2.1 (the JAX package's build) picks them by the block row within its
// iMCU row and the iMCU row, which for components of 2 block rows an iMCU
// row repeats a nearer row, and leaves the farther right register at the
// first column in a picture two blocks wide.
void smooth_idct(const Component& c, int imcu_rows, bool v3, IdctFn idct, int s,
                 uint8_t* plane, int pstride) {
  const int* cb = c.coef_bits;
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc = change_dc && cb[k] == -1;
  const uint16_t* q = c.qt;
  const int64_t q00 = q[0], q01 = q[1], q10 = q[8], q20 = q[16], q11 = q[9], q02 = q[2],
                q03 = q[3], q12 = q[10], q21 = q[17], q30 = q[24];
  const int last = c.width_in_blocks - 1;
  int16_t ws[64];
  auto estimate = [](int al, int64_t qk, int64_t num) {
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return static_cast<int16_t>(pred);
  };
  for (int imcu = 0; imcu < imcu_rows; ++imcu) {
    int block_rows = c.v;
    if (imcu == imcu_rows - 1) {
      block_rows = c.height_in_blocks % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int image_block_rows = block_rows * imcu_rows;
    for (int br = 0; br < block_rows; ++br) {
      const int ibr = imcu * block_rows + br;
      const int row = imcu * c.v + br;
      const int last_imcu = imcu_rows - 1;
      int rp, rpp, rn, rnn;
      if (v3) {
        rp = ibr > 0 ? row - 1 : row;
        rpp = ibr > 1 ? row - 2 : rp;
        rn = ibr < image_block_rows - 1 ? row + 1 : row;
        rnn = ibr < image_block_rows - 2 ? row + 2 : rn;
      } else {
        rp = (br > 0 || imcu > 0) ? row - 1 : row;
        rpp = (br > 1 || imcu > 1) ? row - 2 : rp;
        rn = (br < block_rows - 1 || imcu < last_imcu) ? row + 1 : row;
        rnn = (br < block_rows - 2 || imcu + 1 < last_imcu) ? row + 2 : rn;
      }
      auto dc = [&](int r, int col) { return static_cast<int>(c.block(col, r)[0]); };
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14,
          DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = dc(rpp, 0);
      DC06 = DC07 = DC08 = DC09 = DC10 = dc(rp, 0);
      DC11 = DC12 = DC13 = DC14 = DC15 = dc(row, 0);
      DC16 = DC17 = DC18 = DC19 = DC20 = dc(rn, 0);
      DC21 = DC22 = DC23 = DC24 = DC25 = dc(rnn, 0);
      for (int b = 0; b <= last; ++b) {
        std::memcpy(ws, c.block(b, row), sizeof ws);
        if (b == 0 && b < last) {
          DC04 = dc(rpp, 1);
          DC09 = dc(rp, 1);
          DC14 = dc(row, 1);
          DC19 = dc(rn, 1);
          DC24 = dc(rnn, 1);
          if (v3) {  // version 3 fills the far right registers from it too
            DC05 = DC04;
            DC10 = DC09;
            DC15 = DC14;
            DC20 = DC19;
            DC25 = DC24;
          }
        }
        if (b + 1 < last) {
          DC05 = dc(rpp, b + 2);
          DC10 = dc(rp, b + 2);
          DC15 = dc(row, b + 2);
          DC20 = dc(rn, b + 2);
          DC25 = dc(rnn, b + 2);
        }
        int al;
        if ((al = cb[1]) != 0 && ws[1] == 0)
          ws[1] = estimate(al, q01, q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
               3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
               13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)));
        if ((al = cb[2]) != 0 && ws[8] == 0)
          ws[8] = estimate(al, q10, q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
               13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)));
        if ((al = cb[3]) != 0 && ws[16] == 0)
          ws[16] = estimate(al, q20, q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
               2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)));
        if ((al = cb[4]) != 0 && ws[9] == 0)
          ws[9] = estimate(al, q11, q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
               DC06 + 10 * DC07 - 10 * DC09)));
        if ((al = cb[5]) != 0 && ws[2] == 0)
          ws[2] = estimate(al, q02, q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
               DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)));
        if (change_dc) {
          if ((al = cb[6]) != 0 && ws[3] == 0)
            ws[3] = estimate(al, q03, q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
          if ((al = cb[7]) != 0 && ws[10] == 0)
            ws[10] = estimate(al, q12, q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
          if ((al = cb[8]) != 0 && ws[17] == 0)
            ws[17] = estimate(al, q21, q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
          if ((al = cb[9]) != 0 && ws[24] == 0)
            ws[24] = estimate(al, q30, q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
          ws[0] = estimate(0, q00, q00 *
              (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
               42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
               42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
               2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25));
        }
        idct(ws, c.qt, plane + static_cast<size_t>(row) * s * pstride + b * s, pstride);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

// Decode to interleaved 8-bit output at 1/denom scale.  With cmyk_ok the
// 4-component images are given as Pillow's RGB, else they return kNoRgb.
int Decoder::decode_rgb(int denom, bool cmyk_ok, bool libjpeg3, std::vector<uint8_t>& out,
                        int* ow, int* oh) {
  int rc = parse(true);
  if (rc != kOk) return rc;
  // libjpeg's colour space of the file (jdapimin.c default_decompress_parms)
  Space space;
  if (ncomp == 1) {
    space = Space::kGray;
  } else if (ncomp == 3) {
    if (saw_jfif_) {
      space = Space::kYcc;
    } else if (saw_adobe_) {
      space = adobe_transform_ == 0 ? Space::kRgb : Space::kYcc;
    } else {
      // the component IDs: 'R', 'G', 'B' is RGB, and libjpeg-turbo 3 takes
      // any other lossless frame for RGB too
      const int a = comp_[0].id, b = comp_[1].id, c = comp_[2].id;
      space = ((a == 82 && b == 71 && c == 66) || lossless) ? Space::kRgb : Space::kYcc;
    }
  } else {
    space = (saw_adobe_ && adobe_transform_ != 0) ? Space::kYcck : Space::kCmyk;
    if (!cmyk_ok) return kNoRgb;
  }
  if (tiff_space >= 0) {
    if (ncomp != 1 && ncomp != 3) return kRefused;
    if (ncomp == 3) space = tiff_space == 1 ? Space::kYcc : Space::kRgb;
    // JPEGPreDecode's sampling checks: the first component's as the TIFF's
    // (libtiff fails at a smaller one too, after its warning), the others 1
    if (comp_[0].h != tiff_hs || comp_[0].v != tiff_vs) return kRefused;
    for (int i = 1; i < ncomp; ++i)
      if (comp_[i].h != 1 || comp_[i].v != 1) return kRefused;
  }
  // libjpeg-turbo 2.1 (the JAX package's build) reads no lossless frame,
  // and 3 converts no colour space of one
  if (lossless && !libjpeg3) return kNoRgb;
  if (lossless && (space == Space::kYcc || space == Space::kYcck)) return kRefused;
  const bool smooth = progressive && smoothing_ok(comp_, ncomp);
  // output size and each component's IDCT size (jdmaster.c
  // jpeg_calc_output_dimensions, the JPEG_LIB_VERSION 62 build)
  const int min_ss = 8 / denom;
  const int out_w = (width + denom - 1) / denom;
  const int out_h = (height + denom - 1) / denom;
  UpPlan plan[4];
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    int s = min_ss;
    while (s < 8 && (max_h_ * min_ss) % (c.h * s * 2) == 0 &&
           (max_v_ * min_ss) % (c.v * s * 2) == 0)
      s *= 2;
    c.ss = s;
    c.dw = static_cast<int>((int64_t(width) * c.h * s + 8 * max_h_ - 1) / (8 * max_h_));
    c.dh = static_cast<int>((int64_t(height) * c.v * s + 8 * max_v_ - 1) / (8 * max_v_));
    if (lossless) {  // the samples, scaled back by the point transform
      c.pstride = width;
      c.plane.resize(static_cast<size_t>(width) * height);
      for (size_t k = 0; k < c.plane.size(); ++k)
        c.plane[k] = static_cast<uint8_t>(c.samples[k] << c.pt);
    } else {
      c.pstride = c.width_in_blocks * s;
      c.plane.assign(static_cast<size_t>(c.pstride) * c.height_in_blocks * s, 0);
      const IdctFn idct = s == 8 ? idct_8x8 : s == 4 ? idct_4x4 : s == 2 ? idct_2x2 : idct_1x1;
      if (smooth) {
        smooth_idct(c, mcus_y_, libjpeg3, idct, s, c.plane.data(), c.pstride);
      } else {
        for (int by = 0; by < c.height_in_blocks; ++by)
          for (int bx = 0; bx < c.width_in_blocks; ++bx)
            idct(c.block(bx, by), c.qt,
                 c.plane.data() + static_cast<size_t>(by) * s * c.pstride + bx * s, c.pstride);
      }
      c.coef.release();
    }
    // jdsample.c jinit_upsampler's choice
    const int h_in = c.h * s / min_ss, v_in = c.v * s / min_ss;
    const bool fancy = min_ss > 1;
    UpPlan& u = plan[i];
    if (h_in == max_h_ && v_in == max_v_) {
      u.kind = Up::kFull;
    } else if (h_in * 2 == max_h_ && v_in == max_v_ && fancy && c.dw > 2) {
      u.kind = Up::kH2V1Fancy;
    } else if (h_in == max_h_ && v_in * 2 == max_v_ && fancy) {
      u.kind = Up::kH1V2Fancy;
    } else if (h_in * 2 == max_h_ && v_in * 2 == max_v_ && fancy && c.dw > 2) {
      u.kind = Up::kH2V2Fancy;
    } else if (max_h_ % h_in == 0 && max_v_ % v_in == 0) {
      u.kind = Up::kInt;
      u.hx = max_h_ / h_in;
      u.vx = max_v_ / v_in;
    } else {
      return kUnsupported;  // fractional sampling ratios (libjpeg refuses them too)
    }
  }
  if (raw_out) {
    *ow = out_w;
    *oh = out_h;
    return kOk;
  }
  out.assign(static_cast<size_t>(out_w) * out_h * 3, 0);
  std::vector<uint8_t> rows(static_cast<size_t>(out_w) * ncomp);
  for (int y = 0; y < out_h; ++y) {
    for (int i = 0; i < ncomp; ++i)
      upsample_row(comp_[i], plan[i], y, out_w, rows.data() + static_cast<size_t>(i) * out_w);
    const uint8_t* c0 = rows.data();
    const uint8_t* c1 = c0 + out_w;
    const uint8_t* c2 = c1 + out_w;
    const uint8_t* c3 = c2 + out_w;
    uint8_t* o = out.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x, o += 3) {
      switch (space) {
        case Space::kGray:
          o[0] = o[1] = o[2] = c0[x];
          break;
        case Space::kRgb:
          o[0] = c0[x];
          o[1] = c1[x];
          o[2] = c2[x];
          break;
        case Space::kYcc: {
          // jdcolor.c ycc_rgb_convert
          const int yy = c0[x], cb = c1[x], cr = c2[x];
          o[0] = clamp_simple(yy + kYcc.cr_r[cr]);
          o[1] = clamp_simple(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
          o[2] = clamp_simple(yy + kYcc.cb_b[cb]);
          break;
        }
        case Space::kCmyk:
        case Space::kYcck: {
          int cc, mm, ye;
          if (space == Space::kYcck) {
            // jdcolor.c ycck_cmyk_convert
            const int yy = c0[x], cb = c1[x], cr = c2[x];
            cc = clamp_simple(255 - (yy + kYcc.cr_r[cr]));
            mm = clamp_simple(255 - (yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
            ye = clamp_simple(255 - (yy + kYcc.cb_b[cb]));
          } else {
            cc = c0[x];
            mm = c1[x];
            ye = c2[x];
          }
          // Pillow reads the samples inverted ("CMYK;I", Adobe's polarity),
          // then converts CMYK to RGB
          fsvlm::cmyk_to_rgb(255 - cc, 255 - mm, 255 - ye, 255 - c3[x], o);
          break;
        }
      }
    }
  }
  *ow = out_w;
  *oh = out_h;
  return kOk;
}

// ------------------------------------------------- native/decoder.cpp's resize
// Separable bilinear resize RGB u8 (h, w) -> (oh, ow), as native/decoder.cpp
// computes it; its compiler fuses each multiply-add shown here with std::fma.
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst, int oh, int ow) {
  std::vector<int> x0(ow), x1(ow);
  std::vector<float> wx(ow);
  const float sx = static_cast<float>(w) / ow;
  for (int x = 0; x < ow; ++x) {
    const float fx = std::fma(static_cast<float>(x) + 0.5f, sx, -0.5f);
    const int i0 = std::max(0, std::min(w - 1, static_cast<int>(std::floor(fx))));
    x0[x] = i0;
    x1[x] = std::min(w - 1, i0 + 1);
    wx[x] = std::min(1.0f, std::max(0.0f, fx - i0));
  }
  std::vector<float> tmp(static_cast<size_t>(h) * ow * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const uint8_t* a = row + x0[x] * 3;
      const uint8_t* b = row + x1[x] * 3;
      const float t = wx[x];
      for (int ch = 0; ch < 3; ++ch)
        trow[x * 3 + ch] =
            std::fma(static_cast<float>(b[ch] - a[ch]), t, static_cast<float>(a[ch]));
    }
  }
  const float sy = static_cast<float>(h) / oh;
  for (int y = 0; y < oh; ++y) {
    const float fy = std::fma(static_cast<float>(y) + 0.5f, sy, -0.5f);
    const int y0 = std::max(0, std::min(h - 1, static_cast<int>(std::floor(fy))));
    const int y1 = std::min(h - 1, y0 + 1);
    const float t = std::min(1.0f, std::max(0.0f, fy - y0));
    const float* a = tmp.data() + static_cast<size_t>(y0) * ow * 3;
    const float* b = tmp.data() + static_cast<size_t>(y1) * ow * 3;
    uint8_t* drow = dst + static_cast<size_t>(y) * ow * 3;
    for (int i = 0; i < ow * 3; ++i)
      drow[i] = static_cast<uint8_t>(std::fma(b[i] - a[i], t, a[i]) + 0.5f);
  }
}

int read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kOpen;
  std::fseek(f, 0, SEEK_END);
  const long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (len < 0) {
    std::fclose(f);
    return kRead;
  }
  buf.resize(static_cast<size_t>(len));
  const size_t got = len ? std::fread(buf.data(), 1, buf.size(), f) : 0;
  std::fclose(f);
  return got == buf.size() ? kOk : kRead;
}

}  // namespace

// Runs an entry's body with no C++ exception crossing the C interface.
template <typename F>
int guarded(F&& body) {
  try {
    return body();
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kCorrupt;
  }
}

namespace fsvlm {

int jpeg_decode_tiff(const uint8_t* data, size_t n, bool ycbcr, int hs, int vs,
                     std::vector<uint8_t>& rgb, int* w, int* h) {
  Decoder d(data, n);
  d.tiff_space = ycbcr ? 1 : 0;
  d.tiff_hs = hs;
  d.tiff_vs = vs;
  const int rc = d.decode_rgb(1, false, true, rgb, w, h);
  return rc == kNoRgb ? static_cast<int>(kRefused) : rc == kNotJpeg ? static_cast<int>(kCorrupt) : rc;
}

int jpeg_decode_ycbcr_blocks(const uint8_t* data, size_t n, int* hs, int* vs,
                             std::vector<uint8_t>& blocks, int* w, int* h) {
  Decoder d(data, n);
  d.raw_out = true;
  std::vector<uint8_t> unused;
  int rc = d.decode_rgb(1, false, true, unused, w, h);
  if (rc != kOk) return rc == kNoRgb ? static_cast<int>(kRefused) : rc;
  if (d.ncomp != 3 || d.lossless) return kRefused;
  const Component &y = d.raw_plane(0), &cb = d.raw_plane(1), &cr = d.raw_plane(2);
  if (cb.h != 1 || cb.v != 1 || cr.h != 1 || cr.v != 1 || y.h != d.max_h() || y.v != d.max_v())
    return kRefused;
  *hs = y.h;
  *vs = y.v;
  const int bx = (*w + *hs - 1) / *hs, by = (*h + *vs - 1) / *vs, block = *hs * *vs + 2;
  if (static_cast<int64_t>(bx) * *hs > static_cast<int64_t>(y.pstride) || bx > cb.pstride)
    return kCorrupt;
  blocks.assign(static_cast<size_t>(bx) * by * block, 0);
  uint8_t* o = blocks.data();
  for (int r = 0; r < by; ++r)
    for (int c = 0; c < bx; ++c) {
      for (int sy = 0; sy < *vs; ++sy)
        for (int sx = 0; sx < *hs; ++sx)
          *o++ = y.plane[static_cast<size_t>(r * *vs + sy) * y.pstride + c * *hs + sx];
      *o++ = cb.plane[static_cast<size_t>(r) * cb.pstride + c];
      *o++ = cr.plane[static_cast<size_t>(r) * cr.pstride + c];
    }
  return kOk;
}

}  // namespace fsvlm

extern "C" {

// The image's width and height from its frame header.  Returns 0 on success.
int fsvlm_jpeg_size(const uint8_t* data, long len, int* w, int* h) {
  return guarded([&] {
    Decoder d(data, static_cast<size_t>(len));
    const int rc = d.parse(false);
    if (rc != kOk) return rc;
    *w = d.width;
    *h = d.height;
    return static_cast<int>(kOk);
  });
}

// Full-resolution RGB into `out` (w * h * 3 bytes, w and h from
// fsvlm_jpeg_size).  Returns 0 on success.
int fsvlm_jpeg_decode_full(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  return guarded([&] {
    Decoder d(data, static_cast<size_t>(len));
    std::vector<uint8_t> rgb;
    int ow = 0, oh = 0;
    const int rc = d.decode_rgb(1, true, true, rgb, &ow, &oh);
    if (rc != kOk) return rc;
    if (ow != w || oh != h) return static_cast<int>(kCorrupt);
    std::memcpy(out, rgb.data(), rgb.size());
    return static_cast<int>(kOk);
  });
}

// Decode with DCT-domain downscale, resize the shorter edge to pre_size,
// centre-crop to (pre_size, pre_size, 3) u8 into `out`.  Returns 0 on
// success, 1 for a CMYK or YCCK image (no RGB output, as libjpeg).
int fsvlm_jpeg_decode_resize_crop(const uint8_t* data, long len, int pre_size, uint8_t* out) {
  return guarded([&] {
    if (pre_size <= 0) return static_cast<int>(kCorrupt);
    Decoder d(data, static_cast<size_t>(len));
    int rc = d.parse(false);
    if (rc != kOk) return rc;
    // DCT-domain downscale: the largest 1/2^k that keeps the shorter edge >= pre_size
    const int shorter = std::min(d.width, d.height);
    int denom = 1;
    while (denom < 8 && shorter / (denom * 2) >= pre_size) denom *= 2;
    Decoder full(data, static_cast<size_t>(len));
    std::vector<uint8_t> raw;
    int w = 0, h = 0;
    rc = full.decode_rgb(denom, false, false, raw, &w, &h);
    if (rc != kOk) return rc;
    int ow, oh;
    if (w <= h) {
      ow = pre_size;
      oh = std::max(pre_size, static_cast<int>(std::lround(static_cast<double>(h) * pre_size / w)));
    } else {
      oh = pre_size;
      ow = std::max(pre_size, static_cast<int>(std::lround(static_cast<double>(w) * pre_size / h)));
    }
    std::vector<uint8_t> resized(static_cast<size_t>(ow) * oh * 3);
    resize_bilinear(raw.data(), h, w, resized.data(), oh, ow);
    const int left = (ow - pre_size) / 2;
    const int top = (oh - pre_size) / 2;
    for (int y = 0; y < pre_size; ++y)
      std::memcpy(out + static_cast<size_t>(y) * pre_size * 3,
                  resized.data() + (static_cast<size_t>(y + top) * ow + left) * 3,
                  static_cast<size_t>(pre_size) * 3);
    return static_cast<int>(kOk);
  });
}

// The file-path forms of the two decodes (the file read in C as well).
int fsvlm_jpeg_file_resize_crop(const char* path, int pre_size, uint8_t* out) {
  std::vector<uint8_t> buf;
  const int rc = guarded([&] { return read_file(path, buf); });
  if (rc != kOk) return rc;
  return fsvlm_jpeg_decode_resize_crop(buf.data(), static_cast<long>(buf.size()), pre_size, out);
}

}  // extern "C"
