// The port's VP8 decoder: a WebP file's lossy key frame, with no library,
// decoding as libwebp 1.6.0 decodes it (src/dec/vp8_dec.c, tree_dec.c,
// quant_dec.c, frame_dec.c, io_dec.c and the plain C of src/dsp/dec.c,
// upsampling.c and yuv.h, which its SIMD versions equal bit for bit):
//
//  - The boolean decoder and its end: a partition read past its last byte
//    fails the frame (libwebp's eof_), as does partition 0's.
//  - The frame header: key frames only, profile 0-3 (ignored past its
//    check), shown; colour space and clamping type read and ignored;
//    segmentation with its tree probabilities and its absolute or relative
//    quantizer and filter updates; the filter type, level and sharpness and
//    the reference and mode loop-filter deltas; 1, 2, 4 or 8 token
//    partitions (a size past the data clipped, the last one not empty); the
//    base quantizer and its five deltas into RFC 6386's tables (the Y2 AC
//    factor x155/100, at least 8; chroma DC at most index 117); the
//    coefficient-probability updates over RFC 6386's defaults; the skip
//    probability.
//  - Per macroblock: the segment, the skip flag, 16x16 or 4x4 luma modes
//    (the ten 4x4 modes by the contexts of kBModesProba) and the chroma
//    mode; the tokens with their band and neighbour contexts, dequantized
//    into int16 as libwebp stores them, the Y2 block through the inverse
//    WHT; a skipped macroblock leaves the Y2 context of a 4x4 one as it is.
//  - Prediction with libwebp's edges: 127 above the frame, 129 left of it,
//    the corner 127 on the top row and 129 below it, the DC modes of the
//    16x16 and chroma blocks without the missing edges, the top-right of
//    a 4x4 block in the right column taken from the macroblock above-right
//    (the one above's last pixel at the right edge) for every row of the
//    macroblock; prediction reads the unfiltered reconstruction.
//  - The inverse DCT with libwebp's constants (20091, 35468) and rounding;
//    the simple (luma only) and normal loop filters in macroblock order,
//    the level from the segment and the mode deltas, sharpness, interior
//    and high-edge-variance limits, inner edges where a block is 4x4 or
//    has coefficients; no filtering where the frame's level is 0.
//  - Output: the frame cropped to its size, YUV 4:2:0 to RGB through the
//    fancy upsampler (the 9-3-3-1 filter on two rows, the first and an
//    even height's last row from one chroma row, an even width's last
//    column from one chroma column) and yuv.h's 14-bit fixed point.

#include <cstdint>
#include <cstring>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

// RFC 6386's default token probabilities, their update probabilities, and
// the 4x4 mode probabilities by the modes above and left, in libwebp's
// order of the modes ([type][band][context][node], [top][left][node]).
constexpr uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

constexpr uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

constexpr uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
constexpr uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
    18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
    44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
    59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
    75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
    91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
constexpr uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
    78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's mode numbers: the 4x4 modes, and the 16x16 and chroma modes
// under the 4x4 names of their contexts
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE };
// the 4x4 mode tree (kYModesIntra4): a leaf is minus its mode
constexpr int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                      -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// VP8BitReader: 56 bits loaded at a time while 8 bytes are left, then one
// byte at a time; reading past the end sets eof (its first time shifts in
// 8 zero bits)
struct BoolDecoder {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 255 - 1;
  bool eof = false;

  void init(const uint8_t* d, size_t n) {
    buf = d;
    end = d + n;
    value = 0;
    bits = -8;
    range = 255 - 1;
    eof = false;
    load();
  }
  void load() {
    if (end - buf >= 8) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = (value << 56) | in;
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * prob) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // VP8GetSigned: v with a sign read at probability 1/2
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= uint64_t((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(bit(0x80)) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = static_cast<int>(value_bits(n));
    return bit(0x80) ? -v : v;
  }
};

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct MB {
  uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16] = {0};
};

constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return (v & ~0xff) == 0 ? v : v < 0 ? 0 : 255; }

// --- prediction (dsp/dec.c), dst in the BPS-strided work buffer
#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// the 16x16 and 8x8 modes; DC by its edges (CheckMode)
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    default: {  // DC
      int dc = 0;
      if (has_top && has_left) {
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill(dst, size, (dc + size) >> (shift + 1));
      } else if (has_left) {
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        fill(dst, size, (dc + size / 2) >> shift);
      } else if (has_top) {
        for (int j = 0; j < size; ++j) dc += dst[j - BPS];
        fill(dst, size, (dc + size / 2) >> shift);
      } else {
        fill(dst, size, 0x80);
      }
    }
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST

// --- transforms.  libwebp picks one by a block's code (DoTransform): the
// full inverse DCT in its SSE2 form (16-bit lanes, which wrap where a
// corrupt stream's coefficients leave the range a real encoder writes), or
// the C forms for the first three coefficients and for the DC alone (int).
// On every stream an encoder writes they agree with the reference C.
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t a, int k) { return w16((int32_t(a) * k) >> 16); }

// Transform_SSE2: the inverse DCT of `in` added to the 4x4 block at dst
void idct_add(const int16_t* in, uint8_t* dst) {
  int16_t t[4][4];  // after the vertical pass: t[k][i], column i's k-th output
  for (int i = 0; i < 4; ++i) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16((i1 - i3) + (mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int16_t d = w16((i1 + i3) + (mulhi(i1, 20091) + mulhi(i3, -30068)));
    t[0][i] = w16(a + d);
    t[1][i] = w16(b + c);
    t[2][i] = w16(b - c);
    t[3][i] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r) {  // horizontal pass over row r
    const int16_t T0 = t[r][0], T1 = t[r][1], T2 = t[r][2], T3 = t[r][3];
    const int16_t dc = w16(T0 + 4);
    const int16_t a = w16(dc + T2), b = w16(dc - T2);
    const int16_t c = w16((T1 - T3) + (mulhi(T1, -30068) - mulhi(T3, 20091)));
    const int16_t d = w16((T1 + T3) + (mulhi(T1, 20091) + mulhi(T3, -30068)));
    const int16_t out[4] = {w16(w16(a + d) >> 3), w16(w16(b + c) >> 3), w16(w16(b - c) >> 3),
                            w16(w16(a - d) >> 3)};
    for (int k = 0; k < 4; ++k) {
      const int16_t v = w16(dst[k] + out[k]);  // _mm_add_epi16, then _mm_packus_epi16
      dst[k] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
    dst += BPS;
  }
}

// TransformAC3_C: in[0], in[1] and in[4] only
void idct_ac3_add(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y, dst += BPS) {
    dst[0] = clip8(dst[0] + ((dcs[y] + d1) >> 3));
    dst[1] = clip8(dst[1] + ((dcs[y] + c1) >> 3));
    dst[2] = clip8(dst[2] + ((dcs[y] - c1) >> 3));
    dst[3] = clip8(dst[3] + ((dcs[y] - d1) >> 3));
  }
}

// TransformDC_C
void idct_dc_add(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y, dst += BPS)
    for (int x = 0; x < 4; ++x) dst[x] = clip8(dst[x] + (dc >> 3));
}

// DoTransform by a block's 2-bit code
void transform_add(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3)
    idct_add(in, dst);
  else if (code == 2)
    idct_ac3_add(in, dst);
  else if (code == 1)
    idct_dc_add(in, dst);
}

// TransformWHT: the Y2 block's inverse into the DC of the 16 luma blocks
void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// --- loop filters (dsp/dec.c), p at the first pixel past the edge
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline int iabs(int v) { return v < 0 ? -v : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * iabs(p0 - q0) + iabs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * iabs(p0 - q0) + iabs(p1 - q1) > t) return false;
  return iabs(p3 - p2) <= it && iabs(p2 - p1) <= it && iabs(p1 - p0) <= it &&
         iabs(q3 - q2) <= it && iabs(q2 - q1) <= it && iabs(q1 - q0) <= it;
}

// the simple filter along one edge of `size` pixels: hstride across the
// edge, vstride along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

// FilterLoop26 (macroblock edges) and FilterLoop24 (inner edges)
void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                  int hev_thresh, bool inner) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      filter2(p, hstride);
    else if (inner)
      filter4(p, hstride);
    else
      filter6(p, hstride);
  }
}

// --- YUV -> RGB (yuv.h) and the fancy upsampler (upsampling.c)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return static_cast<uint8_t>((v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

inline uint32_t load_uv(int u, int v) { return uint32_t(u) | (uint32_t(v) << 16); }

// UpsampleRgbaLinePair: the top row (and the bottom one if given) of RGBA
// from two chroma rows, u and v packed in one word as libwebp packs them
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  auto put = [](int y, uint32_t uv, uint8_t* dst) {
    yuv_to_rgb(y, uv & 0xff, uv >> 16, dst);
    dst[3] = 0xff;
  };
  put(top_y[0], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst);
  if (bottom_y) put(bottom_y[0], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    put(top_y[2 * x - 1], (diag_12 + tl_uv) >> 1, top_dst + (2 * x - 1) * 4);
    put(top_y[2 * x], (diag_03 + t_uv) >> 1, top_dst + (2 * x) * 4);
    if (bottom_y) {
      put(bottom_y[2 * x - 1], (diag_03 + l_uv) >> 1, bottom_dst + (2 * x - 1) * 4);
      put(bottom_y[2 * x], (diag_12 + uv) >> 1, bottom_dst + (2 * x) * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    put(top_y[len - 1], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst + (len - 1) * 4);
    if (bottom_y)
      put(bottom_y[len - 1], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst + (len - 1) * 4);
  }
}

class Decoder {
 public:
  int decode(const uint8_t* data, size_t size, uint8_t* out, size_t stride) {
    int rc = headers(data, size);
    if (rc != kOk) return rc;
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    y_.assign(size_t(yw) * mb_h_ * 16, 0);
    u_.assign(size_t(uvw) * mb_h_ * 8, 0);
    v_.assign(size_t(uvw) * mb_h_ * 8, 0);
    finfo_.assign(size_t(mb_w_) * mb_h_, FilterInfo());
    intra_t_.assign(size_t(mb_w_) * 4, B_DC);
    top_nz_.assign(size_t(mb_w_) * 9, 0);
    std::vector<MB> row(mb_w_);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_modes(mb_x, intra_l, &row[mb_x]);
      if (br_.eof) return kCorrupt;
      BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
      uint8_t left_nz[9] = {0};
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const MB& mb = row[mb_x];
        bool skip = use_skip_proba_ && mb.skip;
        uint8_t* top_nz = &top_nz_[size_t(mb_x) * 9];
        std::memset(coeffs_, 0, sizeof(coeffs_));
        uint32_t nz_y = 0, nz_uv = 0;
        if (!skip) {
          skip = residuals(tokens, mb, top_nz, left_nz, &nz_y, &nz_uv);
        } else {
          std::memset(top_nz, 0, 8);
          std::memset(left_nz, 0, 8);
          if (!mb.is_i4x4) top_nz[8] = left_nz[8] = 0;
        }
        if (filter_type_ > 0) {
          FilterInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
          f = fstrengths_[mb.segment][mb.is_i4x4];
          f.inner |= !skip;
        }
        if (tokens.eof) return kCorrupt;
        reconstruct(mb_x, mb_y, mb, nz_y, nz_uv);
      }
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) filter_mb(mb_x, mb_y);
    emit(out, stride);
    return kOk;
  }

 private:
  // VP8GetHeaders
  int headers(const uint8_t* data, size_t size) {
    if (size < 10) return kCorrupt;
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3 || !show || !key_frame) return kCorrupt;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kCorrupt;
    width_ = ((data[7] << 8) | data[6]) & 0x3fff;
    height_ = ((data[9] << 8) | data[8]) & 0x3fff;
    if (width_ == 0 || height_ == 0) return kCorrupt;
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t buf_size = size - 10;
    if (partition_length > buf_size) return kCorrupt;
    br_.init(buf, partition_length);
    buf += partition_length;
    buf_size -= partition_length;
    br_.bit(0x80);  // colour space
    br_.bit(0x80);  // clamping type
    // ParseSegmentHeader
    use_segment_ = br_.bit(0x80);
    if (use_segment_) {
      update_map_ = br_.bit(0x80);
      if (br_.bit(0x80)) {
        absolute_delta_ = br_.bit(0x80);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.bit(0x80) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.bit(0x80) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) segments_[s] = br_.bit(0x80) ? br_.value_bits(8) : 255;
    }
    if (br_.eof) return kCorrupt;
    // ParseFilterHeader
    simple_ = br_.bit(0x80);
    level_ = static_cast<int>(br_.value_bits(6));
    sharpness_ = static_cast<int>(br_.value_bits(3));
    use_lf_delta_ = br_.bit(0x80);
    if (use_lf_delta_ && br_.bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof) return kCorrupt;
    // ParsePartitions
    num_parts_ = 1 << br_.value_bits(2);
    const size_t last = num_parts_ - 1;
    if (buf_size < 3 * last) return kCorrupt;
    const uint8_t* sz = buf;
    const uint8_t* part = buf + 3 * last;
    size_t left = buf_size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(part, psize);
      part += psize;
      left -= psize;
    }
    parts_[last].init(part, left);
    if (left == 0) return kCorrupt;
    parse_quant();
    br_.bit(0x80);  // refresh entropy probs, ignored
    // VP8ParseProba
    for (int i = 0; i < 4 * 8 * 3 * 11; ++i)
      bands_[i] = br_.bit(kCoeffsUpdateProba[i]) ? br_.value_bits(8) : kCoeffsProba0[i];
    use_skip_proba_ = br_.bit(0x80);
    if (use_skip_proba_) skip_p_ = static_cast<int>(br_.value_bits(8));
    precompute_filter_strengths();
    return kOk;
  }

  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolDecoder br_, parts_[8];
  int num_parts_ = 1;
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint32_t segments_[3] = {255, 255, 255};
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  int filter_type_ = 0;
  uint8_t bands_[4 * 8 * 3 * 11];
  int use_skip_proba_ = 0, skip_p_ = 0;
  Quant dqm_[4];
  FilterInfo fstrengths_[4][2];
  std::vector<uint8_t> y_, u_, v_;
  std::vector<FilterInfo> finfo_;
  std::vector<uint8_t> intra_t_;
  std::vector<uint8_t> top_nz_;  // per macroblock: 4 luma, 2 u, 2 v, then the Y2 flag
  int16_t coeffs_[384];
  uint8_t work_[YUV_SIZE];

  // VP8ParseQuant
  void parse_quant() {
    const int base_q0 = static_cast<int>(br_.value_bits(7));
    auto delta = [&] { return br_.bit(0x80) ? br_.signed_value(4) : 0; };
    const int dqy1_dc = delta(), dqy2_dc = delta(), dqy2_ac = delta(), dquv_dc = delta(),
              dquv_ac = delta();
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else {
        if (i > 0) {
          dqm_[i] = dqm_[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment_) {
        base_level = filter_strength_[s];
        if (!absolute_delta_) base_level += level_;
      } else {
        base_level = level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base_level;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = static_cast<uint8_t>(ilevel);
          info.limit = static_cast<uint8_t>(2 * level + ilevel);
          info.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = static_cast<uint8_t>(i4x4);
      }
    }
  }

  // ParseIntraMode
  void parse_modes(int mb_x, uint8_t* left, MB* mb) {
    uint8_t* top = &intra_t_[size_t(mb_x) * 4];
    if (update_map_) {
      mb->segment = !br_.bit(segments_[0]) ? br_.bit(segments_[1])
                                           : br_.bit(segments_[2]) + 2;
    } else {
      mb->segment = 0;
    }
    if (use_skip_proba_) mb->skip = br_.bit(skip_p_);
    mb->is_i4x4 = !br_.bit(145);
    if (!mb->is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED)
                                     : (br_.bit(163) ? V_PRED : DC_PRED);
      mb->imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb->imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb->uvmode = !br_.bit(142) ? DC_PRED : !br_.bit(114) ? V_PRED : br_.bit(183) ? TM_PRED : H_PRED;
  }

  // GetLargeValue
  static int large_value(BoolDecoder& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  const uint8_t* proba(int type, int n, int ctx) const {
    return bands_ + ((type * 8 + kBands[n]) * 3 + ctx) * 11;
  }

  // GetCoeffs: the tokens of one block from position n; returns the
  // position past the last one read (16 after a run of zeros to the end)
  int coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n, int16_t* out) const {
    const uint8_t* p = proba(type, n, ctx);
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        if (++n == 16) return 16;
        p = proba(type, n, 0);
      }
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = proba(type, n + 1, 1);
      } else {
        v = large_value(br, p);
        p = proba(type, n + 1, 2);
      }
      out[kZigzag[n]] = static_cast<int16_t>(br.sign(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code(int nz, int dc_nz) { return nz > 3 ? 3 : nz > 1 ? 2 : dc_nz; }

  // ParseResiduals: returns whether every block's code is 0
  bool residuals(BoolDecoder& br, const MB& mb, uint8_t* top_nz, uint8_t* left_nz, uint32_t* nz_y,
                 uint32_t* nz_uv) {
    const Quant& q = dqm_[mb.segment];
    int16_t* dst = coeffs_;
    int first, type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_nz[8] + left_nz[8];
      const int nz = coeffs(br, 1, ctx, q.y2, 0, dc);
      top_nz[8] = left_nz[8] = nz > 0;
      inverse_wht(dc, dst);
      first = 1;
      type = 0;
    } else {
      first = 0;
      type = 3;
    }
    uint32_t y_bits = 0;
    for (int y = 0; y < 4; ++y) {
      int l = left_nz[y];
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + top_nz[x];
        const int nz = coeffs(br, type, ctx, q.y1, first, dst);
        l = nz > first;
        top_nz[x] = static_cast<uint8_t>(l);
        y_bits = (y_bits << 2) | nz_code(nz, dst[0] != 0);
        dst += 16;
      }
      left_nz[y] = static_cast<uint8_t>(l);
    }
    uint32_t uv_bits = 0;
    for (int ch = 0; ch < 2; ++ch) {
      uint32_t bits = 0;
      for (int y = 0; y < 2; ++y) {
        int l = left_nz[4 + 2 * ch + y];
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + top_nz[4 + 2 * ch + x];
          const int nz = coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          top_nz[4 + 2 * ch + x] = static_cast<uint8_t>(l);
          bits = (bits << 2) | nz_code(nz, dst[0] != 0);
          dst += 16;
        }
        left_nz[4 + 2 * ch + y] = static_cast<uint8_t>(l);
      }
      uv_bits |= bits << (8 * ch);
    }
    *nz_y = y_bits;
    *nz_uv = uv_bits;
    return !(y_bits | uv_bits);
  }

  // ReconstructRow for one macroblock, through libwebp's work buffer
  void reconstruct(int mb_x, int mb_y, const MB& mb, uint32_t nz_y, uint32_t nz_uv) {
    uint8_t* const ydst = work_ + Y_OFF;
    uint8_t* const udst = work_ + U_OFF;
    uint8_t* const vdst = work_ + V_OFF;
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    uint8_t* const yf = y_.data() + size_t(mb_y) * 16 * yw + mb_x * 16;
    uint8_t* const uf = u_.data() + size_t(mb_y) * 8 * uvw + mb_x * 8;
    uint8_t* const vf = v_.data() + size_t(mb_y) * 8 * uvw + mb_x * 8;
    // left column, top row and corner
    for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = mb_x > 0 ? yf[j * yw - 1] : 129;
    for (int j = 0; j < 8; ++j) {
      udst[j * BPS - 1] = mb_x > 0 ? uf[j * uvw - 1] : 129;
      vdst[j * BPS - 1] = mb_x > 0 ? vf[j * uvw - 1] : 129;
    }
    if (mb_y > 0) {
      std::memcpy(ydst - BPS, yf - yw, 16);
      std::memcpy(udst - BPS, uf - uvw, 8);
      std::memcpy(vdst - BPS, vf - uvw, 8);
      ydst[-BPS - 1] = mb_x > 0 ? yf[-yw - 1] : 129;
      udst[-BPS - 1] = mb_x > 0 ? uf[-uvw - 1] : 129;
      vdst[-BPS - 1] = mb_x > 0 ? vf[-uvw - 1] : 129;
    } else {
      std::memset(ydst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(udst - BPS - 1, 127, 8 + 1);
      std::memset(vdst - BPS - 1, 127, 8 + 1);
    }
    if (mb.is_i4x4) {
      uint8_t* top_right = ydst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w_ - 1)
          std::memset(top_right, yf[-yw + 15], 4);
        else
          std::memcpy(top_right, yf - yw + 16, 4);
      }
      for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
      uint32_t bits = nz_y;
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(dst, mb.imodes[n]);
        transform_add(bits >> 30, coeffs_ + n * 16, dst);
      }
    } else {
      predict_block(ydst, 16, mb.imodes[0], mb_y > 0, mb_x > 0);
      uint32_t bits = nz_y;
      for (int n = 0; n < 16; ++n, bits <<= 2)
        transform_add(bits >> 30, coeffs_ + n * 16, ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    predict_block(udst, 8, mb.uvmode, mb_y > 0, mb_x > 0);
    predict_block(vdst, 8, mb.uvmode, mb_y > 0, mb_x > 0);
    for (int ch = 0; ch < 2; ++ch) {  // DoUVTransform
      uint8_t* dst = ch ? vdst : udst;
      const uint32_t bits = (nz_uv >> (8 * ch)) & 0xff;
      if (!bits) continue;
      for (int n = 0; n < 4; ++n) {
        const int16_t* in = coeffs_ + (16 + 4 * ch + n) * 16;
        uint8_t* block = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
        if (bits & 0xaa)
          idct_add(in, block);
        else if (in[0])
          idct_dc_add(in, block);
      }
    }
    for (int j = 0; j < 16; ++j) std::memcpy(yf + j * yw, ydst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(uf + j * uvw, udst + j * BPS, 8);
      std::memcpy(vf + j * uvw, vdst + j * BPS, 8);
    }
  }

  // DoFilter
  void filter_mb(int mb_x, int mb_y) {
    const FilterInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    uint8_t* const yd = y_.data() + size_t(mb_y) * 16 * yw + mb_x * 16;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_edge(yd, 1, yw, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(yd + 4 * k, 1, yw, limit);
      if (mb_y > 0) simple_edge(yd, yw, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(yd + 4 * k * yw, yw, 1, limit);
      return;
    }
    uint8_t* const ud = u_.data() + size_t(mb_y) * 8 * uvw + mb_x * 8;
    uint8_t* const vd = v_.data() + size_t(mb_y) * 8 * uvw + mb_x * 8;
    const int il = f.ilevel, hv = f.hev;
    if (mb_x > 0) {
      complex_edge(yd, 1, yw, 16, limit + 4, il, hv, false);
      complex_edge(ud, 1, uvw, 8, limit + 4, il, hv, false);
      complex_edge(vd, 1, uvw, 8, limit + 4, il, hv, false);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) complex_edge(yd + 4 * k, 1, yw, 16, limit, il, hv, true);
      complex_edge(ud + 4, 1, uvw, 8, limit, il, hv, true);
      complex_edge(vd + 4, 1, uvw, 8, limit, il, hv, true);
    }
    if (mb_y > 0) {
      complex_edge(yd, yw, 1, 16, limit + 4, il, hv, false);
      complex_edge(ud, uvw, 1, 8, limit + 4, il, hv, false);
      complex_edge(vd, uvw, 1, 8, limit + 4, il, hv, false);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) complex_edge(yd + 4 * k * yw, yw, 1, 16, limit, il, hv, true);
      complex_edge(ud + 4 * uvw, uvw, 1, 8, limit, il, hv, true);
      complex_edge(vd + 4 * uvw, uvw, 1, 8, limit, il, hv, true);
    }
  }

  // EmitFancyRGB over the whole frame
  void emit(uint8_t* out, size_t stride) {
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8, w = width_, h = height_;
    const uint8_t* Y = y_.data();
    const uint8_t* U = u_.data();
    const uint8_t* V = v_.data();
    upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
    int k = 1;
    for (; 2 * k <= h - 1; ++k)
      upsample_pair(Y + size_t(2 * k - 1) * yw, Y + size_t(2 * k) * yw, U + size_t(k - 1) * uvw,
                    V + size_t(k - 1) * uvw, U + size_t(k) * uvw, V + size_t(k) * uvw,
                    out + (2 * k - 1) * stride, out + (2 * k) * stride, w);
    if (!(h & 1)) {
      const size_t c = size_t(h / 2 - 1) * uvw;
      upsample_pair(Y + size_t(h - 1) * yw, nullptr, U + c, V + c, U + c, V + c,
                    out + (h - 1) * stride, nullptr, w);
    }
  }
};

}  // namespace

int fsvlm::vp8_info(const uint8_t* data, size_t n, size_t chunk_size, int* w, int* h) {
  // VP8GetInfo
  if (n < 10 || data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kCorrupt;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size)
    return kCorrupt;
  *w = ((data[7] << 8) | data[6]) & 0x3fff;
  *h = ((data[9] << 8) | data[8]) & 0x3fff;
  return *w && *h ? kOk : kCorrupt;
}

int fsvlm::vp8_decode_rgba(const uint8_t* data, size_t n, uint8_t* out, size_t stride) {
  Decoder dec;
  return dec.decode(data, n, out, stride);
}
