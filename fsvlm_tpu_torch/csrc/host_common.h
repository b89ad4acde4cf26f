// What the port's host decoders share: their return codes, Pillow's
// decompression-bomb limit, the zlib inflate of png_decoder.cpp (which
// tiff_decoder.cpp's Deflate strips use too), WebP's VP8L and VP8 codecs
// (which webp_decoder.cpp's container calls), Pillow's CMYK->RGB, the
// bit-exact Python round() of a sample's rescale, and the guard that keeps
// a C++ exception from crossing the C interface.
//
// Every decoder is compiled with the others into one library by
// fsvlm_tpu_torch/native.py; the status codes are read there.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <new>
#include <vector>

namespace fsvlm {

enum Status {
  kOk = 0,
  kNoRgb = 1,        // CMYK / YCCK JPEG at a DCT scale: libjpeg gives no RGB output
  kCorrupt = 2,      // malformed or truncated data
  kUnsupported = 3,  // a variant the port does not read (yet) though Pillow does
  kNoMemory = 5,     // an allocation failed
  kTooLarge = 6,     // more than kMaxPixels pixels
  kRefused = 7,      // a layout Pillow 12.1 refuses too
};

// Pillow refuses an image of more than twice Image.MAX_IMAGE_PIXELS as a
// decompression bomb, so the JAX package reads none: neither do the port's
// decoders, which keeps a corrupt header from sizing their buffers.
constexpr int64_t kMaxPixels = 2 * int64_t(89478485);

inline bool too_large(int64_t w, int64_t h) { return w * h > kMaxPixels; }

// A zlib stream (RFC 1950) inflated into exactly `cap` bytes at `out`; the
// count written goes to *produced.  Returns kOk, or kCorrupt for a stream
// that is malformed, truncated or longer than `cap` (png_decoder.cpp);
// with `prefix`, a stream longer than `cap` stops there (libtiff's
// ZIPDecode: zlib never reads past a full output buffer).
int zlib_inflate(const uint8_t* in, size_t n, uint8_t* out, size_t cap, size_t* produced,
                 bool prefix = false);

// WebP's two codecs, which webp_decoder.cpp's container calls on a chunk's
// payload (its padded size, as libwebp's decoder is handed it).
//
// VP8L (vp8l_decoder.cpp): the image's width, height and alpha bit from its
// 5-byte header (libwebp's VP8LGetInfo); the image as RGBA rows of `stride`
// bytes at `out` (w x h of vp8l_info); the green channel of a headerless
// ALPH stream of w x h pixels at `out`, before the ALPH filter.
int vp8l_info(const uint8_t* data, size_t n, int* w, int* h, int* has_alpha);
int vp8l_decode_rgba(const uint8_t* data, size_t n, uint8_t* out, size_t stride);
int vp8l_decode_alpha(const uint8_t* data, size_t n, int w, int h, uint8_t* out);
// VP8 (vp8_decoder.cpp): a key frame's width and height (libwebp's
// VP8GetInfo, `chunk_size` the chunk's unpadded size); the frame as RGBA
// rows of `stride` bytes at `out`, alpha 255, through libwebp's fancy
// upsampler.
int vp8_info(const uint8_t* data, size_t n, size_t chunk_size, int* w, int* h);
int vp8_decode_rgba(const uint8_t* data, size_t n, uint8_t* out, size_t stride);

// A JPEG stream as libtiff's JPEG codec has libjpeg decode a strip or tile
// (jpeg_decoder.cpp): `ycbcr`, three components converted from YCbCr to RGB,
// else the samples as stored; the first component sampled (hs, vs), the
// others 1 (else kRefused); RGB rows (gray replicated) into `rgb`, w x h.
int jpeg_decode_tiff(const uint8_t* data, size_t n, bool ycbcr, int hs, int vs,
                     std::vector<uint8_t>& rgb, int* w, int* h);

// A JPEG stream's samples as libjpeg's raw_data_out gives them and libtiff's
// old-style JPEG codec packs them (jpeg_decoder.cpp): YCbCr's subsampling
// blocks, (*hs, *vs) the luma's sampling (the chroma's 1), each block hs x vs
// Y samples then Cb and Cr, rows of ceil(w / hs) blocks, ceil(h / vs) rows.
int jpeg_decode_ycbcr_blocks(const uint8_t* data, size_t n, int* hs, int* vs,
                             std::vector<uint8_t>& blocks, int* w, int* h);

// A CCITT strip or tile as libtiff's tif_fax3.c decodes it (ccitt_decoder.cpp):
// compression 2, 3 (`two_d`: T4Options bit 0), 4 or 32771 over `n` bytes at
// file offset `offset`, FillOrder 2 when `lsb_first`; `rows` rows of
// `width` pixels, 1 bit a pixel (1 for a black run), rows byte-padded;
// *noeol: T.4 decoded without EOLs (set by a failed EOL search, kept by the
// caller from strip to strip).
int ccitt_decode(const uint8_t* data, size_t n, uint64_t offset, int compression, bool two_d,
                 bool lsb_first, int64_t width, int64_t rows, uint8_t* out, bool* noeol);

// Pillow's Convert.c cmyk2rgb (mode CMYK, not inverted, to RGB).
inline void cmyk_to_rgb(int c, int m, int y, int k, uint8_t* o) {
  const int nk = 255 - k;
  const int ch[3] = {c, m, y};
  for (int j = 0; j < 3; ++j) {
    const int t = ch[j] * nk + 128;  // MULDIV255
    const int v = nk - (((t >> 8) + t) >> 8);
    o[j] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
  }
}

// Python's round(v / maxval * out_max) for the integers Pillow rescales:
// the same double operations, ties to even as round() breaks them.
inline int64_t py_round_scale(int64_t v, int64_t maxval, int64_t out_max) {
  const double q = static_cast<double>(v) / static_cast<double>(maxval) *
                   static_cast<double>(out_max);
  return static_cast<int64_t>(std::nearbyint(q));
}

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

}  // namespace fsvlm
