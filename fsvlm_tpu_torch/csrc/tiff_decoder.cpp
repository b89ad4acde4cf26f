// The port's TIFF decoder: the first IFD of a classic TIFF or a BigTIFF
// (both byte orders), with no library, its output byte-equal to Pillow
// 12.1's Image.open(path).convert("RGB") (TiffImagePlugin over its libtiff
// 4.7, its libjpeg-turbo 3.1 and its LittleCMS 2.17).
//
// Pillow reads a TIFF in one of two ways, and this decoder follows both:
//
//  - Uncompressed: Pillow's own raw decoder, strip by strip or tile by
//    tile from each offset (the byte counts unread), rows of the raw
//    mode's width, FillOrder 2 as bit-reversed bytes, the Predictor tag
//    ignored; PlanarConfiguration 2 reads each plane with the one-letter
//    raw mode of its band (R, G, B, A, L, P, 1, C, M, Y, K), 8 bits a
//    sample whatever the file's depth, as Pillow does.  An uncompressed
//    YCbCr file is read as raw RGBX, four bytes a pixel and no conversion.
//  - Compressed: libtiff's strips and tiles, each decoded to its full
//    size (FillOrder 2 reverses the coded bytes): PackBits, LZW (new and
//    old style), Deflate 8 and 32946 (png_decoder.cpp's inflate, stopping
//    where the output fills, as libtiff's ZIPDecode), JPEG 7 (through
//    jpeg_decoder.cpp: JPEGTables before each abbreviated stream, YCbCr
//    converted by the JPEG decoder, RGB and gray samples as stored, the
//    sampling checks of libtiff's JPEGPreDecode), old-style JPEG 6 (one
//    strip whose JPEGInterchangeFormat is a whole stream: its raw samples
//    as YCbCr blocks) and CCITT 2, 3, 4 and 32771 (ccitt_decoder.cpp);
//    samples in native order (16- and 32-bit swapped from MM), horizontal
//    differencing (Predictor 2, 8, 16 and 32 bits) and the floating-point
//    predictor (3, float samples) for LZW and Deflate; then Pillow's
//    unpacker row by row, and for PlanarConfiguration 2 one plane per
//    band, 8 or 16 bits (the high byte), with no un-premultiplying.
//    Compressed YCbCr (JPEG only in separate planes) goes through libtiff's
//    RGBA interface as Pillow sends it: subsampling blocks, or separate
//    planes at 1:1, converted by TIFFYCbCrToRGB's fixed-point tables
//    (YCbCrCoefficients and ReferenceBlackWhite), a strip or tile that
//    fails to decode put as far as it decoded.
//
// The pixel layout follows Pillow's OPEN_INFO table: min-is-white and
// min-is-black at 1, 2, 4 and 8 bits (min-is-white inverted, 2 and 4 bits
// scaled by 85 and 17), 16-bit gray (mode I;16, not inverted even when
// min-is-white; clipped to 255 by convert; FillOrder 2 for II min-is-black),
// 12-bit II gray (I;12 into I;16), signed 8-bit gray read as unsigned,
// signed 16- and 32-bit and unsigned 32-bit gray (mode I, clipped), float
// gray (mode F: truncated and clipped, NaN 0), RGB 8 and 16 (the high
// byte), RGB with extra samples (unassociated RGBA, padding X, associated
// RGBa un-premultiplied at unpacking), gray with alpha, palette at 1-8
// bits with its 16-bit colormap taken as v // 256, palette with alpha,
// CMYK 8 and 16 through Pillow's CMYK->RGB, YCbCr and CIELab (LAB, to RGB
// through LittleCMS's transform, reproduced here).  For the libtiff path,
// Pillow's rawmodes I;16BS, I;32BS and F;32BF of an MM file read libtiff's
// native samples big-endian, and so does this decoder.  Pillow 12.1 applies
// the Orientation tag (ImageOps.exif_transpose), and so does this decoder.
//
// LZMA, ZSTD, WebP, Thunderscan and SGILog compression, and old-style JPEG
// past one strip, return kUnsupported (ROADMAP A16); a layout past Pillow's
// table, or one Pillow's readers refuse, kRefused; truncated or malformed
// data kCorrupt; an image of more pixels than twice Pillow's
// MAX_IMAGE_PIXELS kTooLarge.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

// kI: one band of Pillow's mode I or F (signed, float, 32-bit samples),
// stored as its convert("RGB") gray; kYCbCr: YCbCr read through libtiff's
// RGBA interface (TIFFRGBAImage), the path Pillow takes for a compressed one.
enum Mode { k1, kL, kP, kLA, kPA, kI16, kRGB, kRGBA, kCMYK, kI, kYCbCr, kLab };

struct Ifd {
  bool le = true;
  int64_t width = -1, height = -1;
  std::vector<uint64_t> bps{1}, extra, sample_format{1}, colormap, subsampling{2, 2};
  uint64_t compression = 1, photometric = 0, fillorder = 1, spp = 1, planar = 1,
           predictor = 1, orientation = 1, t4options = 0, jpeg_if = 0, jpeg_if_len = 0;
  bool has_spp = false, has_photometric = false, has_jpeg_if = false;
  int64_t rows_per_strip = -1, tile_w = -1, tile_h = -1;
  bool tiled = false;
  std::vector<uint64_t> offsets, counts;
  std::vector<double> luma, ref_bw;  // YCbCrCoefficients, ReferenceBlackWhite (RATIONAL)
  uint64_t tables_at = 0, tables_len = 0;  // JPEGTables (UNDEFINED)
};

struct Reader {
  const uint8_t* d;
  bool le;
  uint64_t u16(size_t p) const {
    return le ? d[p] | (d[p + 1] << 8) : (d[p] << 8) | d[p + 1];
  }
  uint64_t u32(size_t p) const {
    return le ? d[p] | (d[p + 1] << 8) | (d[p + 2] << 16) | (uint64_t(d[p + 3]) << 24)
              : (uint64_t(d[p]) << 24) | (d[p + 1] << 16) | (d[p + 2] << 8) | d[p + 3];
  }
  uint64_t u64(size_t p) const {
    return le ? u32(p) | (u32(p + 4) << 32) : (u32(p) << 32) | u32(p + 4);
  }
};

// Pillow's header: II or MM, then BigTIFF where the third byte is 43 (so
// "II+\0"; Pillow reads "MM\0+" as a classic header, whose first IFD offset
// then points past most files), else a classic TIFF (42 in either byte).
bool is_tiff(const uint8_t* d, size_t len) {
  if (len < 8) return false;
  const bool ii = d[0] == 'I' && d[1] == 'I', mm = d[0] == 'M' && d[1] == 'M';
  if (!ii && !mm) return false;
  return (d[2] == 42 && d[3] == 0) || (d[2] == 0 && d[3] == 42) || (ii && d[2] == 43 && d[3] == 0) ||
         (mm && d[2] == 0 && d[3] == 43);
}

int parse_ifd(const uint8_t* d, size_t len, Ifd* f) {
  if (len < 8) return kCorrupt;
  f->le = d[0] == 'I';
  Reader r{d, f->le};
  const bool big = d[2] == 43;  // BigTIFF: 8-byte offsets and counts, 20-byte entries
  if (big && len < 16) return kCorrupt;
  const uint64_t at = big ? r.u64(8) : r.u32(4);
  const size_t head = big ? 8 : 2, entry = big ? 20 : 12, cell = big ? 8 : 4;
  if (at > len || len - at < head) return kCorrupt;
  const uint64_t n = big ? r.u64(at) : r.u16(at);
  if (n > (len - at - head) / entry) return kCorrupt;
  for (uint64_t i = 0; i < n; ++i) {
    const size_t e = at + head + entry * i;
    const uint64_t tag = r.u16(e), type = r.u16(e + 2);
    const uint64_t count = big ? r.u64(e + 4) : r.u32(e + 4);
    const size_t value = e + (big ? 12 : 8);
    int size;
    switch (type) {
      case 1: case 2: case 6: case 7: size = 1; break;
      case 3: case 8: size = 2; break;
      case 4: case 9: case 11: case 13: size = 4; break;
      case 5: case 10: case 12: case 16: case 17: case 18: size = 8; break;
      default: continue;  // an unknown type: Pillow skips the tag
    }
    if (count > (uint64_t(1) << 28)) return kCorrupt;
    const uint64_t bytes = count * size;
    const uint64_t p = bytes <= cell ? value : (big ? r.u64(value) : r.u32(value));
    if (p > len || bytes > len - p) return kCorrupt;
    if (tag == 347 && type == 7) {  // JPEGTables: the bytes themselves
      f->tables_at = p;
      f->tables_len = bytes;
      continue;
    }
    if (type == 5) {  // RATIONAL, as libtiff reads it: (double)num / den, 0 for a 0 den
      std::vector<double> q(count);
      for (uint64_t k = 0; k < count; ++k) {
        const uint64_t num = r.u32(p + 8 * k), den = r.u32(p + 8 * k + 4);
        q[k] = den == 0 ? 0.0 : static_cast<double>(num) / static_cast<double>(den);
      }
      if (tag == 529) f->luma = q;
      if (tag == 532) f->ref_bw = q;
      continue;
    }
    if (type != 1 && type != 3 && type != 4 && type != 7 && type != 16 && type != 18)
      continue;  // no integer tag we read
    std::vector<uint64_t> v(count);
    for (uint64_t k = 0; k < count; ++k)
      v[k] = size == 1 ? d[p + k] : size == 2 ? r.u16(p + 2 * k)
           : size == 4 ? r.u32(p + 4 * k) : r.u64(p + 8 * k);
    auto one = [&](uint64_t* dst) {
      if (!v.empty()) *dst = v[0];
    };
    switch (tag) {
      case 256: if (!v.empty()) f->width = static_cast<int64_t>(v[0]); break;
      case 257: if (!v.empty()) f->height = static_cast<int64_t>(v[0]); break;
      case 258: f->bps = v; break;
      case 259: one(&f->compression); break;
      case 262: one(&f->photometric); f->has_photometric = !v.empty(); break;
      case 266: one(&f->fillorder); break;
      case 273: f->offsets = v; break;
      case 274: one(&f->orientation); break;
      case 277: one(&f->spp); f->has_spp = !v.empty(); break;
      case 278: if (!v.empty()) f->rows_per_strip = static_cast<int64_t>(v[0]); break;
      case 279: f->counts = v; break;
      case 284: one(&f->planar); break;
      case 317: one(&f->predictor); break;
      case 320: f->colormap = v; break;
      case 322: if (!v.empty()) f->tile_w = static_cast<int64_t>(v[0]); break;
      case 323: if (!v.empty()) f->tile_h = static_cast<int64_t>(v[0]); break;
      case 324: f->offsets = v; f->tiled = true; break;
      case 325: f->counts = v; break;
      case 292: one(&f->t4options); break;
      case 338: f->extra = v; break;
      case 339: f->sample_format = v; break;
      case 513: one(&f->jpeg_if); f->has_jpeg_if = !v.empty(); break;
      case 514: one(&f->jpeg_if_len); break;
      case 530: f->subsampling = v; break;
      default: break;
    }
  }
  if (f->width < 0 || f->height < 0) return kCorrupt;
  return kOk;
}

// One layout of Pillow's OPEN_INFO table, as this decoder unpacks it.
struct Layout {
  Mode mode = kL;
  int bits = 8;       // per sample
  int samples = 1;    // per pixel in the row
  bool invert = false;
  bool premul = false;  // RGBa: un-premultiplied when unpacked
  int fmt = 1;          // kI: 1 unsigned read as signed (I;32N), 2 signed, 3 float
  // libtiff's path: the rawmode Pillow keeps reads big-endian from libtiff's
  // native (little-endian) samples (I;16BS, I;32BS, F;32BF of an MM file)
  bool swapped = false;
  int stride_bits = 0;  // the raw decoder's stride bits a pixel, when not bits * samples
};

bool same(const std::vector<uint64_t>& a, std::initializer_list<uint64_t> b) {
  return a.size() == b.size() && std::equal(a.begin(), a.end(), b.begin());
}

// Pillow's _setup up to the table lookup.  `fill` is the FillOrder of the
// key (libtiff's path looks it up again as 1); `sf` the SampleFormat key.
int lookup(const Ifd& f, const std::vector<uint64_t>& sf, uint64_t photo, uint64_t fill,
           Layout* lay) {
  std::vector<uint64_t> bps = f.bps;
  const uint64_t spp = f.has_spp ? f.spp : 1;
  if (spp > 6) return kRefused;
  if (spp < bps.size()) bps.resize(spp);
  else if (spp > bps.size() && bps.size() == 1) bps.assign(spp, bps[0]);
  if (bps.size() != spp) return kRefused;
  const std::vector<uint64_t>& ex = f.extra;
  const bool mm = !f.le;
  const uint64_t b = bps[0];
  for (uint64_t x : bps)
    if (x != b) return kRefused;
  lay->bits = static_cast<int>(b);
  lay->samples = static_cast<int>(spp);
  const bool sf1 = same(sf, {1});
  if ((photo == 0 || photo == 1) && spp == 1 && ex.empty() && !sf1) {
    // signed (2) and float (3) samples: mode L (signed bytes read as
    // unsigned), I (I;16S, I;16BS, I;32S, I;32BS) or F (F;32F, F;32BF)
    if (fill != 1) return kRefused;
    if (same(sf, {2}) && photo == 1 && (b == 8 || b == 16 || b == 32)) {
      lay->mode = b == 8 ? kL : kI;
      lay->fmt = 2;
      lay->swapped = mm && b != 8;
      return kOk;
    }
    if (same(sf, {3}) && b == 32) {  // min-is-white not inverted
      lay->mode = kI;
      lay->fmt = 3;
      lay->swapped = mm;
      return kOk;
    }
    return kRefused;
  }
  if (!sf1) return kRefused;
  if (photo == 0 || photo == 1) {
    if (spp == 1 && ex.empty()) {
      if (b == 1 || b == 2 || b == 4 || b == 8) {
        lay->mode = b == 1 ? k1 : kL;
        lay->invert = photo == 0;
        return kOk;
      }
      if (b == 16) {
        // II min-is-white and -black, MM min-is-black; FillOrder 2 only II
        // min-is-black ("I;16R": bit-reversed bytes, as every FillOrder 2 row)
        if (fill == 2 && !(!mm && photo == 1)) return kRefused;
        if (mm && photo == 0) return kRefused;
        lay->mode = kI16;
        return kOk;
      }
      // II min-is-black at 12 bits ("I;12", mode I;16) and 32 ("I;32N", mode I)
      if ((b == 12 || b == 32) && photo == 1 && !mm && fill == 1) {
        lay->mode = b == 12 ? kI16 : kI;
        return kOk;
      }
      return kRefused;
    }
    if (photo == 1 && fill == 1 && b == 8 && spp == 2 && same(ex, {2})) {
      lay->mode = kLA;
      return kOk;
    }
    return kRefused;
  }
  if (photo == 2) {
    if (fill == 2) {
      if (b == 8 && spp == 3 && ex.empty()) {
        lay->mode = kRGB;
        return kOk;
      }
      return kRefused;
    }
    if (b == 8) {
      if (spp == 3 && ex.empty()) lay->mode = kRGB;
      else if (spp == 4 && ex.empty()) lay->mode = kRGBA;
      else if (spp >= 4 && ex.size() == spp - 3 &&
               std::all_of(ex.begin() + 1, ex.end(), [](uint64_t v) { return v == 0; }) &&
               (ex[0] <= 2 || (ex[0] == 999 && spp == 4)))
        lay->mode = ex[0] == 0 ? kRGB : kRGBA, lay->premul = ex[0] == 1;
      else
        return kRefused;
      return kOk;
    }
    if (b == 16) {
      if (spp == 3 && ex.empty()) lay->mode = kRGB;
      else if (spp == 4 && (ex.empty() || same(ex, {2}))) lay->mode = kRGBA;
      else if (spp == 4 && same(ex, {0})) lay->mode = kRGB;
      else if (spp == 4 && same(ex, {1})) lay->mode = kRGBA, lay->premul = true;
      else return kRefused;
      return kOk;
    }
    return kRefused;
  }
  if (photo == 3) {
    if (spp == 1 && ex.empty() && (b == 1 || b == 2 || b == 4 || b == 8)) {
      lay->mode = kP;
      return kOk;
    }
    if (fill == 1 && b == 8 && spp == 2 && (same(ex, {0}) || same(ex, {2}))) {
      lay->mode = ex[0] == 2 ? kPA : kP;
      return kOk;
    }
    return kRefused;
  }
  if (photo == 5) {
    if (fill == 1 && b == 8 && spp >= 4 && ex.size() == spp - 4 &&
        std::all_of(ex.begin(), ex.end(), [](uint64_t v) { return v == 0; })) {
      lay->mode = kCMYK;
      return kOk;
    }
    if (fill == 1 && b == 16 && spp == 4 && ex.empty()) {
      lay->mode = kCMYK;
      return kOk;
    }
    return kRefused;
  }
  if (photo == 6) {  // YCbCr: ("RGB", "RGBX"), or one band ("L", "L")
    if (fill != 1 || b != 8 || !ex.empty() || (spp != 3 && spp != 1)) return kRefused;
    if (spp == 1) {
      lay->mode = kL;
      return kOk;
    }
    // the raw decoder reads RGBX, four bytes a pixel, strides of three
    lay->mode = kRGB;
    lay->samples = 4;
    lay->stride_bits = 24;
    return kOk;
  }
  if (photo == 8) {  // CIELab: ("LAB", "LAB")
    if (fill != 1 || b != 8 || spp != 3 || !ex.empty()) return kRefused;
    lay->mode = kLab;
    return kOk;
  }
  return kRefused;
}

inline uint8_t reverse_bits(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// The image as Pillow holds it before convert: 4 channels a pixel (gray,
// index or R in 0; G or M in 1; B or Y in 2; alpha or K in 3).
struct Image {
  int64_t w = 0, h = 0;
  std::vector<uint16_t> px;
  uint16_t* at(int64_t x, int64_t y) { return px.data() + (y * w + x) * 4; }
};

// Sample k (of `bits`) of a row, with the sample order `le` at 16 and 32
// bits; 12 bits as Pillow's I;12 reads them (two samples in three bytes,
// high nibble first).
inline uint32_t sample(const uint8_t* row, int64_t k, int bits, bool le) {
  switch (bits) {
    case 1: return (row[k >> 3] >> (7 - (k & 7))) & 1;
    case 2: return (row[k >> 2] >> (6 - 2 * (k & 3))) & 3;
    case 4: return (row[k >> 1] >> (k & 1 ? 0 : 4)) & 15;
    case 8: return row[k];
    case 12: {
      const uint8_t* p = row + 3 * (k >> 1);
      return k & 1 ? ((p[1] & 15u) << 8) | p[2] : (uint32_t(p[0]) << 4) | (p[1] >> 4);
    }
    case 32: {
      const uint8_t* p = row + 4 * k;
      return le ? p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24)
                : (uint32_t(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
    }
    default: {
      const uint8_t* p = row + 2 * k;
      return le ? p[0] | (p[1] << 8) : (p[0] << 8) | p[1];
    }
  }
}

// A mode I or F sample's convert("RGB") gray: I clipped to 0..255; F
// truncated toward zero and clipped, NaN to 0 (Convert.c i2l, f2l).
inline uint16_t gray_of(uint32_t raw, int bits, int fmt) {
  if (fmt == 3) {
    float v;
    std::memcpy(&v, &raw, 4);
    if (!(v > 0.f)) return 0;
    return v >= 255.f ? 255 : static_cast<uint16_t>(static_cast<int>(v));
  }
  const int64_t v = bits == 16 ? static_cast<int16_t>(raw) : static_cast<int32_t>(raw);
  return static_cast<uint16_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// Pillow's unpacker of the layout: `n` pixels of a row into the image at (x, y).
void unpack(const Layout& l, const uint8_t* row, int64_t n, bool le, Image& im, int64_t x,
            int64_t y) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t* o = im.at(x + i, y);
    const int64_t k0 = i * l.samples;
    auto s8 = [&](int j) {  // an 8-bit sample, or a 16-bit one's high byte
      const uint32_t v = sample(row, k0 + j, l.bits, le);
      return l.bits == 16 ? v >> 8 : v;
    };
    switch (l.mode) {
      case k1: {
        const uint32_t v = sample(row, k0, 1, le);
        o[0] = (v ^ (l.invert ? 1u : 0u)) ? 255 : 0;
        break;
      }
      case kL: {
        uint32_t v = sample(row, k0, l.bits, le);
        v = l.bits == 2 ? v * 0x55 : l.bits == 4 ? v * 0x11 : v;
        o[0] = static_cast<uint16_t>(l.invert ? 255 - v : v);
        break;
      }
      case kP:
        o[0] = static_cast<uint16_t>(sample(row, k0, l.bits, le));
        break;
      case kLA:
      case kPA:
        o[0] = static_cast<uint16_t>(s8(0));
        o[3] = static_cast<uint16_t>(s8(1));
        break;
      case kI16:
        o[0] = static_cast<uint16_t>(sample(row, k0, l.bits, le));
        break;
      case kI:
        o[0] = gray_of(sample(row, k0, l.bits, le), l.bits, l.fmt);
        break;
      case kYCbCr:
        break;
      case kRGB:
        for (int c = 0; c < 3; ++c) o[c] = static_cast<uint16_t>(s8(c));
        break;
      case kLab:  // Unpack.c unpackLAB: a and b signed in the file
        o[0] = static_cast<uint16_t>(s8(0));
        o[1] = static_cast<uint16_t>(s8(1) ^ 128);
        o[2] = static_cast<uint16_t>(s8(2) ^ 128);
        break;
      case kRGBA:
      case kCMYK: {
        for (int c = 0; c < 4; ++c) o[c] = static_cast<uint16_t>(s8(c));
        if (l.premul) {  // Unpack.c unpackRGBa: 0 alpha is black, 255 unchanged
          const int a = o[3];
          for (int c = 0; c < 3; ++c)
            o[c] = static_cast<uint16_t>(a == 0 ? 0 : a == 255 ? o[c] : std::min(255, o[c] * 255 / a));
        }
        break;
      }
    }
  }
}

// ------------------------------------------------------------- libtiff codecs
// PackBitsDecode into exactly `occ` bytes.
int packbits(const uint8_t* bp, size_t cc, uint8_t* op, size_t occ) {
  while (cc > 0 && occ > 0) {
    int n = *bp++;
    --cc;
    if (n >= 128) n -= 256;
    if (n < 0) {
      if (n == -128) continue;
      size_t k = static_cast<size_t>(-n + 1);
      if (occ < k) k = occ;
      if (cc == 0) break;
      const uint8_t b = *bp++;
      --cc;
      std::memset(op, b, k);
      op += k;
      occ -= k;
    } else {
      size_t k = static_cast<size_t>(n) + 1;
      if (occ < k) k = occ;
      if (cc < k) break;
      std::memcpy(op, bp, k);
      op += k;
      occ -= k;
      bp += k;
      cc -= k;
    }
  }
  return occ > 0 ? kCorrupt : kOk;
}

// LZWDecode / LZWDecodeCompat into exactly `occ` bytes.
int lzw(const uint8_t* bp, size_t cc, uint8_t* op, size_t occ) {
  const bool compat = cc >= 2 && bp[0] == 0 && (bp[1] & 1);
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4096 + 1024;
  struct Code { int next; uint16_t length; uint8_t value, first; };
  std::vector<Code> tab(kSize);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  for (int i = 256; i < kSize; ++i) tab[i] = {-1, 0, 0, 0};
  int nbits = 9, free_ent = kFirst, old = -1;
  int maxcode = compat ? 511 : 510;
  uint64_t acc = 0;
  int have = 0;
  size_t pos = 0;
  auto next_code = [&]() -> int {
    while (have < nbits) {
      if (pos >= cc) return kEoi;  // not terminated with EOI: libtiff stops there
      if (compat) acc |= uint64_t(bp[pos++]) << have;
      else acc = (acc << 8) | bp[pos++];
      have += 8;
    }
    int c;
    if (compat) {
      c = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      c = static_cast<int>((acc >> (have - nbits)) & ((1u << nbits) - 1));
    }
    have -= nbits;
    if (!compat) acc &= (uint64_t(1) << have) - 1;
    return c;
  };
  size_t o = 0;
  while (o < occ) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kSize; ++i) tab[i] = {-1, 0, 0, 0};
        nbits = 9;
        maxcode = compat ? 511 : 510;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return kCorrupt;
      op[o++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= kSize) return kCorrupt;
    Code& ne = tab[free_ent];
    ne.next = old;
    ne.first = tab[old].first;
    ne.length = static_cast<uint16_t>(tab[old].length + 1);
    ne.value = code < free_ent ? tab[code].first : ne.first;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = compat ? (1 << nbits) - 1 : (1 << nbits) - 2;
    }
    old = code;
    const Code& c = tab[code];
    if (c.length == 0) return kCorrupt;
    if (code < 256) {
      op[o++] = static_cast<uint8_t>(code);
      continue;
    }
    // the string, written from its end; a string longer than the room
    // left keeps only what fits, as libtiff restarts it at the next call
    const size_t len = c.length;
    const size_t keep = std::min(len, occ - o);
    int k = code;
    for (size_t t = len; t-- > 0;) {
      if (t < keep) op[o + t] = tab[k].value;
      k = tab[k].next;
      if (k < 0 && t > 0) return kCorrupt;
    }
    o += keep;
  }
  return o < occ ? kCorrupt : kOk;
}

// ------------------------------------------------------------------ decode
struct Plan {
  Ifd f;
  Layout lay;
  bool libtiff = false;
  int64_t w = 0, h = 0;  // stored size (before orientation)
};

int plan(const uint8_t* d, size_t len, Plan* p) {
  if (!is_tiff(d, len)) return kCorrupt;
  Ifd& f = p->f;
  int rc = parse_ifd(d, len, &f);
  if (rc != kOk) return rc;
  p->w = f.width;
  p->h = f.height;
  if (too_large(f.width, f.height)) return kTooLarge;
  switch (f.compression) {
    case 1: case 2: case 3: case 4: case 5: case 7: case 8: case 32771: case 32773: case 32946:
      break;
    case 6: break;
    case 32809: case 34676: case 34677: case 34925: case 50000: case 50001:
      return kUnsupported;  // ROADMAP A16: Thunderscan, SGILog, LZMA, ZSTD, WebP
    default: return kRefused;  // not in Pillow's COMPRESSION_INFO
  }
  p->libtiff = f.compression != 1;
  // old-style JPEG: Pillow takes it for YCbCr, three samples unless told
  const uint64_t photo = f.compression == 6 ? 6 : f.photometric;
  if (f.compression == 6 && !f.has_spp) {
    f.spp = 3;
    f.has_spp = true;
  }
  // Pillow's SampleFormat key: one value when all are 1 (unsigned)
  std::vector<uint64_t> sf = f.sample_format;
  if (sf.size() > 1 && std::all_of(sf.begin(), sf.end(), [](uint64_t v) { return v == 1; }))
    sf.assign(1, 1);
  if (f.fillorder != 1 && f.fillorder != 2) return kRefused;
  // the key with the file's FillOrder must be in the table; libtiff's path
  // then looks it up again as FillOrder 1 (libtiff reverses the bits itself)
  rc = lookup(f, sf, photo, f.fillorder, &p->lay);
  if (rc == kOk && p->libtiff && f.fillorder == 2) rc = lookup(f, sf, photo, 1, &p->lay);
  if (rc != kOk) return rc;
  if (p->libtiff && photo == 6 && p->lay.samples == 4) {
    // compressed YCbCr: JPEG's own colour conversion at PlanarConfiguration
    // 1 ("RGB"), else libtiff's RGBA interface (8-bit contig only)
    if (f.compression == 7 && f.planar == 1) {
      p->lay.samples = 3;
      p->lay.stride_bits = 0;
    } else {
      p->lay.mode = kYCbCr;
      p->lay.samples = 3;
      if (f.planar != 1 && f.planar != 2) return kRefused;
      const auto& ss = f.subsampling;
      if (ss.size() < 2) return kRefused;
      const uint64_t code = ss[0] << 4 | ss[1];
      // libtiff's put functions: putcontig8bitYCbCr{44,42,41,22,21,12,11}tile,
      // and for separate planes putseparate8bitYCbCr11tile alone
      if (f.planar == 2 ? code != 0x11
                        : (code != 0x11 && code != 0x12 && code != 0x21 && code != 0x22 &&
                           code != 0x41 && code != 0x42 && code != 0x44))
        return kRefused;
    }
  }
  if (p->libtiff && photo == 6 && p->lay.samples == 1) return kRefused;  // RGBA: 3 channels
  if (f.compression == 7 &&
      (p->lay.bits != 8 || (p->lay.mode != kRGB && p->lay.mode != kL && p->lay.mode != kYCbCr) ||
       (p->lay.mode == kRGB && p->lay.samples != 3)))
    return kRefused;  // libjpeg's 8-bit samples, one or three components (YCbCr: planes)
  if (f.planar != 1 && f.planar != 2) return kRefused;
  if (f.offsets.empty()) return kRefused;
  if (f.tiled && (f.tile_w <= 0 || f.tile_h <= 0)) return kRefused;
  if (f.width == 0 || f.height == 0) return kRefused;
  if (p->lay.mode == kP || p->lay.mode == kPA) {
    if (f.colormap.empty()) return kRefused;
  }
  return kOk;
}

int channel_of(char c) {
  switch (c) {
    case 'R': case 'L': case 'P': case '1': case 'C': return 0;
    case 'G': case 'M': return 1;
    case 'B': case 'Y': return 2;
    case 'A': case 'K': return 3;
    default: return -1;
  }
}

// Pillow's raw decoder over every strip or tile of an uncompressed TIFF.
int decode_raw(const uint8_t* d, size_t len, const Plan& p, Image& im) {
  const Ifd& f = p.f;
  const Layout& lay = p.lay;
  const int64_t xs = p.w, ys = p.h;
  int64_t w, h;
  if (f.tiled) {
    w = f.tile_w;
    h = f.tile_h;
  } else {
    w = xs;
    h = f.rows_per_strip > 0 ? f.rows_per_strip : ys;
  }
  std::vector<uint64_t> offsets = f.offsets;
  if (w == xs && h == ys && f.planar != 2) offsets.assign(1, offsets.back());
  // the raw mode's letters (for PlanarConfiguration 2) and bits a pixel
  std::string letters;
  switch (lay.mode) {
    case k1: letters = "1"; break;
    case kL: letters = "L"; break;
    case kP: letters = lay.samples == 2 ? "PX" : "P"; break;
    case kLA: letters = "LA"; break;
    case kPA: letters = "PA"; break;
    case kI16: case kI: case kYCbCr: letters = "I"; break;
    case kLab: letters = "LAB"; break;
    case kRGB: letters = std::string("RGB") + std::string(lay.samples - 3, 'X'); break;
    case kRGBA: letters = std::string(lay.premul ? "RGBa" : "RGBA") +
                          std::string(lay.samples - 4, 'X'); break;
    case kCMYK: letters = std::string("CMYK") + std::string(lay.samples - 4, 'X'); break;
  }
  const int sum_bits = lay.bits * lay.samples;
  const int bands_count = (f.photometric == 2 ? 3 : f.photometric == 5 ? 4 : 1) +
                          static_cast<int>(f.extra.size());
  const bool reverse = f.fillorder == 2;
  int64_t x = 0, y = 0;
  size_t layer = 0;
  std::vector<uint8_t> rowbuf;
  for (uint64_t off : offsets) {
    const int64_t x1 = std::min(x + w, xs), y1 = std::min(y + h, ys);
    const int64_t tw = x1 - x;
    int64_t stride = 0;
    if (x + w > xs) stride = w * (lay.stride_bits ? lay.stride_bits : sum_bits) / 8;
    Layout l = lay;
    int ch = -1;
    if (f.planar == 2) {
      // Pillow has one-letter unpackers for 1, L, P, RGB, RGBA and CMYK only
      if (lay.mode == kLA || lay.mode == kPA || lay.mode == kI16 || lay.mode == kI ||
          lay.stride_bits)
        return kRefused;
      if (layer >= letters.size()) return kRefused;
      // LAB's one-band unpackers L, A and B fill bands 0-2 as stored (a and b
      // not made unsigned)
      ch = lay.mode == kLab ? static_cast<int>(layer) : channel_of(letters[layer]);
      if (ch < 0) return kRefused;  // no one-band unpacker for X, a or I
      stride = stride / bands_count;
      l.bits = letters[layer] == '1' ? 1 : 8;
      l.samples = 1;
    }
    const int64_t bits_px = f.planar == 2 ? l.bits : sum_bits;
    const int64_t row_bytes = (tw * bits_px + 7) / 8;
    const int64_t skip = stride ? stride - row_bytes : 0;
    if (skip < 0) return kRefused;
    size_t pos = static_cast<size_t>(off);
    for (int64_t r = y; r < y1; ++r) {
      if (pos > len || len - pos < static_cast<size_t>(row_bytes)) return kCorrupt;
      const uint8_t* row = d + pos;
      if (reverse) {
        rowbuf.assign(row, row + row_bytes);
        for (auto& b : rowbuf) b = reverse_bits(b);
        row = rowbuf.data();
      }
      if (f.planar == 2) {
        for (int64_t i = 0; i < tw; ++i) {
          const uint32_t v = sample(row, i, l.bits, f.le);
          im.at(x + i, r)[ch] = static_cast<uint16_t>(l.bits == 1 ? (v ? 255 : 0) : v);
        }
      } else {
        unpack(l, row, tw, f.le, im, x, r);
      }
      pos += static_cast<size_t>(row_bytes + skip);
    }
    x += w;
    if (x >= xs) {
      x = 0;
      y += h;
      if (y >= ys) {
        y = 0;
        ++layer;
      }
    }
  }
  return kOk;
}

// One strip's or tile's JPEG stream (compression 7) as libtiff's codec has
// libjpeg decode it: JPEGTables' abbreviated tables before the segment's
// abbreviated image, YCbCr converted to RGB at photometric 6 (Pillow sets
// JPEGCOLORMODE_RGB) and no colour conversion otherwise; the segment's
// w x h samples of `nc` components at `out`.  A stream larger than the
// segment is refused, as libtiff refuses it, but for a last strip of the
// full strip height.
int decode_jpeg_segment(const uint8_t* d, const Ifd& f, const uint8_t* src, size_t cnt, int64_t w,
                        int64_t h, bool last_strip, int nc, uint8_t* out) {
  std::vector<uint8_t> stream;
  if (f.tables_len >= 4) {
    const uint8_t* t = d + f.tables_at;
    size_t b = 0, e = f.tables_len;
    if (t[0] == 0xFF && t[1] == 0xD8) b = 2;
    if (t[e - 2] == 0xFF && t[e - 1] == 0xD9) e -= 2;
    if (cnt < 2) return kCorrupt;
    stream.assign(src, src + 2);
    stream.insert(stream.end(), t + b, t + std::max(b, e));
    stream.insert(stream.end(), src + 2, src + cnt);
  } else {
    stream.assign(src, src + cnt);
  }
  const bool ycc = f.photometric == 6;
  int hs = 1, vs = 1;
  if (ycc && f.subsampling.size() >= 2) {
    hs = static_cast<int>(f.subsampling[0]);
    vs = static_cast<int>(f.subsampling[1]);
  }
  std::vector<uint8_t> rgb;
  int jw = 0, jh = 0;
  const int rc = jpeg_decode_tiff(stream.data(), stream.size(), ycc, hs, vs, rgb, &jw, &jh);
  if (rc != kOk) return rc;
  if (jw > w || (jh > h && !(last_strip && jw == w))) return kRefused;
  if (jw < w || jh < h) return kCorrupt;
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x)
      for (int c = 0; c < nc; ++c)
        out[(y * w + x) * nc + c] = rgb[(static_cast<size_t>(y) * jw + x) * 3 + c];
  return kOk;
}

// libtiff's decode of one strip or tile into `out` (its full size; a JPEG
// segment of w x h pixels of nc samples; a CCITT one's rows w wide, with
// the fax codec's state `noeol` kept from segment to segment).
int decode_segment(const uint8_t* d, size_t len, const Ifd& f, size_t index, uint8_t* out,
                   size_t size, int64_t w = 0, int64_t h = 0, bool last_strip = false,
                   int nc = 0, bool* noeol = nullptr) {
  if (index >= f.offsets.size() || index >= f.counts.size()) return kCorrupt;
  const uint64_t off = f.offsets[index], cnt = f.counts[index];
  if (off > len || cnt > len - off) return kCorrupt;
  if (f.compression == 7) return decode_jpeg_segment(d, f, d + off, cnt, w, h, last_strip, nc, out);
  if (f.compression == 2 || f.compression == 3 || f.compression == 4 || f.compression == 32771) {
    // libtiff's fax codecs: rows of w pixels, 1 bit each; FillOrder read by the codec
    if (w <= 0 || size % static_cast<size_t>((w + 7) / 8)) return kCorrupt;
    bool own = false;
    return ccitt_decode(d + off, cnt, off, static_cast<int>(f.compression), f.t4options & 1,
                        f.fillorder == 2, w, static_cast<int64_t>(size) / ((w + 7) / 8), out,
                        noeol ? noeol : &own);
  }
  std::vector<uint8_t> rev;
  const uint8_t* src = d + off;
  if (f.fillorder == 2) {
    rev.assign(src, src + cnt);
    for (auto& b : rev) b = reverse_bits(b);
    src = rev.data();
  }
  switch (f.compression) {
    case 32773: return packbits(src, cnt, out, size);
    case 5: return lzw(src, cnt, out, size);
    default: {
      size_t produced = 0;
      const int rc = zlib_inflate(src, cnt, out, size, &produced, true);
      return rc == kOk && produced == size ? kOk : kCorrupt;
    }
  }
}

int decode_libtiff(const uint8_t* d, size_t len, const Plan& p, Image& im) {
  const Ifd& f = p.f;
  const Layout& lay = p.lay;
  const int64_t xs = p.w, ys = p.h;
  const bool separate = f.planar == 2;
  const int bands = (lay.mode == kRGB || lay.mode == kLab) ? 3
                  : (lay.mode == kRGBA || lay.mode == kCMYK) ? 4
                  : (lay.mode == kLA || lay.mode == kPA) ? 2 : 1;
  const bool by_plane = separate && bands > 1;
  if (by_plane && lay.bits != 8 && lay.bits != 16) return kRefused;
  const int planes = by_plane ? bands : 1;
  // Pillow's strip reader fails where planes are fewer than the samples
  if (by_plane && !f.tiled && planes < lay.samples) return kRefused;
  const int spp_row = separate ? 1 : lay.samples;  // samples a pixel in a decoded row
  // the predictor (libtiff's horizontal differencing, 8, 16 and 32 bits, and
  // its floating-point one for float samples) with LZW and Deflate
  const bool coded = f.compression == 5 || f.compression == 8 || f.compression == 32946;
  const bool predict = coded && f.predictor == 2;
  const bool fp_predict = coded && f.predictor == 3;
  if (fp_predict && !(lay.mode == kI && lay.fmt == 3)) return kRefused;
  if (predict && lay.bits != 8 && lay.bits != 16 && lay.bits != 32) return kRefused;
  // libtiff's samples in native (little-endian) order; the floating-point
  // predictor leaves them so itself
  const int swab = !f.le && !fp_predict && (lay.bits == 16 || lay.bits == 32) ? lay.bits / 8 : 0;
  auto finish = [&](uint8_t* buf, int64_t rows, int64_t row_bytes, int64_t row_px) {
    if (swab)
      for (int64_t i = 0; i + swab <= rows * row_bytes; i += swab) std::reverse(buf + i, buf + i + swab);
    if (fp_predict) {  // tif_predict.c fpAcc: bytes accumulated, then unshuffled
      std::vector<uint8_t> tmp(static_cast<size_t>(row_bytes));
      const int64_t bps = lay.bits / 8, wc = row_bytes / bps;
      for (int64_t r = 0; r < rows; ++r) {
        uint8_t* row = buf + r * row_bytes;
        for (int64_t k = spp_row; k < row_bytes; ++k)
          row[k] = static_cast<uint8_t>(row[k] + row[k - spp_row]);
        std::memcpy(tmp.data(), row, tmp.size());
        for (int64_t c = 0; c < wc; ++c)
          for (int64_t byte = 0; byte < bps; ++byte)
            row[bps * c + byte] = tmp[(bps - byte - 1) * wc + c];
      }
    }
    if (!predict) return;
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* row = buf + r * row_bytes;
      const int64_t n = row_px * spp_row;
      if (lay.bits == 8) {
        for (int64_t k = spp_row; k < n; ++k) row[k] = static_cast<uint8_t>(row[k] + row[k - spp_row]);
      } else if (lay.bits == 32) {
        for (int64_t k = spp_row; k < n; ++k) {
          uint32_t a, b;
          std::memcpy(&a, row + 4 * k, 4);
          std::memcpy(&b, row + 4 * (k - spp_row), 4);
          a += b;
          std::memcpy(row + 4 * k, &a, 4);
        }
      } else {
        for (int64_t k = spp_row; k < n; ++k) {
          const uint16_t v = static_cast<uint16_t>((row[2 * k] | (row[2 * k + 1] << 8)) +
                                                   (row[2 * (k - spp_row)] |
                                                    (row[2 * (k - spp_row) + 1] << 8)));
          row[2 * k] = static_cast<uint8_t>(v);
          row[2 * k + 1] = static_cast<uint8_t>(v >> 8);
        }
      }
    }
  };
  auto put_rows = [&](const uint8_t* buf, int plane, int64_t rows, int64_t row_bytes, int64_t x0,
                      int64_t y0, int64_t n) {
    for (int64_t r = 0; r < rows; ++r) {
      const uint8_t* row = buf + r * row_bytes;
      if (by_plane) {
        for (int64_t i = 0; i < n; ++i) {
          const uint32_t v = sample(row, i, lay.bits, true);
          im.at(x0 + i, y0 + r)[plane == 1 && bands == 2 ? 3 : plane] =
              static_cast<uint16_t>(lay.bits == 16 ? v >> 8 : v);
        }
      } else {
        unpack(lay, row, n, !lay.swapped, im, x0, y0 + r);
      }
    }
  };
  const int64_t bits_row_px = static_cast<int64_t>(lay.bits) * spp_row;
  std::vector<uint8_t> buf;
  bool noeol = false;  // the fax codec's FAXMODE_NOEOL, from strip to strip
  if (f.tiled) {
    const int64_t tw = f.tile_w, th = f.tile_h;
    const int64_t across = (xs + tw - 1) / tw, down = (ys + th - 1) / th;
    const int64_t row_bytes = (tw * bits_row_px + 7) / 8;
    buf.resize(static_cast<size_t>(row_bytes * th));
    for (int64_t ty = 0; ty < down; ++ty)
      for (int64_t tx = 0; tx < across; ++tx)
        for (int plane = 0; plane < planes; ++plane) {
          const size_t index = static_cast<size_t>(plane * across * down + ty * across + tx);
          int rc = decode_segment(d, len, f, index, buf.data(), buf.size(), tw, th, false,
                                  spp_row, &noeol);
          if (rc != kOk) return rc;
          finish(buf.data(), th, row_bytes, tw);
          put_rows(buf.data(), plane, std::min(th, ys - ty * th), row_bytes, tx * tw, ty * th,
                   std::min(tw, xs - tx * tw));
        }
  } else {
    const int64_t rps = (f.rows_per_strip > 0 && f.rows_per_strip < ys) ? f.rows_per_strip : ys;
    const int64_t strips = (ys + rps - 1) / rps;
    const int64_t row_bytes = (xs * bits_row_px + 7) / 8;
    buf.resize(static_cast<size_t>(row_bytes * rps));
    for (int64_t s = 0; s < strips; ++s)
      for (int plane = 0; plane < planes; ++plane) {
        const int64_t rows = std::min(rps, ys - s * rps);
        const size_t index = static_cast<size_t>(plane * strips + s);
        int rc = decode_segment(d, len, f, index, buf.data(),
                                static_cast<size_t>(rows * row_bytes), xs, rows,
                                s == strips - 1, spp_row, &noeol);
        if (rc != kOk) return rc;
        finish(buf.data(), rows, row_bytes, xs);
        put_rows(buf.data(), plane, rows, row_bytes, 0, s * rps, xs);
      }
  }
  // Pillow un-premultiplies RGBA read by planes whose first extra sample is
  // unspecified (libtiff's reading of a missing ExtraSamples) or associated
  if (by_plane && lay.mode == kRGBA && (f.extra.empty() || f.extra[0] <= 1))
    for (int64_t i = 0; i < xs * ys; ++i) {
      uint16_t* o = im.px.data() + 4 * i;
      const int a = o[3];
      for (int c = 0; c < 3; ++c)
        o[c] = static_cast<uint16_t>(a == 0 ? 0 : a == 255 ? o[c] : std::min(255, o[c] * 255 / a));
    }
  return kOk;
}

// ------------------------------------------------------- YCbCr through RGBA
// tif_color.c TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB: libtiff's fixed-point
// tables from YCbCrCoefficients and ReferenceBlackWhite, in its float and
// int32 arithmetic.
struct YCbCrTables {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];
  bool init(const Ifd& f) {
    float luma[3] = {0.299f, 0.587f, 0.114f};
    float rbw[6] = {0.f, 255.f, 128.f, 255.f, 128.f, 255.f};  // YCbCr's default
    if (f.luma.size() >= 3)
      for (int i = 0; i < 3; ++i) luma[i] = static_cast<float>(f.luma[i]);
    if (f.ref_bw.size() >= 6)
      for (int i = 0; i < 6; ++i) rbw[i] = static_cast<float>(f.ref_bw[i]);
    // initYCbCrConversion's checks
    for (float v : luma)
      if (!std::isfinite(v)) return false;
    if (luma[1] == 0.f) return false;
    for (float v : rbw)
      if (!(v > static_cast<float>(-0x7FFFFFFF + 128) && v < static_cast<float>(0x7FFFFFFF)))
        return false;
    constexpr int kShift = 16;
    constexpr int32_t kHalf = 1 << (kShift - 1);
    auto fix = [](float x) { return static_cast<int32_t>(x * static_cast<float>(1L << 16) + 0.5); };
    auto clamp2 = [](float v) { return v < 0.f ? 0.f : v > 2.f ? 2.f : v; };
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clamp2(f1));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clamp2(f2));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clamp2(f3));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clamp2(f4));
    auto code2v = [](int c, float rb, float rw, float cr) {
      const float den = (rw - rb) != 0 ? (rw - rb) : 1;
      return (static_cast<float>(c - static_cast<int32_t>(rb)) * cr) / den;
    };
    auto clampw = [](float v) {
      return v < -128.f * 32 ? -128.f * 32 : v > 128.f * 32 ? 128.f * 32 : v;
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = static_cast<int32_t>(clampw(code2v(x, rbw[4] - 128.f, rbw[5] - 128.f, 127)));
      const int32_t cb = static_cast<int32_t>(clampw(code2v(x, rbw[2] - 128.f, rbw[3] - 128.f, 127)));
      cr_r[i] = static_cast<int32_t>((int64_t(d1) * cr + kHalf) >> kShift);
      cb_b[i] = static_cast<int32_t>((int64_t(d3) * cb + kHalf) >> kShift);
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + kHalf;
      y[i] = static_cast<int32_t>(clampw(code2v(x + 128, rbw[0], rbw[1], 255)));
    }
    return true;
  }
  void rgb(int yy, int cb, int cr, uint16_t* o) const {
    auto c8 = [](int32_t v) { return static_cast<uint16_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    o[0] = c8(y[yy] + cr_r[cr]);
    o[1] = c8(y[yy] + static_cast<int32_t>((cb_g[cb] + cr_g[cr]) >> 16));
    o[2] = c8(y[yy] + cb_b[cb]);
  }
};

// A compressed YCbCr TIFF as Pillow reads it through libtiff's
// TIFFRGBAImageGet (tif_getimage.c putcontig8bitYCbCr*tile), block by block
// of rows (a strip's or a tile's): each pixel takes its own Y of its
// subsampling block and the block's Cb and Cr, edge blocks cut short.
// libtiff applies no Orientation here (Pillow's exif_transpose does, after).
int decode_ycbcr(const uint8_t* d, size_t len, const Plan& p, Image& im) {
  const Ifd& f = p.f;
  YCbCrTables t;
  if (!t.init(f)) return kRefused;
  int hs = static_cast<int>(f.subsampling[0]), vs = static_cast<int>(f.subsampling[1]);
  // old-style JPEG (compression 6): the JPEGInterchangeFormat stream's raw
  // samples as libtiff's tif_ojpeg.c packs them, at the stream's subsampling
  std::vector<uint8_t> ojpeg;
  if (f.compression == 6) {
    if (!f.has_jpeg_if || f.jpeg_if >= len || f.tiled) return kRefused;
    // one strip only: how libtiff continues one stream across strips is left open
    if (f.rows_per_strip > 0 && f.rows_per_strip < p.h) return kUnsupported;
    const size_t n = f.jpeg_if_len ? std::min<uint64_t>(f.jpeg_if_len, len - f.jpeg_if)
                                   : len - f.jpeg_if;
    int jw = 0, jh = 0;
    const int rc = jpeg_decode_ycbcr_blocks(d + f.jpeg_if, n, &hs, &vs, ojpeg, &jw, &jh);
    if (rc != kOk) return rc;
    if (jw != p.w || jh != p.h) return kRefused;
  }
  const int block = hs * vs + 2;
  const bool predict = f.predictor == 2 && (f.compression == 5 || f.compression == 8 ||
                                            f.compression == 32946);
  if (f.predictor == 3 && (f.compression == 5 || f.compression == 8 || f.compression == 32946))
    return kRefused;
  const int64_t xs = p.w, ys = p.h;
  const int64_t code = hs << 4 | vs;
  const int64_t rps = (f.rows_per_strip > 0 && f.rows_per_strip < ys) ? f.rows_per_strip : ys;
  if (f.planar == 2) {  // gtStripSeparate / gtTileSeparate, putseparate8bitYCbCr11tile
    const bool tiled = f.tiled;
    const int64_t sw = tiled ? f.tile_w : xs, sh = tiled ? f.tile_h : rps;
    const int64_t across = (xs + sw - 1) / sw, down = (ys + sh - 1) / sh;
    std::vector<uint8_t> planes[3];
    for (int64_t ty = 0; ty < down; ++ty)
      for (int64_t tx = 0; tx < across; ++tx) {
        const int64_t rows = tiled ? sh : std::min(sh, ys - ty * sh);
        for (int c = 0; c < 3; ++c) {
          planes[c].assign(static_cast<size_t>(sw * rows), 0);
          const size_t index = static_cast<size_t>((c * down + ty) * across + tx);
          // a plane that fails to decode is put as far as it decoded (zeros past)
          const int rc = decode_segment(d, len, f, index, planes[c].data(), planes[c].size(), sw,
                                        rows, !tiled && ty == down - 1, 1);
          if (rc != kOk && rc != kCorrupt) return rc;
        }
        const int64_t cw = std::min(sw, xs - tx * sw), ch = std::min(sh, ys - ty * sh);
        for (int64_t y = 0; y < ch; ++y)
          for (int64_t x = 0; x < cw; ++x) {
            const size_t at = static_cast<size_t>(y * sw + x);
            t.rgb(planes[0][at], planes[1][at], planes[2][at], im.at(tx * sw + x, ty * sh + y));
          }
      }
    return kOk;
  }
  std::vector<uint8_t> buf;
  // put: the visible cw x ch pixels at (x0, y0) of a segment sw pixels wide,
  // walked as tif_getimage.c walks it: blocks in order, then past the hidden
  // blocks of each row of blocks (fromskew), which putcontig8bitYCbCr44tile
  // counts at 10 bytes a block, not 18
  auto put = [&](int64_t sw, int64_t x0, int64_t y0, int64_t cw, int64_t ch) {
    const int64_t skew = (sw - cw) / hs * (code == 0x44 ? 10 : block);
    size_t pp = 0;
    for (int64_t by = 0; by < ch; by += vs) {
      for (int64_t bx = 0; bx < cw; bx += hs, pp += block) {
        if (pp + block > buf.size()) return static_cast<int>(kCorrupt);
        const uint8_t* b = buf.data() + pp;
        for (int64_t dy = 0; dy < vs && by + dy < ch; ++dy)
          for (int64_t dx = 0; dx < hs && bx + dx < cw; ++dx)
            t.rgb(b[dy * hs + dx], b[hs * vs], b[hs * vs + 1], im.at(x0 + bx + dx, y0 + by + dy));
      }
      pp += static_cast<size_t>(skew);
    }
    return static_cast<int>(kOk);
  };
  // a segment sw x sh pixels into buf: its first `want` bytes as decoded
  // (all when 0), the rest zeros
  auto decode = [&](size_t index, int64_t sw, int64_t sh, size_t want) {
    const size_t row = static_cast<size_t>((sw + hs - 1) / hs) * block;  // a row of blocks
    const size_t size = row * static_cast<size_t>((sh + vs - 1) / vs);
    buf.assign(size, 0);
    const size_t n = want ? std::min(want, size) : size;
    int rc = kOk;
    if (!ojpeg.empty()) {  // the strip's rows of blocks of the whole stream
      const size_t at = static_cast<size_t>(index) * row * static_cast<size_t>((rps + vs - 1) / vs);
      if (at + size > ojpeg.size()) return static_cast<int>(kRefused);
      std::copy(ojpeg.begin() + static_cast<std::ptrdiff_t>(at),
                ojpeg.begin() + static_cast<std::ptrdiff_t>(at + size), buf.begin());
    } else {
      // TIFFRGBAImageGet does not stop on a strip's or tile's error (Pillow
      // passes stop_on_error 0): it puts what was decoded, zeros past it
      rc = decode_segment(d, len, f, index, buf.data(), size);
      if (rc == kCorrupt) rc = kOk;
    }
    std::fill(buf.begin() + static_cast<std::ptrdiff_t>(n), buf.end(), 0);
    if (rc != kOk || !predict) return rc;
    // libtiff's horAcc8 over its scanlines of a row of blocks / vs bytes
    const size_t line = row / vs;
    if (line == 0 || n % line) return static_cast<int>(kRefused);
    for (size_t o = 0; o < n; o += line)
      for (size_t k = 3; k < line; ++k) buf[o + k] = static_cast<uint8_t>(buf[o + k] + buf[o + k - 3]);
    return static_cast<int>(kOk);
  };
  if (f.tiled) {
    const int64_t tw = f.tile_w, th = f.tile_h;
    const int64_t across = (xs + tw - 1) / tw, down = (ys + th - 1) / th;
    for (int64_t ty = 0; ty < down; ++ty)
      for (int64_t tx = 0; tx < across; ++tx) {
        int rc = decode(static_cast<size_t>(ty * across + tx), tw, th, 0);
        if (rc == kOk)
          rc = put(tw, tx * tw, ty * th, std::min(tw, xs - tx * tw), std::min(th, ys - ty * th));
        if (rc != kOk) return rc;
      }
  } else {
    // gtStripContig reads a strip's rows rounded up to vs, of TIFFScanlineSize
    // bytes each (a row of blocks / vs, rounded down): short of the strip at
    // some widths, the rest of its buffer then zeros
    const size_t scanline = static_cast<size_t>((xs + hs - 1) / hs) * block / vs;
    for (int64_t s = 0; s * rps < ys; ++s) {
      const int64_t rows = std::min(rps, ys - s * rps);
      const size_t want = static_cast<size_t>((rows + vs - 1) / vs * vs) * scanline;
      int rc = decode(static_cast<size_t>(s), xs, rows, std::max<size_t>(want, 1));
      if (rc == kOk) rc = put(xs, 0, s * rps, xs, rows);
      if (rc != kOk) return rc;
    }
  }
  return kOk;
}

// ------------------------------------------------------------------ LAB
// Pillow converts LAB to RGB through ImageCms: LittleCMS 2.17's transform
// from its Lab v4 identity profile (D50) to its built-in sRGB, perceptual,
// 8-bit in and out.  LittleCMS samples the float pipeline (Lab to XYZ,
// sRGB's inverse matrix, the inverse of its parametric curve) on a 33^3
// grid of 16-bit nodes, then evaluates each pixel by tetrahedral
// interpolation in 16 bits; both are reproduced here with its float and
// double arithmetic (cmsopt.c OptimizeByResampling, cmslut.c _LUTeval16,
// cmsintrp.c TetrahedralInterp16, cmsvirt.c cmsCreate_sRGBProfile).
class LabToRgb {
 public:
  LabToRgb() {
    // sRGB: Rec. 709 primaries and D65 (0.3127, 0.3290), adapted to D50 by
    // Bradford (cmswtpnt.c _cmsBuildRGB2XYZtransferMatrix)
    const double xn = 0.3127, yn = 0.3290;
    const double xr = 0.64, yr = 0.33, xg = 0.30, yg = 0.60, xb = 0.15, yb = 0.06;
    M3 prim = {{{xr, xg, xb}, {yr, yg, yb}, {1 - xr - yr, 1 - xg - yg, 1 - xb - yb}}};
    const M3 res = inverse(prim);
    const double wp[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn};
    double coef[3];
    eval(res, wp, coef);
    M3 r = {{{coef[0] * xr, coef[1] * xg, coef[2] * xb},
             {coef[0] * yr, coef[1] * yg, coef[2] * yb},
             {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)}}};
    const double white[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};
    const M3 rgb2xyz = mul(bradford(white), r);
    // BuildRGBOutputMatrixShaper: the inverse, times the XYZ encoding's 1.99997
    M3 inv = inverse(rgb2xyz);
    for (auto& row : inv.m)
      for (double& v : row) v *= kXyzAdj;
    // the 33^3 nodes
    for (int i = 0; i < kN; ++i)
      for (int j = 0; j < kN; ++j)
        for (int k = 0; k < kN; ++k) {
          const uint16_t in[3] = {node(i), node(j), node(k)};
          float lab[3];
          for (int c = 0; c < 3; ++c) lab[c] = static_cast<float>(in[c]) / 65535.0F;
          const double L = lab[0] * 100.0, a = lab[1] * 255.0 - 128.0, b = lab[2] * 255.0 - 128.0;
          const double y = (L + 16.0) / 116.0, x = y + 0.002 * a, z = y - 0.005 * b;
          const float xyz[3] = {static_cast<float>(f_1(x) * 0.9642 / kXyzAdj),
                                static_cast<float>(f_1(y) * 1.0 / kXyzAdj),
                                static_cast<float>(f_1(z) * 0.8249 / kXyzAdj)};
          uint16_t* o = t_ + ((i * kN + j) * kN + k) * 3;
          for (int c = 0; c < 3; ++c) {
            double tmp = 0;
            for (int e = 0; e < 3; ++e) tmp += xyz[e] * inv.m[c][e];
            const float lin = static_cast<float>(tmp);
            o[c] = saturate_word(static_cast<float>(inverse_srgb(lin)) * 65535.0);
          }
        }
  }

  // stored L, a, b (a and b offset by 128) to RGB
  void rgb(int l, int a, int b, uint8_t* out) const {
    const int in[3] = {l * 257, a * 257, b * 257};
    int32_t f[3], r[3];
    int x0[3], step[3];
    const int opta[3] = {kN * kN * 3, kN * 3, 3};
    for (int c = 0; c < 3; ++c) {
      const int v = in[c] * (kN - 1);
      f[c] = v + (v + 0x7fff) / 0xffff;  // _cmsToFixedDomain
      x0[c] = (f[c] >> 16) * opta[c];
      r[c] = f[c] & 0xffff;
      step[c] = in[c] == 0xffff ? 0 : opta[c];
    }
    const int rx = r[0], ry = r[1], rz = r[2];
    const uint16_t* lut = t_ + x0[0] + x0[1] + x0[2];
    int X1 = step[0], Y1 = step[1], Z1 = step[2];
    for (int ch = 0; ch < 3; ++ch, ++lut) {
      int32_t c0 = lut[0], c1, c2, c3;
      if (rx >= ry && ry >= rz) {
        c1 = lut[X1] - c0;
        c2 = lut[X1 + Y1] - lut[X1];
        c3 = lut[X1 + Y1 + Z1] - lut[X1 + Y1];
      } else if (rx >= rz && rz >= ry) {
        c1 = lut[X1] - c0;
        c2 = lut[X1 + Y1 + Z1] - lut[X1 + Z1];
        c3 = lut[X1 + Z1] - lut[X1];
      } else if (rz >= rx && rx >= ry) {
        c1 = lut[X1 + Z1] - lut[Z1];
        c2 = lut[X1 + Y1 + Z1] - lut[X1 + Z1];
        c3 = lut[Z1] - c0;
      } else if (ry >= rx && rx >= rz) {
        c1 = lut[X1 + Y1] - lut[Y1];
        c2 = lut[Y1] - c0;
        c3 = lut[X1 + Y1 + Z1] - lut[X1 + Y1];
      } else if (ry >= rz && rz >= rx) {
        c1 = lut[X1 + Y1 + Z1] - lut[Y1 + Z1];
        c2 = lut[Y1] - c0;
        c3 = lut[Y1 + Z1] - lut[Y1];
      } else {  // rz >= ry >= rx
        c1 = lut[X1 + Y1 + Z1] - lut[Y1 + Z1];
        c2 = lut[Y1 + Z1] - lut[Z1];
        c3 = lut[Z1] - c0;
      }
      // LittleCMS's int32 sums, which wrap at extreme corners: in uint32 here
      const int32_t rest = static_cast<int32_t>(
          static_cast<uint32_t>(c1) * static_cast<uint32_t>(rx) +
          static_cast<uint32_t>(c2) * static_cast<uint32_t>(ry) +
          static_cast<uint32_t>(c3) * static_cast<uint32_t>(rz) + 0x8001u);
      const int32_t sum =
          static_cast<int32_t>(static_cast<uint32_t>(rest) + static_cast<uint32_t>(rest >> 16));
      const uint32_t v16 = static_cast<uint16_t>(c0 + (sum >> 16));
      out[ch] = static_cast<uint8_t>(((v16 * 65281U + 8388608U) >> 24) & 0xFFU);  // FROM_16_TO_8
    }
  }

 private:
  static constexpr int kN = 33;
  static constexpr double kXyzAdj = 1.0 + 32767.0 / 32768.0;  // MAX_ENCODEABLE_XYZ
  struct M3 {
    double m[3][3];
  };
  uint16_t t_[kN * kN * kN * 3];

  static M3 inverse(const M3& a) {  // cmsmtrx.c _cmsMAT3inverse
    const auto& v = a.m;
    const double c0 = v[1][1] * v[2][2] - v[1][2] * v[2][1];
    const double c1 = -v[1][0] * v[2][2] + v[1][2] * v[2][0];
    const double c2 = v[1][0] * v[2][1] - v[1][1] * v[2][0];
    const double det = v[0][0] * c0 + v[0][1] * c1 + v[0][2] * c2;
    M3 b;
    b.m[0][0] = c0 / det;
    b.m[0][1] = (v[0][2] * v[2][1] - v[0][1] * v[2][2]) / det;
    b.m[0][2] = (v[0][1] * v[1][2] - v[0][2] * v[1][1]) / det;
    b.m[1][0] = c1 / det;
    b.m[1][1] = (v[0][0] * v[2][2] - v[0][2] * v[2][0]) / det;
    b.m[1][2] = (v[0][2] * v[1][0] - v[0][0] * v[1][2]) / det;
    b.m[2][0] = c2 / det;
    b.m[2][1] = (v[0][1] * v[2][0] - v[0][0] * v[2][1]) / det;
    b.m[2][2] = (v[0][0] * v[1][1] - v[0][1] * v[1][0]) / det;
    return b;
  }
  static M3 mul(const M3& a, const M3& b) {  // _cmsMAT3per
    M3 r;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        r.m[i][j] = a.m[i][0] * b.m[0][j] + a.m[i][1] * b.m[1][j] + a.m[i][2] * b.m[2][j];
    return r;
  }
  static void eval(const M3& a, const double v[3], double out[3]) {  // _cmsMAT3eval
    for (int i = 0; i < 3; ++i) out[i] = a.m[i][0] * v[0] + a.m[i][1] * v[1] + a.m[i][2] * v[2];
  }
  // cmscam02.c-free _cmsAdaptationMatrix: Bradford from `white` to D50
  static M3 bradford(const double white[3]) {
    const M3 chad = {{{0.8951, 0.2664, -0.1614}, {-0.7502, 1.7135, 0.0367},
                      {0.0389, -0.0685, 1.0296}}};
    const M3 chad_inv = inverse(chad);
    const double d50[3] = {0.9642, 1.0, 0.8249};
    double src[3], dst[3];
    eval(chad, white, src);
    eval(chad, d50, dst);
    const M3 cone = {{{dst[0] / src[0], 0.0, 0.0}, {0.0, dst[1] / src[1], 0.0},
                      {0.0, 0.0, dst[2] / src[2]}}};
    return mul(chad_inv, mul(cone, chad));
  }
  static double f_1(double t) {  // cmspcs.c cmsLab2XYZ
    return t <= 24.0 / 116.0 ? (108.0 / 841.0) * (t - (16.0 / 116.0)) : t * t * t;
  }
  // the sRGB curve's analytic inverse, parametric type -4 (cmsgamma.c)
  static double inverse_srgb(double r) {
    const double p0 = 2.4, p1 = 1. / 1.055, p2 = 0.055 / 1.055, p3 = 1. / 12.92, p4 = 0.04045;
    const double disc = std::pow(p1 * p4 + p2, p0);
    return r >= disc ? (std::pow(r, 1.0 / p0) - p2) / p1 : r / p3;
  }
  static int quick_floor(double v) {  // lcms2_internal.h _cmsQuickFloor
    union {
      double d;
      int32_t halves[2];
    } t;
    t.d = v + 68719476736.0 * 1.5;
    return t.halves[0] >> 16;
  }
  static uint16_t saturate_word(double d) {  // _cmsQuickSaturateWord
    d += 0.5;
    if (d <= 0) return 0;
    if (d >= 65535.0) return 0xffff;
    return static_cast<uint16_t>(quick_floor(d - 32767.0) + 32767);
  }
  static uint16_t node(int i) { return saturate_word(i * 65535. / (kN - 1)); }  // _cmsQuantizeVal
};

const LabToRgb& lab_to_rgb() {
  static const LabToRgb t;
  return t;
}

// Pillow's convert("RGB") of the mode, then ImageOps.exif_transpose.
void to_rgb(const Plan& p, Image& im, int64_t ow, uint8_t* out) {
  const Ifd& f = p.f;
  uint8_t pal[256 * 3] = {0};
  if (p.lay.mode == kP || p.lay.mode == kPA) {
    const size_t n = f.colormap.size() / 3;
    for (size_t i = 0; i < n && i < 256; ++i)
      for (int c = 0; c < 3; ++c) pal[3 * i + c] = static_cast<uint8_t>(f.colormap[c * n + i] >> 8);
  }
  const int64_t w = im.w, h = im.h;
  const uint64_t ori = f.orientation;
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      const uint16_t* s = im.at(x, y);
      uint8_t rgb[3];
      switch (p.lay.mode) {
        case k1: case kL: case kLA:
          rgb[0] = rgb[1] = rgb[2] = static_cast<uint8_t>(s[0]);
          break;
        case kI16:
          rgb[0] = rgb[1] = rgb[2] = static_cast<uint8_t>(std::min<int>(s[0], 255));
          break;
        case kI:
          rgb[0] = rgb[1] = rgb[2] = static_cast<uint8_t>(s[0]);
          break;
        case kP: case kPA:
          std::memcpy(rgb, pal + 3 * (s[0] & 255), 3);
          break;
        case kRGB: case kRGBA: case kYCbCr:
          for (int c = 0; c < 3; ++c) rgb[c] = static_cast<uint8_t>(s[c]);
          break;
        case kCMYK:
          cmyk_to_rgb(s[0], s[1], s[2], s[3], rgb);
          break;
        case kLab:
          lab_to_rgb().rgb(s[0], s[1], s[2], rgb);
          break;
      }
      // where (x, y) lands after the transpose of the orientation
      int64_t ox = x, oy = y;
      switch (ori) {
        case 2: ox = w - 1 - x; break;
        case 3: ox = w - 1 - x; oy = h - 1 - y; break;
        case 4: oy = h - 1 - y; break;
        case 5: ox = y; oy = x; break;
        case 6: ox = h - 1 - y; oy = x; break;
        case 7: ox = h - 1 - y; oy = w - 1 - x; break;
        case 8: ox = y; oy = w - 1 - x; break;
        default: break;
      }
      std::memcpy(out + (oy * ow + ox) * 3, rgb, 3);
    }
}

bool swaps(uint64_t ori) { return ori >= 5 && ori <= 8; }

int decode_tiff(const uint8_t* d, size_t len, int w_expect, int h_expect, uint8_t* out) {
  Plan p;
  int rc = plan(d, len, &p);
  if (rc != kOk) return rc;
  const bool sw = swaps(p.f.orientation);
  if ((sw ? p.h : p.w) != w_expect || (sw ? p.w : p.h) != h_expect) return kCorrupt;
  Image im;
  im.w = p.w;
  im.h = p.h;
  im.px.assign(static_cast<size_t>(p.w * p.h * 4), 0);
  rc = !p.libtiff ? decode_raw(d, len, p, im)
       : p.lay.mode == kYCbCr ? decode_ycbcr(d, len, p, im) : decode_libtiff(d, len, p, im);
  if (rc != kOk) return rc;
  to_rgb(p, im, w_expect, out);
  return kOk;
}

}  // namespace

extern "C" {

// The image's width and height after its orientation.  Returns 0 on success.
int fsvlm_tiff_size(const uint8_t* data, long len, int* w, int* h) {
  return guarded([&] {
    Plan p;
    const int rc = plan(data, static_cast<size_t>(len), &p);
    if (rc != kOk) return rc;
    const bool sw = swaps(p.f.orientation);
    *w = static_cast<int>(sw ? p.h : p.w);
    *h = static_cast<int>(sw ? p.w : p.h);
    return static_cast<int>(kOk);
  });
}

// Full-resolution RGB into `out` (w * h * 3 bytes, w and h from
// fsvlm_tiff_size).  Returns 0 on success.
int fsvlm_tiff_decode_full(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  return guarded([&] { return decode_tiff(data, static_cast<size_t>(len), w, h, out); });
}

}  // extern "C"
