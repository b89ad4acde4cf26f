// The port's TIFF decoder: the first IFD of a classic TIFF (both byte
// orders), with no library, its output byte-equal to Pillow 12.1's
// Image.open(path).convert("RGB") (TiffImagePlugin over its libtiff 4.7).
//
// Pillow reads a TIFF in one of two ways, and this decoder follows both:
//
//  - Uncompressed: Pillow's own raw decoder, strip by strip or tile by
//    tile from each offset (the byte counts unread), rows of the raw
//    mode's width, FillOrder 2 as bit-reversed bytes, the Predictor tag
//    ignored; PlanarConfiguration 2 reads each plane with the one-letter
//    raw mode of its band (R, G, B, A, L, P, 1, C, M, Y, K), 8 bits a
//    sample whatever the file's depth, as Pillow does.
//  - Compressed (PackBits, LZW new style and the old LSB-first style
//    libtiff still reads, Deflate 8 and 32946 through png_decoder.cpp's
//    inflate): libtiff's strips and tiles, each decoded to its full size
//    (FillOrder 2 reverses the coded bytes), 16-bit samples in the file's
//    byte order, horizontal differencing (Predictor 2, 8 and 16 bits) for
//    LZW and Deflate only; then Pillow's unpacker row by row, and for
//    PlanarConfiguration 2 one plane per band, 8 or 16 bits (the high
//    byte), with no un-premultiplying.
//
// The pixel layout follows Pillow's OPEN_INFO table: min-is-white and
// min-is-black at 1, 2, 4 and 8 bits (min-is-white inverted, 2 and 4 bits
// scaled by 85 and 17), 16-bit gray (mode I;16, not inverted even when
// min-is-white; clipped to 255 by convert), RGB 8 and 16 (the high byte),
// RGB with extra samples (unassociated RGBA, padding X, associated RGBa
// un-premultiplied at unpacking), gray with alpha, palette at 1-8 bits with
// its 16-bit colormap taken as v // 256, palette with alpha, and CMYK 8 and
// 16 through Pillow's CMYK->RGB.  Pillow 12.1 applies the Orientation tag
// (ImageOps.exif_transpose), and so does this decoder.
//
// YCbCr, JPEG-in-TIFF, CCITT and the other codecs, float, signed and
// 12/32-bit samples, LAB and BigTIFF return kUnsupported (ROADMAP A16); a
// layout past Pillow's table, or one Pillow's readers refuse, kRefused;
// truncated or malformed data kCorrupt; an image of more pixels than twice
// Pillow's MAX_IMAGE_PIXELS kTooLarge.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

enum Mode { k1, kL, kP, kLA, kPA, kI16, kRGB, kRGBA, kCMYK };

struct Ifd {
  bool le = true;
  int64_t width = -1, height = -1;
  std::vector<uint64_t> bps{1}, extra, sample_format{1}, colormap;
  uint64_t compression = 1, photometric = 0, fillorder = 1, spp = 1, planar = 1,
           predictor = 1, orientation = 1;
  bool has_spp = false;
  int64_t rows_per_strip = -1, tile_w = -1, tile_h = -1;
  bool tiled = false;
  std::vector<uint64_t> offsets, counts;
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
};

int parse_ifd(const uint8_t* d, size_t len, Ifd* f) {
  if (len < 8) return kCorrupt;
  f->le = d[0] == 'I';
  Reader r{d, f->le};
  const uint64_t at = r.u32(4);
  if (at + 2 > len) return kCorrupt;
  const uint64_t n = r.u16(at);
  if (at + 2 + 12 * n > len) return kCorrupt;
  for (uint64_t i = 0; i < n; ++i) {
    const size_t e = at + 2 + 12 * i;
    const uint64_t tag = r.u16(e), type = r.u16(e + 2), count = r.u32(e + 4);
    int size;
    switch (type) {
      case 1: case 2: case 6: case 7: size = 1; break;
      case 3: case 8: size = 2; break;
      case 4: case 9: case 11: case 13: size = 4; break;
      case 5: case 10: case 12: size = 8; break;
      default: continue;  // an unknown type: Pillow skips the tag
    }
    if (count > (uint64_t(1) << 28)) return kCorrupt;
    const uint64_t bytes = count * size;
    const size_t p = bytes <= 4 ? e + 8 : static_cast<size_t>(r.u32(e + 8));
    if (p + bytes > len) return kCorrupt;
    if (type != 1 && type != 3 && type != 4 && type != 7) continue;  // no integer tag we read
    std::vector<uint64_t> v(count);
    for (uint64_t k = 0; k < count; ++k)
      v[k] = size == 1 ? d[p + k] : size == 2 ? r.u16(p + 2 * k) : r.u32(p + 4 * k);
    auto one = [&](uint64_t* dst) {
      if (!v.empty()) *dst = v[0];
    };
    switch (tag) {
      case 256: if (!v.empty()) f->width = static_cast<int64_t>(v[0]); break;
      case 257: if (!v.empty()) f->height = static_cast<int64_t>(v[0]); break;
      case 258: f->bps = v; break;
      case 259: one(&f->compression); break;
      case 262: one(&f->photometric); break;
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
      case 338: f->extra = v; break;
      case 339: f->sample_format = v; break;
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
};

bool same(const std::vector<uint64_t>& a, std::initializer_list<uint64_t> b) {
  return a.size() == b.size() && std::equal(a.begin(), a.end(), b.begin());
}

// Pillow's _setup up to the table lookup.  `fill` is the FillOrder of the
// key (libtiff's path looks it up as 1).
int lookup(const Ifd& f, uint64_t photo, uint64_t fill, Layout* lay) {
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
  if (photo == 0 || photo == 1) {
    if (spp == 1 && ex.empty()) {
      if (b == 1 || b == 2 || b == 4 || b == 8) {
        lay->mode = b == 1 ? k1 : kL;
        lay->invert = photo == 0;
        return kOk;
      }
      if (b == 16) {
        // II min-is-white and -black, MM min-is-black; FillOrder 2 only II
        // min-is-black ("I;16R"), which this decoder leaves to A16
        if (fill == 2) return (!mm && photo == 1) ? kUnsupported : kRefused;
        if (mm && photo == 0) return kRefused;
        lay->mode = kI16;
        return kOk;
      }
      // Pillow's table reads 12- and 32-bit II min-is-black too (A16)
      return ((b == 12 || b == 32) && photo == 1 && !mm && fill == 1) ? kUnsupported : kRefused;
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
  if (photo == 6 || photo == 8) return kUnsupported;  // YCbCr, LAB
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

// Sample k (of `bits`) of a row, with the sample order `le` at 16 bits.
inline uint32_t sample(const uint8_t* row, int64_t k, int bits, bool le) {
  switch (bits) {
    case 1: return (row[k >> 3] >> (7 - (k & 7))) & 1;
    case 2: return (row[k >> 2] >> (6 - 2 * (k & 3))) & 3;
    case 4: return (row[k >> 1] >> (k & 1 ? 0 : 4)) & 15;
    case 8: return row[k];
    default: {
      const uint8_t* p = row + 2 * k;
      return le ? p[0] | (p[1] << 8) : (p[0] << 8) | p[1];
    }
  }
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
        o[0] = static_cast<uint16_t>(sample(row, k0, 16, le));
        break;
      case kRGB:
        for (int c = 0; c < 3; ++c) o[c] = static_cast<uint16_t>(s8(c));
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
  if (len < 8 || !((d[0] == 'I' && d[1] == 'I' && d[2] == 42 && d[3] == 0) ||
                   (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && d[3] == 42)))
    return kCorrupt;
  Ifd& f = p->f;
  int rc = parse_ifd(d, len, &f);
  if (rc != kOk) return rc;
  p->w = f.width;
  p->h = f.height;
  if (too_large(f.width, f.height)) return kTooLarge;
  switch (f.compression) {
    case 1: case 5: case 8: case 32773: case 32946: break;
    case 2: case 3: case 4: case 6: case 7: case 32771: case 32809: case 34676: case 34677:
    case 34925: case 50000: case 50001: return kUnsupported;
    default: return kRefused;  // not in Pillow's COMPRESSION_INFO
  }
  p->libtiff = f.compression != 1;
  const uint64_t photo = f.photometric;
  std::vector<uint64_t> sf = f.sample_format;
  if (sf.empty() || !std::all_of(sf.begin(), sf.end(), [](uint64_t v) { return v == 1; }))
    return kUnsupported;  // signed or float samples
  if (f.fillorder != 1 && f.fillorder != 2) return kRefused;
  rc = lookup(f, photo, p->libtiff ? 1 : f.fillorder, &p->lay);
  if (rc != kOk) return rc;
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
    case kI16: letters = "I"; break;
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
    if (x + w > xs) stride = w * sum_bits / 8;
    Layout l = lay;
    int ch = -1;
    if (f.planar == 2) {
      // Pillow has one-letter unpackers for 1, L, P, RGB, RGBA and CMYK only
      if (lay.mode == kLA || lay.mode == kPA || lay.mode == kI16) return kRefused;
      if (layer >= letters.size()) return kRefused;
      ch = channel_of(letters[layer]);
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

// libtiff's decode of one strip or tile into `out` (its full size).
int decode_segment(const uint8_t* d, size_t len, const Ifd& f, size_t index, uint8_t* out,
                   size_t size) {
  if (index >= f.offsets.size() || index >= f.counts.size()) return kCorrupt;
  const uint64_t off = f.offsets[index], cnt = f.counts[index];
  if (off > len || cnt > len - off) return kCorrupt;
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
      const int rc = zlib_inflate(src, cnt, out, size, &produced);
      return rc == kOk && produced == size ? kOk : kCorrupt;
    }
  }
}

int decode_libtiff(const uint8_t* d, size_t len, const Plan& p, Image& im) {
  const Ifd& f = p.f;
  const Layout& lay = p.lay;
  const int64_t xs = p.w, ys = p.h;
  const bool separate = f.planar == 2;
  const int bands = (lay.mode == kRGB) ? 3 : (lay.mode == kRGBA || lay.mode == kCMYK) ? 4
                  : (lay.mode == kLA || lay.mode == kPA) ? 2 : 1;
  const bool by_plane = separate && bands > 1;
  if (by_plane && lay.bits != 8 && lay.bits != 16) return kRefused;
  const int planes = by_plane ? bands : 1;
  // Pillow's strip reader fails where planes are fewer than the samples
  if (by_plane && !f.tiled && planes < lay.samples) return kRefused;
  const int spp_row = separate ? 1 : lay.samples;  // samples a pixel in a decoded row
  const bool predict = f.predictor == 2 && (f.compression == 5 || f.compression == 8 ||
                                             f.compression == 32946);
  if (f.predictor == 3 && f.compression != 32773) return kRefused;
  if (predict && lay.bits != 8 && lay.bits != 16) return kRefused;
  const bool swab = lay.bits == 16 && !f.le;
  auto finish = [&](uint8_t* buf, int64_t rows, int64_t row_bytes, int64_t row_px) {
    if (swab)
      for (int64_t i = 0; i + 1 < rows * row_bytes; i += 2) std::swap(buf[i], buf[i + 1]);
    if (!predict) return;
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* row = buf + r * row_bytes;
      const int64_t n = row_px * spp_row;
      if (lay.bits == 8) {
        for (int64_t k = spp_row; k < n; ++k) row[k] = static_cast<uint8_t>(row[k] + row[k - spp_row]);
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
        unpack(lay, row, n, true, im, x0, y0 + r);
      }
    }
  };
  const int64_t bits_row_px = static_cast<int64_t>(lay.bits) * spp_row;
  std::vector<uint8_t> buf;
  if (f.tiled) {
    const int64_t tw = f.tile_w, th = f.tile_h;
    const int64_t across = (xs + tw - 1) / tw, down = (ys + th - 1) / th;
    const int64_t row_bytes = (tw * bits_row_px + 7) / 8;
    buf.resize(static_cast<size_t>(row_bytes * th));
    for (int64_t ty = 0; ty < down; ++ty)
      for (int64_t tx = 0; tx < across; ++tx)
        for (int plane = 0; plane < planes; ++plane) {
          const size_t index = static_cast<size_t>(plane * across * down + ty * across + tx);
          int rc = decode_segment(d, len, f, index, buf.data(), buf.size());
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
                                static_cast<size_t>(rows * row_bytes));
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
        case kP: case kPA:
          std::memcpy(rgb, pal + 3 * (s[0] & 255), 3);
          break;
        case kRGB: case kRGBA:
          for (int c = 0; c < 3; ++c) rgb[c] = static_cast<uint8_t>(s[c]);
          break;
        case kCMYK:
          cmyk_to_rgb(s[0], s[1], s[2], s[3], rgb);
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
  rc = p.libtiff ? decode_libtiff(d, len, p, im) : decode_raw(d, len, p, im);
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
