// The port's BMP decoder with no library, its output byte-equal to Pillow
// 12.1's Image.open(path).convert("RGB") (BmpImagePlugin), including where
// Pillow's reading is its own:
//
//  - Headers of 12 (OS/2 1.x: 16-bit sizes, 3-byte palette entries, always
//    bottom-up), 40, 52, 56, 64, 108 and 124 bytes; a negative height is
//    top-down.  The palette is read right after the header (after the three
//    masks of a 40-byte BITFIELDS header), and a pixel offset that points
//    right after the header is moved past 4 bytes per colour.
//  - 1/4/8-bit palettes of biClrUsed colours (0 means 2^bits); a palette
//    of black and white (2 colours) or of i -> (i, i, i) is dropped for mode
//    1 or L, whose raw rows Pillow then reads as 1 or 8 bits per pixel
//    whatever the file's depth.  An index past the palette is black.
//  - 16 bits as 5-5-5 (BGR;15) or, with BITFIELDS, 5-6-5 (BGR;16), each
//    channel v * 255 / max in integers; 24 bits; 32 bits with alpha or
//    padding dropped.  BITFIELDS takes the masks Pillow's table lists and no
//    others; ALPHABITFIELDS (6) and JPEG/PNG payloads Pillow refuses too.
//  - RLE8 and RLE4 as Pillow's BmpRleDecoder: a run clipped at the row's
//    end, absolute runs (RLE4's of an odd count lose their last pixel) that
//    may run past it and are padded to a 16-bit boundary of the file
//    offset, end of line padded with index 0, a delta whose offsets come
//    from the second of the two byte pairs Pillow reads, and index 0 for
//    every pixel a delta skips; a stream that stops short of the image
//    raises, as Pillow's "not enough image data".
//
// Rows are padded to 4 bytes; bottom-up rows are flipped.  Truncated data
// returns kCorrupt, a layout Pillow refuses kRefused, an image of more
// pixels than twice Pillow's MAX_IMAGE_PIXELS kTooLarge.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

enum Raw { kPal1, kPal4, kPal8, kBits1, kGray8, kBgr15, kBgr16, kBgr24, kBytes32 };

struct Header {
  int64_t width = 0, height = 0;
  bool top_down = false;
  int bits = 0;
  uint32_t compression = 0;
  int64_t offset = 0;  // of the pixel data
  Raw raw = kPal8;
  int byte_of[3] = {2, 1, 0};  // 32 bits: the byte of R, G and B
  bool rle = false, rle4 = false;
  std::vector<uint8_t> palette;  // RGB, 256 entries, black past the file's
};

int parse(const uint8_t* d, size_t len, Header* h) {
  if (len < 18 || d[0] != 'B' || d[1] != 'M') return kCorrupt;
  h->offset = le32(d + 10);
  const uint32_t hsize = le32(d + 14);
  if (hsize < 4 || len < 14 + static_cast<size_t>(hsize)) return kCorrupt;
  const uint8_t* hd = d + 18;  // the header after its size
  size_t pos = 14 + hsize;
  int padding;
  uint64_t colors = 0;
  uint32_t masks[4] = {0, 0, 0, 0};
  if (hsize == 12) {
    h->width = le16(hd);
    h->height = le16(hd + 2);
    h->bits = static_cast<int>(le16(hd + 6));
    h->compression = 0;
    padding = 3;
  } else if (hsize == 40 || hsize == 52 || hsize == 56 || hsize == 64 || hsize == 108 ||
             hsize == 124) {
    h->top_down = hd[7] == 0xFF;
    h->width = le32(hd);
    h->height = h->top_down ? (int64_t(1) << 32) - le32(hd + 4) : le32(hd + 4);
    h->bits = static_cast<int>(le16(hd + 10));
    h->compression = le32(hd + 12);
    colors = le32(hd + 28);
    padding = 4;
    if (h->compression == 3) {
      if (hsize >= 52) {
        for (int i = 0; i < (hsize >= 56 ? 4 : 3); ++i) masks[i] = le32(hd + 36 + 4 * i);
      } else {
        if (len < pos + 12) return kCorrupt;
        for (int i = 0; i < 3; ++i) masks[i] = le32(d + pos + 4 * i);
        pos += 12;
      }
    }
  } else {
    return kRefused;
  }
  if (h->width == 0 || h->height == 0) return kRefused;
  if (too_large(h->width, h->height)) return kTooLarge;
  if (colors == 0) colors = uint64_t(1) << std::min(h->bits, 63);
  if (h->offset == 14 + int64_t(hsize) && h->bits <= 8) h->offset += 4 * int64_t(colors);
  const int b = h->bits;
  if (b != 1 && b != 4 && b != 8 && b != 16 && b != 24 && b != 32) return kRefused;
  h->raw = b == 1 ? kPal1 : b == 4 ? kPal4 : b == 8 ? kPal8 : b == 16 ? kBgr15
         : b == 24 ? kBgr24 : kBytes32;
  if (h->compression == 3) {
    // Pillow's table of the BITFIELDS layouts it reads
    struct Layout { int bits; uint32_t r, g, b, a; };
    static const Layout kLayouts[] = {
        {32, 0xFF0000, 0xFF00, 0xFF, 0x0},        {32, 0xFF000000, 0xFF0000, 0xFF00, 0x0},
        {32, 0xFF000000, 0xFF00, 0xFF, 0x0},      {32, 0xFF000000, 0xFF0000, 0xFF00, 0xFF},
        {32, 0xFF, 0xFF00, 0xFF0000, 0xFF000000}, {32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000},
        {32, 0xFF000000, 0xFF00, 0xFF, 0xFF0000}, {32, 0x0, 0x0, 0x0, 0x0},
        {24, 0xFF0000, 0xFF00, 0xFF, 0},          {16, 0xF800, 0x7E0, 0x1F, 0},
        {16, 0x7C00, 0x3E0, 0x1F, 0}};
    const Layout* hit = nullptr;
    for (const Layout& l : kLayouts)
      if (l.bits == b && l.r == masks[0] && l.g == masks[1] && l.b == masks[2] &&
          (b != 32 || l.a == masks[3]))
        hit = &l;
    if (!hit) return kRefused;
    if (b == 16) h->raw = hit->g == 0x7E0 ? kBgr16 : kBgr15;
    if (b == 32 && hit->r) {
      const uint32_t m[3] = {hit->r, hit->g, hit->b};
      for (int c = 0; c < 3; ++c) {
        int k = 0;
        while (!((m[c] >> (8 * k)) & 1)) ++k;
        h->byte_of[c] = k;
      }
    }
  } else if (h->compression == 1 || h->compression == 2) {
    h->rle = true;
    h->rle4 = h->compression == 2;
  } else if (h->compression != 0) {
    return kRefused;  // JPEG, PNG and ALPHABITFIELDS payloads: Pillow reads none
  }
  h->palette.assign(256 * 3, 0);
  if (b <= 8) {
    if (colors > 65536) return kRefused;
    const size_t want = static_cast<size_t>(colors) * padding;
    const size_t got = std::min(want, len - std::min(len, pos));
    const uint8_t* p = d + pos;
    bool gray = got == want;
    for (uint64_t i = 0; gray && i < (colors == 2 ? 2 : colors); ++i) {
      const int v = colors == 2 ? (i ? 255 : 0) : static_cast<int>(i);
      const uint8_t* e = p + i * padding;
      gray = e[0] == v && e[1] == v && e[2] == v;
    }
    if (gray) {
      h->raw = colors == 2 ? kBits1 : kGray8;
      for (int i = 0; i < 256; ++i) h->palette[3 * i] = h->palette[3 * i + 1] =
          h->palette[3 * i + 2] = static_cast<uint8_t>(i);
      if (colors == 2) h->palette[3] = h->palette[4] = h->palette[5] = 255;
    } else {
      for (size_t i = 0; i < 256 && (i + 1) * padding <= got; ++i)
        for (int c = 0; c < 3; ++c) h->palette[3 * i + c] = p[i * padding + 2 - c];
    }
  }
  if (h->rle && h->raw != kPal4 && h->raw != kPal8 && h->raw != kPal1 && h->raw != kGray8)
    return kRefused;  // run-length data of a mode Pillow's raw "P" cannot fill
  if (h->rle && h->raw == kBits1) return kRefused;
  return kOk;
}

// One raw row to RGB.
void row_to_rgb(const Header& h, const uint8_t* row, int64_t w, uint8_t* o) {
  const uint8_t* pal = h.palette.data();
  for (int64_t x = 0; x < w; ++x, o += 3) {
    switch (h.raw) {
      case kPal1:
      case kBits1: {
        const int i = (row[x >> 3] >> (7 - (x & 7))) & 1;
        std::memcpy(o, pal + 3 * i, 3);
        break;
      }
      case kPal4: {
        const int i = (row[x >> 1] >> (x & 1 ? 0 : 4)) & 15;
        std::memcpy(o, pal + 3 * i, 3);
        break;
      }
      case kPal8:
      case kGray8:
        std::memcpy(o, pal + 3 * row[x], 3);
        break;
      case kBgr15:
      case kBgr16: {
        const int p = row[2 * x] | (row[2 * x + 1] << 8);
        o[2] = static_cast<uint8_t>((p & 31) * 255 / 31);
        if (h.raw == kBgr15) {
          o[1] = static_cast<uint8_t>(((p >> 5) & 31) * 255 / 31);
          o[0] = static_cast<uint8_t>(((p >> 10) & 31) * 255 / 31);
        } else {
          o[1] = static_cast<uint8_t>(((p >> 5) & 63) * 255 / 63);
          o[0] = static_cast<uint8_t>(((p >> 11) & 31) * 255 / 31);
        }
        break;
      }
      case kBgr24:
        o[0] = row[3 * x + 2];
        o[1] = row[3 * x + 1];
        o[2] = row[3 * x];
        break;
      case kBytes32:
        for (int c = 0; c < 3; ++c) o[c] = row[4 * x + h.byte_of[c]];
        break;
    }
  }
}

int bits_per_pixel(Raw r, int file_bits) {
  return r == kBits1 ? 1 : r == kGray8 ? 8 : file_bits;
}

// Pillow's BmpRleDecoder: the indices of xsize * ysize pixels in file row
// order, or kCorrupt where Pillow's decode stops short or raises.
int rle_indices(const uint8_t* d, size_t len, const Header& h, std::vector<uint8_t>& data) {
  const int64_t xs = h.width;
  const int64_t dest = h.width * h.height;
  data.clear();
  data.reserve(static_cast<size_t>(dest));
  size_t pos = static_cast<size_t>(std::min<int64_t>(h.offset, int64_t(len)));
  int64_t x = 0;
  while (static_cast<int64_t>(data.size()) < dest) {
    if (pos + 2 > len) break;
    int64_t n = d[pos];
    const int byte = d[pos + 1];
    pos += 2;
    if (n) {
      if (x + n > xs) n = std::max<int64_t>(0, xs - x);
      for (int64_t i = 0; i < n; ++i)
        data.push_back(static_cast<uint8_t>(h.rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte));
      x += n;
    } else if (byte == 0) {  // end of line
      while (data.size() % xs) data.push_back(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: Pillow reads two pairs and takes the second
      if (pos + 2 > len) break;
      pos += 2;
      if (pos + 2 > len) return kCorrupt;
      const int right = d[pos], up = d[pos + 1];
      pos += 2;
      data.insert(data.end(), static_cast<size_t>(right + up * xs), 0);
      x = static_cast<int64_t>(data.size() % xs);
    } else {  // absolute run
      const size_t want = h.rle4 ? byte / 2 : byte;
      const size_t got = std::min(want, len - pos);
      for (size_t i = 0; i < got; ++i) {
        const int v = d[pos + i];
        if (h.rle4) {
          data.push_back(static_cast<uint8_t>(v >> 4));
          data.push_back(static_cast<uint8_t>(v & 15));
        } else {
          data.push_back(static_cast<uint8_t>(v));
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) ++pos;  // a 16-bit boundary of the file offset
    }
  }
  return static_cast<int64_t>(data.size()) >= dest ? kOk : kCorrupt;
}

int decode_bmp(const uint8_t* d, size_t len, int w_expect, int h_expect, uint8_t* out) {
  Header h;
  int rc = parse(d, len, &h);
  if (rc != kOk) return rc;
  if (h.width != w_expect || h.height != h_expect) return kCorrupt;
  const int64_t w = h.width, hh = h.height;
  if (h.rle) {
    std::vector<uint8_t> idx;
    rc = rle_indices(d, len, h, idx);
    if (rc != kOk) return rc;
    for (int64_t r = 0; r < hh; ++r) {
      const int64_t y = h.top_down ? r : hh - 1 - r;
      uint8_t* o = out + y * w * 3;
      for (int64_t x = 0; x < w; ++x)
        std::memcpy(o + 3 * x, h.palette.data() + 3 * idx[r * w + x], 3);
    }
    return kOk;
  }
  const int bpp = bits_per_pixel(h.raw, h.bits);
  const size_t need = static_cast<size_t>((w * bpp + 7) / 8);
  const size_t stride = static_cast<size_t>(((w * h.bits + 31) >> 3) & ~int64_t(3));
  if (need > stride) return kRefused;  // Pillow's raw decoder refuses a row past its stride
  if (h.offset < 0 || static_cast<size_t>(h.offset) > len) return kCorrupt;
  const size_t avail = len - static_cast<size_t>(h.offset);
  // the last row needs only its pixels' bytes, as Pillow's raw decoder reads
  if (avail < stride * static_cast<size_t>(hh - 1) + need) return kCorrupt;
  const uint8_t* base = d + h.offset;
  for (int64_t r = 0; r < hh; ++r) {
    const int64_t y = h.top_down ? r : hh - 1 - r;
    row_to_rgb(h, base + r * stride, w, out + y * w * 3);
  }
  return kOk;
}

}  // namespace

extern "C" {

// The image's width and height from its headers.  Returns 0 on success.
int fsvlm_bmp_size(const uint8_t* data, long len, int* w, int* h) {
  return guarded([&] {
    Header hd;
    const int rc = parse(data, static_cast<size_t>(len), &hd);
    if (rc != kOk) return rc;
    *w = static_cast<int>(hd.width);
    *h = static_cast<int>(hd.height);
    return static_cast<int>(kOk);
  });
}

// Full-resolution RGB into `out` (w * h * 3 bytes, w and h from
// fsvlm_bmp_size).  Returns 0 on success.
int fsvlm_bmp_decode_full(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  return guarded([&] { return decode_bmp(data, static_cast<size_t>(len), w, h, out); });
}

}  // extern "C"
