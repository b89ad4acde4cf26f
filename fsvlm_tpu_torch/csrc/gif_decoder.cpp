// The port's GIF decoder: the first frame, with no library, its output
// byte-equal to Pillow 12.1's Image.open(path).convert("RGB") under its
// default LOADING_STRATEGY (GifImagePlugin and GifDecode.c):
//
//  - The logical screen, grown to cover a first frame that runs past it;
//    the frame's rectangle filled from its LZW data, the rest of the screen
//    with the frame's transparent index, or index 0 where it has none.
//  - The frame's local colour table, else the global one; a table of
//    i -> (i, i, i) throughout is no palette (mode L, the index is the
//    gray); an index past a table is black.  A transparent index keeps its
//    colour, as convert("RGB") drops transparency.
//  - GIF's LZW as Pillow decodes it: minimum code size 0-12, a clear code
//    right after a clear ignored, codes up to 12 bits, a full table used
//    without a clear code, the data read by sub-blocks; interlaced frames
//    in their four passes; decoding stops when the frame's last pixel is
//    written.
//
// A frame whose data ends before its last pixel, an invalid code, and
// truncated data return kCorrupt; a file with no frame kCorrupt; an image
// of more pixels than twice Pillow's MAX_IMAGE_PIXELS kTooLarge.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

struct Frame {
  int64_t width = 0, height = 0;  // of the image, grown to cover the frame
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  bool interlace = false;
  int transparency = -1;
  bool palette = false;        // mode P (else L)
  uint8_t rgb[256 * 3] = {0};  // the frame's table, black past its entries
  int min_code = 0;
  size_t data = 0;  // offset of the first sub-block
};

// GifImageFile._is_palette_needed (a table cut short by the file's end
// counts as needed)
bool palette_needed(const uint8_t* p, size_t n) {
  if (n % 3) return true;
  for (size_t i = 0; i < n; i += 3)
    if (!(static_cast<int>(i / 3) == p[i] && p[i] == p[i + 1] && p[i + 1] == p[i + 2]))
      return true;
  return false;
}

int parse(const uint8_t* d, size_t len, Frame* f) {
  if (len < 13 || std::memcmp(d, "GIF8", 4) != 0 || (d[4] != '7' && d[4] != '9') ||
      d[5] != 'a')
    return kCorrupt;
  f->width = le16(d + 6);
  f->height = le16(d + 8);
  if (too_large(f->width, f->height)) return kTooLarge;
  size_t pos = 13;
  const uint8_t* global = nullptr;
  size_t global_n = 0;
  if (d[10] & 128) {
    const size_t n = size_t(3) << ((d[10] & 7) + 1);
    global_n = std::min(n, len - pos);
    if (palette_needed(d + pos, global_n)) global = d + pos;
    pos += global_n;
  }
  // GifImageFile.data: one sub-block, or none at a zero size or the end
  auto sub_block = [&](const uint8_t** p, size_t* n) {
    if (pos >= len || d[pos] == 0) {
      if (pos < len) ++pos;
      return false;
    }
    const size_t k = d[pos++];
    *p = d + pos;
    *n = std::min(k, len - pos);
    pos += *n;
    return true;
  };
  const uint8_t* table = global;
  size_t table_n = global_n;
  for (;;) {
    if (pos >= len || d[pos] == ';') return kCorrupt;  // no frame
    const int s = d[pos++];
    if (s == '!') {
      if (pos >= len) return kCorrupt;
      const int label = d[pos++];
      const uint8_t* b;
      size_t n;
      bool got = sub_block(&b, &n);
      if (label == 254) {  // a comment: its blocks through the terminator
        while (got) got = sub_block(&b, &n);
        continue;
      }
      if (label == 249 && got) {
        if (n < 3 || ((b[0] & 1) && n < 4)) return kCorrupt;
        if (b[0] & 1) f->transparency = b[3];
      } else if (label == 255 && got && n >= 11 && std::memcmp(b, "NETSCAPE2.0", 11) == 0) {
        sub_block(&b, &n);
      }
      while (sub_block(&b, &n)) {
      }
    } else if (s == ',') {
      if (pos + 9 > len) return kCorrupt;
      const uint8_t* im = d + pos;
      pos += 9;
      f->x0 = le16(im);
      f->y0 = le16(im + 2);
      f->x1 = f->x0 + le16(im + 4);
      f->y1 = f->y0 + le16(im + 6);
      if (f->x1 > f->width || f->y1 > f->height) {
        f->width = std::max(f->x1, f->width);
        f->height = std::max(f->y1, f->height);
        if (too_large(f->width, f->height)) return kTooLarge;
      }
      const int flags = im[8];
      f->interlace = (flags & 64) != 0;
      if (flags & 128) {
        const size_t n = std::min(size_t(3) << ((flags & 7) + 1), len - pos);
        table = palette_needed(d + pos, n) ? d + pos : nullptr;
        table_n = n;
        pos += n;
      }
      if (pos >= len) return kCorrupt;
      f->min_code = d[pos++];
      f->data = pos;
      break;
    }
    // any other byte is skipped, as Pillow skips it
  }
  f->palette = table != nullptr;
  if (table)
    for (size_t i = 0; i < 256 * 3 && i < table_n; ++i) f->rgb[i] = table[i];
  if (f->width == 0 || f->height == 0) return kRefused;
  return kOk;
}

// GifDecode.c over the frame's rectangle of `im` (width w).
int lzw(const uint8_t* d, size_t len, const Frame& f, uint8_t* im, int64_t w) {
  const int bits = f.min_code;
  if (bits < 0 || bits > 12) return kCorrupt;
  const int64_t xsize = f.x1 - f.x0, ysize = f.y1 - f.y0;
  if (xsize <= 0 || ysize <= 0) return kOk;
  constexpr int kTable = 4096;
  std::vector<uint8_t> data(kTable), buffer(kTable);
  std::vector<int> link(kTable);
  const int clear = 1 << bits, end = clear + 1;
  int next = 0, codesize = 0, codemask = 0, lastcode = 0, lastdata = 0;
  int state = 1;
  int step = f.interlace ? 8 : 1, interlace = f.interlace ? 1 : 0;
  int64_t x = 0, y = 0;
  size_t pos = f.data;
  int blocksize = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0;
  auto newline = [&]() {  // NEWLINE; false once the frame is complete
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1: y = 4; interlace = 2; break;
        case 2: step = 4; y = 2; interlace = 3; break;
        case 3: step = 2; y = 1; interlace = 0; break;
        default: return false;
      }
    }
    return true;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        if (pos >= len) return kCorrupt;
        bitbuffer |= static_cast<uint32_t>(d[pos++]) << bitcount;
        bitcount += 8;
        --blocksize;
      } else {
        // a new sub-block, whole or not at all; a zero size reads on
        if (pos >= len) return kCorrupt;
        const int c = d[pos];
        if (len - pos < static_cast<size_t>(c) + 1) return kCorrupt;
        blocksize = c;
        ++pos;
      }
    }
    int c = static_cast<int>(bitbuffer & static_cast<uint32_t>(codemask));
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) return kCorrupt;  // the data ends before the frame's last pixel
    // the code's string: its first byte, then the rest from the buffer,
    // which fills from its right end
    int bufferindex = kTable;
    if (state == 2) {
      if (c > clear) return kCorrupt;
      lastdata = lastcode = c;
      state = 3;
    } else {
      const int thiscode = c;
      if (c > next) return kCorrupt;
      if (c == next) {
        buffer[--bufferindex] = static_cast<uint8_t>(lastdata);
        c = lastcode;
      }
      while (c >= clear) {
        if (bufferindex <= 0 || c >= kTable) return kCorrupt;
        buffer[--bufferindex] = data[c];
        c = link[c];
      }
      lastdata = c;
      if (next < kTable) {
        data[next] = static_cast<uint8_t>(c);
        link[next] = lastcode;
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
    }
    for (int i = bufferindex - 1; i < kTable; ++i) {
      im[(f.y0 + y) * w + f.x0 + x] = i < bufferindex ? static_cast<uint8_t>(lastdata) : buffer[i];
      if (++x >= xsize && !newline()) return kOk;
    }
  }
}

int decode_gif(const uint8_t* d, size_t len, int w_expect, int h_expect, uint8_t* out) {
  Frame f;
  int rc = parse(d, len, &f);
  if (rc != kOk) return rc;
  if (f.width != w_expect || f.height != h_expect) return kCorrupt;
  const int64_t w = f.width, n = f.width * f.height;
  std::vector<uint8_t> im(static_cast<size_t>(n),
                          static_cast<uint8_t>(f.transparency >= 0 ? f.transparency : 0));
  rc = lzw(d, len, f, im.data(), w);
  if (rc != kOk) return rc;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* o = out + 3 * i;
    if (f.palette)
      std::memcpy(o, f.rgb + 3 * im[i], 3);
    else
      o[0] = o[1] = o[2] = im[i];
  }
  return kOk;
}

}  // namespace

extern "C" {

// The image's width and height: the logical screen grown to cover the
// first frame.  Returns 0 on success.
int fsvlm_gif_size(const uint8_t* data, long len, int* w, int* h) {
  return guarded([&] {
    Frame f;
    const int rc = parse(data, static_cast<size_t>(len), &f);
    if (rc != kOk) return rc;
    *w = static_cast<int>(f.width);
    *h = static_cast<int>(f.height);
    return static_cast<int>(kOk);
  });
}

// The first frame as RGB into `out` (w * h * 3 bytes, w and h from
// fsvlm_gif_size).  Returns 0 on success.
int fsvlm_gif_decode_full(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  return guarded([&] { return decode_gif(data, static_cast<size_t>(len), w, h, out); });
}

}  // extern "C"
