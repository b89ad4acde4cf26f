// The port's PNG decoder: the whole of PNG (every colour type and bit depth
// of the specification, plain and Adam7) with no library, its output
// byte-equal to Pillow's Image.open(path).convert("RGB").
//
//  - Inflate (RFC 1950/1951) is written here: stored, fixed-Huffman and
//    dynamic-Huffman blocks, the zlib header and the Adler-32 checked.  The
//    code tables follow zlib's rules: an over-subscribed set is corrupt, an
//    incomplete one only where it has a single code of length 1.
//  - Chunks: IHDR, PLTE and IDAT (one stream over any number of IDAT
//    chunks, empty ones included), IEND; tRNS and every ancillary chunk
//    (gAMA, iCCP, sRGB, text, APNG's acTL/fcTL/fdAT, ...) are skipped, as
//    Pillow's convert("RGB") applies none of them and shows an APNG's
//    default image.  The CRC of the critical chunks is checked.  A missing
//    IEND after a complete image stream is accepted, as Pillow accepts it.
//  - The five filters per scanline and per Adam7 pass, with the filter's
//    bytes per pixel at least 1 at bit depths below 8.
//  - Conversion to RGB as Pillow makes it (its PNG rawmodes, then convert):
//    gray at 1/2/4 bits scaled to 0/255, x85 and x17; 16-bit gray (mode
//    I;16) clipped to 255, not shifted; 16-bit RGB, RGBA and gray+alpha
//    take the high byte; alpha and tRNS dropped; a palette index past a
//    short PLTE gives (0, 0, 0).
//
// Every call is reentrant and allocates its own buffers, so a Python thread
// pool decodes in parallel (ctypes releases the GIL around the call).
// Corrupt or truncated data returns kCorrupt, a compression, filter or
// interlace method outside the specification kUnsupported, and an image of
// more pixels than twice Pillow's MAX_IMAGE_PIXELS kTooLarge; nothing is
// guessed.
//
// Its inflate is also fsvlm::zlib_inflate (host_common.h), which the TIFF
// decoder's Deflate strips use.
//
// Build: compiled with the other decoders and csrc/imaging.cpp into one
// library by fsvlm_tpu_torch/native.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "host_common.h"

namespace {

enum Status {
  kOk = 0,
  kCorrupt = 2,      // malformed or truncated data
  kUnsupported = 3,  // a method the PNG specification does not define
  kNotPng = 4,       // no PNG signature
  kNoMemory = 5,     // an allocation failed
  kTooLarge = 6,     // more than kMaxPixels pixels
};

// Pillow refuses an image of more than twice Image.MAX_IMAGE_PIXELS as a
// decompression bomb, so the JAX package reads none: neither does this
// decoder, which keeps a corrupt header from sizing its buffers.
constexpr int64_t kMaxPixels = 2 * int64_t(89478485);
constexpr uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

// ------------------------------------------------------------------ CRC-32
struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      t[n] = c;
    }
  }
};
const CrcTable kCrc;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) c = kCrc.t[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// ------------------------------------------------------------------ inflate
constexpr int kMaxBits = 15;
constexpr int kFastBits = 10;

// A canonical Huffman code: a kFastBits lookup table (symbol << 4 | length,
// 0 where the code is longer or absent) and, for longer codes, the counts
// and sorted symbols of puff's bit-by-bit decode.
struct Huffman {
  uint16_t fast[1 << kFastBits];
  uint16_t count[kMaxBits + 1];
  uint16_t symbol[320];
};

enum class CodeKind { kCodes, kLens, kDists };

// Builds `h` from the code lengths; false for a set zlib refuses.
bool build_huffman(Huffman& h, const uint8_t* lengths, int n, CodeKind kind) {
  std::memset(h.count, 0, sizeof(h.count));
  for (int s = 0; s < n; ++s) h.count[lengths[s]]++;
  int max = 0;
  for (int len = kMaxBits; len >= 1; --len)
    if (h.count[len]) {
      max = len;
      break;
    }
  std::memset(h.fast, 0, sizeof(h.fast));
  if (max == 0) return kind != CodeKind::kCodes;  // no codes: any symbol is an error
  int left = 1;
  for (int len = 1; len <= kMaxBits; ++len) {
    left <<= 1;
    left -= h.count[len];
    if (left < 0) return false;  // over-subscribed
  }
  if (left > 0 && (kind == CodeKind::kCodes || max != 1)) return false;  // incomplete
  uint16_t offs[kMaxBits + 2];
  offs[1] = 0;
  for (int len = 1; len <= kMaxBits; ++len) offs[len + 1] = offs[len] + h.count[len];
  h.count[0] = 0;
  int next_code[kMaxBits + 2];
  int code = 0;
  for (int len = 1; len <= kMaxBits; ++len) {
    code = (code + h.count[len - 1]) << 1;
    next_code[len] = code;
  }
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    h.symbol[offs[len]++] = static_cast<uint16_t>(s);
    const int c = next_code[len]++;
    if (len <= kFastBits) {
      int rev = 0;
      for (int i = 0; i < len; ++i) rev |= ((c >> i) & 1) << (len - 1 - i);
      for (int i = rev; i < (1 << kFastBits); i += 1 << len)
        h.fast[i] = static_cast<uint16_t>((s << 4) | len);
    }
  }
  return true;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kCodeOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// A zlib stream into a buffer of exactly `cap` bytes: the image's filtered
// scanlines, whose size the header fixes.  Output past it is corrupt, but
// with `prefix` (zlib's inflate into a full output buffer, as libtiff's
// ZIPDecode calls it): the stream stops there, whatever follows.
class Inflater {
 public:
  Inflater(const uint8_t* in, size_t n, uint8_t* out, size_t cap, bool prefix = false)
      : p_(in), end_(in + n), out_(out), cap_(cap), prefix_(prefix) {}

  int run() {
    if (end_ - p_ < 2) return kCorrupt;
    const int cmf = p_[0], flg = p_[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0 || (flg & 0x20))
      return kCorrupt;  // not deflate, window past 32K, bad check bits, preset dictionary
    p_ += 2;
    for (bool last = false; !last;) {
      if (!need(3)) return kCorrupt;
      last = bits(1);
      const int type = static_cast<int>(bits(2));
      int rc;
      if (type == 0)
        rc = stored();
      else if (type == 1)
        rc = fixed();
      else if (type == 2)
        rc = dynamic();
      else
        rc = kCorrupt;
      if (rc == kFull) return kOk;
      if (rc != kOk) return rc;
    }
    // the Adler-32 of the output, big-endian, after the byte boundary
    bitbuf_ >>= bitcnt_ & 7;
    bitcnt_ -= bitcnt_ & 7;
    uint32_t want = 0;
    for (int i = 0; i < 4; ++i) {
      if (!need(8)) return kCorrupt;
      want = (want << 8) | static_cast<uint32_t>(bits(8));
    }
    return adler32() == want ? kOk : kCorrupt;
  }

  size_t produced() const { return pos_; }

 private:
  bool need(int n) {
    while (bitcnt_ < n) {
      if (p_ == end_) return false;
      bitbuf_ |= uint64_t(*p_++) << bitcnt_;
      bitcnt_ += 8;
    }
    return true;
  }
  void refill() {
    while (bitcnt_ <= 56 && p_ != end_) {
      bitbuf_ |= uint64_t(*p_++) << bitcnt_;
      bitcnt_ += 8;
    }
  }
  uint64_t bits(int n) {  // after need(n)
    const uint64_t v = bitbuf_ & ((uint64_t(1) << n) - 1);
    bitbuf_ >>= n;
    bitcnt_ -= n;
    return v;
  }

  // The next symbol of `h`, or -1 for a missing code or truncated input.
  int decode(const Huffman& h) {
    if (bitcnt_ < kMaxBits) refill();
    const uint16_t e = h.fast[bitbuf_ & ((1u << kFastBits) - 1)];
    if (e) {
      const int len = e & 15;
      if (len > bitcnt_) return -1;
      bitbuf_ >>= len;
      bitcnt_ -= len;
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxBits; ++len) {
      if (len > bitcnt_) return -1;
      code |= static_cast<int>((bitbuf_ >> (len - 1)) & 1);
      const int count = h.count[len];
      if (code - count < first) {
        bitbuf_ >>= len;
        bitcnt_ -= len;
        return h.symbol[index + (code - first)];
      }
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    return -1;
  }

  int stored() {
    bitbuf_ >>= bitcnt_ & 7;
    bitcnt_ -= bitcnt_ & 7;
    if (!need(32)) return kCorrupt;
    const uint32_t len = static_cast<uint32_t>(bits(16));
    const uint32_t nlen = static_cast<uint32_t>(bits(16));
    if ((len ^ 0xffffu) != nlen) return kCorrupt;
    // bytes still in the bit buffer come first (at most 4 after need(32))
    uint32_t k = 0;
    for (; k < len && bitcnt_ >= 8; ++k) {
      if (pos_ == cap_) return prefix_ ? kFull : kCorrupt;
      out_[pos_++] = static_cast<uint8_t>(bits(8));
    }
    size_t rest = len - k;
    bool full = false;
    if (prefix_ && cap_ - pos_ < rest) {
      rest = cap_ - pos_;
      full = true;
    }
    if (static_cast<size_t>(end_ - p_) < rest || cap_ - pos_ < rest) return kCorrupt;
    std::memcpy(out_ + pos_, p_, rest);
    pos_ += rest;
    p_ += rest;
    return full ? kFull : kOk;
  }

  int fixed() {
    static const struct Tables {
      Huffman lit, dist;
      Tables() {
        uint8_t l[288];
        for (int i = 0; i < 144; ++i) l[i] = 8;
        for (int i = 144; i < 256; ++i) l[i] = 9;
        for (int i = 256; i < 280; ++i) l[i] = 7;
        for (int i = 280; i < 288; ++i) l[i] = 8;
        build_huffman(lit, l, 288, CodeKind::kLens);
        uint8_t d[32];  // 30 and 31 take codes but are invalid, as in zlib
        std::fill(d, d + 32, 5);
        build_huffman(dist, d, 32, CodeKind::kDists);
      }
    } tables;
    return codes(tables.lit, tables.dist);
  }

  int dynamic() {
    if (!need(14)) return kCorrupt;
    const int nlen = static_cast<int>(bits(5)) + 257;
    const int ndist = static_cast<int>(bits(5)) + 1;
    const int ncode = static_cast<int>(bits(4)) + 4;
    if (nlen > 286 || ndist > 30) return kCorrupt;
    uint8_t lengths[320] = {0};
    for (int i = 0; i < ncode; ++i) {
      if (!need(3)) return kCorrupt;
      lengths[kCodeOrder[i]] = static_cast<uint8_t>(bits(3));
    }
    Huffman lencode;
    if (!build_huffman(lencode, lengths, 19, CodeKind::kCodes)) return kCorrupt;
    std::memset(lengths, 0, sizeof(lengths));
    for (int i = 0; i < nlen + ndist;) {
      const int sym = decode(lencode);
      if (sym < 0) return kCorrupt;
      if (sym < 16) {
        lengths[i++] = static_cast<uint8_t>(sym);
        continue;
      }
      int len = 0, rep;
      if (sym == 16) {
        if (i == 0) return kCorrupt;
        len = lengths[i - 1];
        if (!need(2)) return kCorrupt;
        rep = 3 + static_cast<int>(bits(2));
      } else if (sym == 17) {
        if (!need(3)) return kCorrupt;
        rep = 3 + static_cast<int>(bits(3));
      } else {
        if (!need(7)) return kCorrupt;
        rep = 11 + static_cast<int>(bits(7));
      }
      if (i + rep > nlen + ndist) return kCorrupt;
      while (rep--) lengths[i++] = static_cast<uint8_t>(len);
    }
    if (lengths[256] == 0) return kCorrupt;  // no end-of-block code
    Huffman lit, dist;
    if (!build_huffman(lit, lengths, nlen, CodeKind::kLens)) return kCorrupt;
    if (!build_huffman(dist, lengths + nlen, ndist, CodeKind::kDists)) return kCorrupt;
    return codes(lit, dist);
  }

  int codes(const Huffman& lit, const Huffman& dist) {
    for (;;) {
      int sym = decode(lit);
      if (sym < 0) return kCorrupt;
      if (sym < 256) {
        if (pos_ == cap_) return prefix_ ? kFull : kCorrupt;
        out_[pos_++] = static_cast<uint8_t>(sym);
        continue;
      }
      if (sym == 256) return kOk;
      sym -= 257;
      if (sym >= 29) return kCorrupt;
      if (!need(kLenExtra[sym])) return kCorrupt;
      const size_t len = kLenBase[sym] + bits(kLenExtra[sym]);
      const int ds = decode(dist);
      if (ds < 0 || ds >= 30) return kCorrupt;
      if (!need(kDistExtra[ds])) return kCorrupt;
      const size_t d = kDistBase[ds] + bits(kDistExtra[ds]);
      if (d > pos_ || (len > cap_ - pos_ && !prefix_)) return kCorrupt;
      const size_t n = std::min(len, cap_ - pos_);
      uint8_t* o = out_ + pos_;
      const uint8_t* s = o - d;
      for (size_t i = 0; i < n; ++i) o[i] = s[i];  // overlapping copies repeat
      pos_ += n;
      if (n < len) return kFull;
    }
  }

  uint32_t adler32() const {
    uint32_t a = 1, b = 0;
    size_t i = 0;
    while (i < pos_) {
      const size_t stop = std::min(pos_, i + 5552);
      for (; i < stop; ++i) {
        a += out_[i];
        b += a;
      }
      a %= 65521;
      b %= 65521;
    }
    return (b << 16) | a;
  }

  const uint8_t* p_;
  const uint8_t* end_;
  uint8_t* out_;
  size_t cap_;
  size_t pos_ = 0;
  bool prefix_;
  static constexpr int kFull = 100;  // the output filled in prefix mode
  uint64_t bitbuf_ = 0;
  int bitcnt_ = 0;
};

// ------------------------------------------------------------------ PNG
struct Header {
  int width = 0, height = 0, depth = 0, color = 0, interlace = 0;
  int channels = 0;
};

// (x0, y0, dx, dy) of the 7 Adam7 passes; a plain image is one pass (0, 0, 1, 1)
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

int channels_of(int color, int depth) {
  switch (color) {
    case 0:
      return (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16) ? 1 : 0;
    case 2:
      return (depth == 8 || depth == 16) ? 3 : 0;
    case 3:
      return (depth == 1 || depth == 2 || depth == 4 || depth == 8) ? 1 : 0;
    case 4:
      return (depth == 8 || depth == 16) ? 2 : 0;
    case 6:
      return (depth == 8 || depth == 16) ? 4 : 0;
    default:
      return 0;
  }
}

// The signature and IHDR (the first chunk, its CRC checked).
int parse_header(const uint8_t* data, size_t len, Header* h) {
  if (len < 8 || std::memcmp(data, kSignature, 8) != 0) return kNotPng;
  if (len < 8 + 8 + 13 + 4) return kCorrupt;
  const uint8_t* c = data + 8;
  if (be32(c) != 13 || std::memcmp(c + 4, "IHDR", 4) != 0) return kCorrupt;
  if (crc32(c + 4, 4 + 13) != be32(c + 8 + 13)) return kCorrupt;
  const uint8_t* d = c + 8;
  const uint32_t w = be32(d), ht = be32(d + 4);
  h->depth = d[8];
  h->color = d[9];
  if (w == 0 || ht == 0 || w > 0x7fffffffu || ht > 0x7fffffffu) return kCorrupt;
  h->channels = channels_of(h->color, h->depth);
  if (!h->channels) return kCorrupt;  // a colour type or bit depth PNG does not define
  if (d[10] != 0 || d[11] != 0 || d[12] > 1) return kUnsupported;
  if (int64_t(w) * int64_t(ht) > kMaxPixels) return kTooLarge;
  h->width = static_cast<int>(w);
  h->height = static_cast<int>(ht);
  h->interlace = d[12];
  return kOk;
}

size_t row_bytes(const Header& h, int64_t width) {
  return static_cast<size_t>((width * h.channels * h.depth + 7) / 8);
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undoes the filter of one scanline in place; `prev` is the unfiltered row
// above (nullptr for the first row of a pass).
bool unfilter(int type, uint8_t* row, const uint8_t* prev, size_t n, size_t bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
      return true;
    case 2:
      if (prev)
        for (size_t i = 0; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        const int a = i >= bpp ? row[i - bpp] : 0, b = prev ? prev[i] : 0;
        row[i] = static_cast<uint8_t>(row[i] + ((a + b) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        const int a = i >= bpp ? row[i - bpp] : 0, b = prev ? prev[i] : 0;
        const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
        row[i] = static_cast<uint8_t>(row[i] + paeth(a, b, c));
      }
      return true;
    default:
      return false;
  }
}

// One unfiltered scanline of `count` pixels to RGB, pixel k at out + k * step.
void row_to_rgb(const Header& h, const uint8_t* row, int count, const uint8_t* plte, int plte_n,
                uint8_t* out, size_t step) {
  const int depth = h.depth;
  for (int k = 0; k < count; ++k, out += step) {
    uint8_t r, g, b;
    if (depth < 8) {
      const int bit = k * depth;
      const int v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
      if (h.color == 3) {
        if (v < plte_n) {
          r = plte[3 * v];
          g = plte[3 * v + 1];
          b = plte[3 * v + 2];
        } else {
          r = g = b = 0;
        }
      } else {
        r = g = b = static_cast<uint8_t>(depth == 1 ? v * 255 : depth == 2 ? v * 85 : v * 17);
      }
    } else if (depth == 8) {
      const uint8_t* s = row + static_cast<size_t>(k) * h.channels;
      switch (h.color) {
        case 0:
        case 4:
          r = g = b = s[0];
          break;
        case 3:
          if (s[0] < plte_n) {
            r = plte[3 * s[0]];
            g = plte[3 * s[0] + 1];
            b = plte[3 * s[0] + 2];
          } else {
            r = g = b = 0;
          }
          break;
        default:  // 2, 6
          r = s[0];
          g = s[1];
          b = s[2];
      }
    } else {  // 16 bits
      const uint8_t* s = row + static_cast<size_t>(k) * h.channels * 2;
      if (h.color == 0) {  // Pillow's I;16 -> RGB clips
        r = g = b = s[0] ? 255 : s[1];
      } else if (h.color == 4) {
        r = g = b = s[0];
      } else {
        r = s[0];
        g = s[2];
        b = s[4];
      }
    }
    out[0] = r;
    out[1] = g;
    out[2] = b;
  }
}

int decode_png(const uint8_t* data, size_t len, int w, int h_expect, uint8_t* out) {
  Header h;
  int rc = parse_header(data, len, &h);
  if (rc != kOk) return rc;
  if (h.width != w || h.height != h_expect) return kCorrupt;
  // the chunks after IHDR: PLTE and the IDAT stream; IEND ends them
  uint8_t plte[256 * 3];
  int plte_n = 0;
  bool have_plte = false;
  std::vector<uint8_t> zdata;
  bool idat_done = false, in_idat = false;
  size_t pos = 8 + 8 + 13 + 4;
  while (true) {
    if (len - pos < 8) {
      if (idat_done || in_idat) break;  // no IEND after the image data: as Pillow
      return kCorrupt;
    }
    const uint32_t n = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    if (n > 0x7fffffffu) return kCorrupt;
    const bool whole = len - pos - 8 >= size_t(n) + 4;
    const bool critical = !(type[0] & 0x20);
    if (std::memcmp(type, "IEND", 4) == 0) {
      if (whole && crc32(type, 4 + n) != be32(type + 4 + n)) return kCorrupt;
      break;
    }
    if (!whole) return kCorrupt;
    const uint8_t* body = type + 4;
    const bool known = !std::memcmp(type, "IDAT", 4) || !std::memcmp(type, "PLTE", 4) ||
                       !std::memcmp(type, "IHDR", 4);
    if (critical && known && crc32(type, 4 + n) != be32(body + n)) return kCorrupt;
    if (!std::memcmp(type, "IDAT", 4)) {
      if (idat_done) return kCorrupt;  // IDAT chunks must be consecutive
      in_idat = true;
      zdata.insert(zdata.end(), body, body + n);
    } else {
      if (in_idat) {
        in_idat = false;
        idat_done = true;
      }
      if (!std::memcmp(type, "IHDR", 4)) return kCorrupt;
      if (!std::memcmp(type, "PLTE", 4)) {
        if (have_plte || idat_done || n % 3 != 0 || n == 0 || n > 256 * 3) return kCorrupt;
        std::memcpy(plte, body, n);
        plte_n = static_cast<int>(n / 3);
        have_plte = true;
      }
      // tRNS and the ancillary chunks: skipped (convert("RGB") drops them)
    }
    pos += 8 + size_t(n) + 4;
  }
  if (zdata.empty() && !idat_done && !in_idat) return kCorrupt;
  if (h.color == 3 && !have_plte) return kCorrupt;

  // the filtered scanlines of every pass
  const int passes = h.interlace ? 7 : 1;
  static const int kPlain[1][4] = {{0, 0, 1, 1}};
  const int(*geom)[4] = h.interlace ? kAdam7 : kPlain;
  size_t total = 0;
  for (int p = 0; p < passes; ++p) {
    const int64_t pw = (int64_t(h.width) - geom[p][0] + geom[p][2] - 1) / geom[p][2];
    const int64_t ph = (int64_t(h.height) - geom[p][1] + geom[p][3] - 1) / geom[p][3];
    if (pw > 0 && ph > 0) total += static_cast<size_t>(ph) * (1 + row_bytes(h, pw));
  }
  std::vector<uint8_t> raw(total);
  Inflater inf(zdata.data(), zdata.size(), raw.data(), total);
  rc = inf.run();
  if (rc != kOk) return rc;
  if (inf.produced() != total) return kCorrupt;

  const size_t bpp = std::max<size_t>(1, size_t(h.channels) * h.depth / 8);
  uint8_t* cur = raw.data();
  for (int p = 0; p < passes; ++p) {
    const int x0 = geom[p][0], y0 = geom[p][1], dx = geom[p][2], dy = geom[p][3];
    const int64_t pw = (int64_t(h.width) - x0 + dx - 1) / dx;
    const int64_t ph = (int64_t(h.height) - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t rb = row_bytes(h, pw);
    const uint8_t* prev = nullptr;
    for (int64_t r = 0; r < ph; ++r) {
      uint8_t* row = cur + 1;
      if (!unfilter(cur[0], row, prev, rb, bpp)) return kCorrupt;
      uint8_t* o = out + ((static_cast<size_t>(y0 + r * dy) * h.width) + x0) * 3;
      row_to_rgb(h, row, static_cast<int>(pw), plte, plte_n, o, size_t(dx) * 3);
      prev = row;
      cur += 1 + rb;
    }
  }
  return kOk;
}

template <class F>
int guarded(F body) {
  try {
    return body();
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kCorrupt;
  }
}

}  // namespace

int fsvlm::zlib_inflate(const uint8_t* in, size_t n, uint8_t* out, size_t cap,
                        size_t* produced, bool prefix) {
  return guarded([&] {
    Inflater inf(in, n, out, cap, prefix);
    const int rc = inf.run();
    *produced = inf.produced();
    return rc;
  });
}

extern "C" {

// The image's width and height from its IHDR.  Returns 0 on success.
int fsvlm_png_size(const uint8_t* data, long len, int* w, int* h) {
  return guarded([&] {
    Header hd;
    const int rc = parse_header(data, static_cast<size_t>(len), &hd);
    if (rc != kOk) return rc;
    *w = hd.width;
    *h = hd.height;
    return static_cast<int>(kOk);
  });
}

// Full-resolution RGB into `out` (w * h * 3 bytes, w and h from
// fsvlm_png_size).  Returns 0 on success.
int fsvlm_png_decode_full(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  return guarded([&] { return decode_png(data, static_cast<size_t>(len), w, h, out); });
}

}  // extern "C"
