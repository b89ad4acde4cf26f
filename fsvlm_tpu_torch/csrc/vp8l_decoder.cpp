// The port's VP8L decoder: WebP's lossless codec, which is also the codec of
// a compressed ALPH chunk, with no library, decoding as libwebp 1.6.0's
// src/dec/vp8l_dec.c and src/dsp/lossless.c decode (Pillow 12.1 reads WebP
// through them):
//
//  - The bit reader reads least significant bit first.  Reading past the end
//    of the data is an error, where the data counts as at least 8 bytes long
//    (libwebp's 64-bit window holds zeros past a shorter stream).
//  - Prefix codes: the simple codes of one or two symbols, and the normal
//    ones through the code-length code (its 19 lengths in kCodeLengthOrder,
//    repeat codes 16-18, the optional count of lengths read).  A code is
//    valid with a single used symbol (read with no bit) or complete.  Five
//    codes per group (green + lengths + cache, red, blue, alpha, distance);
//    the level-0 image may pick a group per tile from its entropy image.
//  - LZ77: the 24 length and 40 distance prefix symbols, the 120 plane
//    codes of kPlaneDistance, a copy reaching before the first pixel or past
//    the last an error; the colour cache of 1-11 bits.
//  - The four transforms, each at most once, inverted in reverse order:
//    predictor (the 14 modes, modes 14 and 15 black, the top row from the
//    left and the left column from the top), cross-colour, subtract green,
//    and colour indexing with 1, 2 and 4-bit pixels packed into a byte
//    (a colour past the palette is transparent black).
//
// For an ALPH stream whose only transform is colour indexing, with no
// colour cache and single-symbol red, blue and alpha codes in its groups,
// libwebp decodes bytes (DecodeAlphaData) and accepts a stream whose last
// symbol runs past its end; that is kept too.

#include <cstdint>
#include <cstring>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40, kMaxCacheBits = 11;
constexpr int kMaxCodeLength = 15;
constexpr int kCodeLengthCodes = 19;
constexpr int kCodeLengthOrder[kCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                    7,  8,  9, 10, 11, 12, 13, 14, 15};
// The (dx, dy) offsets of distance codes 1-120: distance dx + dy * width.
constexpr int8_t kPlaneDistance[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

enum { kGreen = 0, kRed = 1, kBlue = 2, kAlpha = 3, kDist = 4 };
enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };

struct BitReader {
  const uint8_t* buf = nullptr;
  size_t len = 0;
  uint64_t pos = 0;    // bits consumed
  uint64_t limit = 0;  // bits readable: 8 * max(len, 8)

  void init(const uint8_t* d, size_t n) {
    buf = d;
    len = n;
    pos = 0;
    limit = 8 * static_cast<uint64_t>(n < 8 ? 8 : n);
  }
  bool over() const { return pos > limit; }
  // the next 56 or more bits, zeros past the data
  uint64_t window() const {
    const uint64_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= len) {
      for (int i = 7; i >= 0; --i) v = (v << 8) | buf[byte + i];
    } else {
      for (int i = 7; i >= 0; --i) v = (v << 8) | (byte + i < len ? buf[byte + i] : 0);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = static_cast<uint32_t>(window() & ((uint64_t(1) << n) - 1));
    pos += n;
    return v;
  }
};

// A canonical prefix code: symbols of lengths up to 8 from one table, the
// longer ones by the count of each length (as zlib's puff decodes).
struct PrefixCode {
  bool single = false;
  int symbol = 0;
  std::vector<uint32_t> fast;  // 256 entries: symbol | length << 16, 0 for a long code
  int count[kMaxCodeLength + 1] = {0};
  std::vector<uint16_t> sorted;

  int decode(BitReader* br) const {
    if (single) return symbol;
    const uint32_t bits = static_cast<uint32_t>(br->window());
    const uint32_t e = fast[bits & 0xff];
    if (e >> 16) {
      br->pos += e >> 16;
      return static_cast<int>(e & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code |= (bits >> (len - 1)) & 1;
      const int c = count[len];
      if (code - c < first) {
        br->pos += len;
        return sorted[index + (code - first)];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return 0;  // not reached: a built code is complete
  }
};

// libwebp's BuildHuffmanTable: lengths of at most 15, not all zero, one used
// symbol or a complete code.
bool build_code(const int* lengths, int n, PrefixCode* code) {
  int count[kMaxCodeLength + 1] = {0};
  int used = 0, last = 0;
  for (int s = 0; s < n; ++s) {
    if (lengths[s] < 0 || lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
    if (lengths[s]) {
      ++used;
      last = s;
    }
  }
  if (used == 0) return false;
  *code = PrefixCode();
  if (used == 1) {
    code->single = true;
    code->symbol = last;
    return true;
  }
  int64_t open = 1;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    open = 2 * open - count[len];
    if (open < 0) return false;
  }
  if (open != 0) return false;
  std::memcpy(code->count, count, sizeof(count));
  code->count[0] = 0;
  int offset[kMaxCodeLength + 2] = {0};
  for (int len = 1; len <= kMaxCodeLength; ++len) offset[len + 1] = offset[len] + count[len];
  code->sorted.assign(used, 0);
  // next[len]: the next canonical code of length len, in symbol order
  int next[kMaxCodeLength + 1] = {0};
  for (int len = 2; len <= kMaxCodeLength; ++len) next[len] = (next[len - 1] + count[len - 1]) << 1;
  code->fast.assign(256, 0);
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    code->sorted[offset[len]++] = static_cast<uint16_t>(s);
    const int canon = next[len]++;
    if (len > 8) continue;
    int rev = 0;
    for (int i = 0; i < len; ++i) rev |= ((canon >> i) & 1) << (len - 1 - i);
    for (int k = rev; k < 256; k += 1 << len) code->fast[k] = static_cast<uint32_t>(s | len << 16);
  }
  return true;
}

struct Group {
  PrefixCode code[5];
};

struct Meta {
  int cache_bits = 0;
  int huffman_bits = 0;  // 0: one group for the whole image
  int huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;  // group index per tile
  std::vector<Group> groups;
  std::vector<bool> counted;  // the groups libwebp's Is8bOptimizable looks at
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 8)
    r |= uint32_t(clip255(int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) -
                          int((c2 >> s) & 0xff)))
         << s;
  return r;
}

uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    r |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return r;
}

int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return (pb < 0 ? -pb : pb) - (pa < 0 ? -pa : pa);
}

uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int d = sub3(a >> 24, b >> 24, c >> 24) +
                sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

// VP8LPredictors[mode](left, top) with top pointing at the pixel above
uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and the sentinels 14 and 15
  }
}

// PredictorInverseTransform_C over the whole image
void predictor_inverse(const Transform& t, const uint32_t* in, uint32_t* out) {
  const int w = t.xsize, h = t.ysize;
  // the first row: black, then the left pixel
  out[0] = add_pixels(in[0], 0xff000000u);
  for (int x = 1; x < w; ++x) out[x] = add_pixels(in[x], out[x - 1]);
  const int tiles = subsample(w, t.bits);
  for (int y = 1; y < h; ++y) {
    const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
    uint32_t* o = out + size_t(y) * w;
    const uint32_t* i = in + size_t(y) * w;
    o[0] = add_pixels(i[0], o[-w]);  // the first column: the top pixel
    // the rightmost pixel's top-right is the first pixel of its own row,
    // which the row-major buffer gives
    for (int x = 1; x < w; ++x)
      o[x] = add_pixels(i[x], predict((modes[x >> t.bits] >> 8) & 0xf, o[x - 1], o + x - w));
  }
}

// VP8LInverseTransform over the whole image, `in` of the transform's
// (possibly packed) width into `out` of its full width.
void inverse_transform(const Transform& t, const std::vector<uint32_t>& in,
                       std::vector<uint32_t>* out) {
  const int w = t.xsize, h = t.ysize;
  out->resize(size_t(w) * h);
  uint32_t* o = out->data();
  switch (t.type) {
    case kSubtractGreen:
      for (size_t i = 0; i < out->size(); ++i) {
        const uint32_t argb = in[i];
        const uint32_t g = (argb >> 8) & 0xff;
        const uint32_t rb = ((argb & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        o[i] = (argb & 0xff00ff00u) | rb;
      }
      break;
    case kCrossColor: {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t c = codes[x >> t.bits];
          const int8_t g2r = static_cast<int8_t>(c & 0xff), g2b = static_cast<int8_t>(c >> 8),
                       r2b = static_cast<int8_t>(c >> 16);
          const uint32_t argb = in[size_t(y) * w + x];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + ((int(g2r) * green) >> 5)) & 0xff;
          blue += (int(g2b) * green) >> 5;
          blue += (int(r2b) * static_cast<int8_t>(red)) >> 5;
          blue &= 0xff;
          o[size_t(y) * w + x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
        }
      }
      break;
    }
    case kPredictor:
      predictor_inverse(t, in.data(), o);
      break;
    case kColorIndexing: {
      const int in_w = subsample(w, t.bits);
      const int per_byte_bits = 8 >> t.bits, mask = (1 << per_byte_bits) - 1;
      const int count_mask = (1 << t.bits) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = in.data() + size_t(y) * in_w;
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          o[size_t(y) * w + x] = t.data[packed & mask];
          packed >>= per_byte_bits;
        }
      }
      break;
    }
  }
}

class Decoder {
 public:
  BitReader br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  bool alpha8b_tail = false;  // the byte path's tolerance of the last symbol

  // DecodeImageStream's header: the level-0 image's transforms (which may
  // narrow it to *xsize), then the colour cache and the prefix codes, the
  // level-0 image's through an entropy image.
  int stream_header(int* xsize, int ysize, bool level0, Meta* meta) {
    if (level0) {
      while (read_bit()) {
        const int rc = read_transform(xsize, ysize);
        if (rc != kOk) return rc;
      }
    }
    if (read_bit()) {
      meta->cache_bits = static_cast<int>(br.read(4));
      if (meta->cache_bits < 1 || meta->cache_bits > kMaxCacheBits) return kCorrupt;
    }
    return read_codes(*xsize, ysize, level0, meta);
  }

  // A sub-image (transform data, entropy image, palette): header and pixels
  int sub_image(int xsize, int ysize, std::vector<uint32_t>* out) {
    Meta meta;
    const int rc = stream_header(&xsize, ysize, false, &meta);
    if (rc != kOk) return rc;
    out->assign(static_cast<size_t>(xsize) * ysize, 0);
    return pixels(xsize, ysize, meta, out->data());
  }

  // The level-0 image of w x h, its transforms inverted: ARGB.  For an ALPH
  // stream, libwebp's byte path (VP8LDecodeAlphaHeader's Is8bOptimizable:
  // colour indexing alone, no cache, single-symbol red, blue and alpha)
  // sets alpha8b_tail.
  int level0(int w, int h, bool alpha, std::vector<uint32_t>* argb) {
    Meta meta;
    int xsize = w;
    int rc = stream_header(&xsize, h, true, &meta);
    if (rc != kOk) return rc;
    bool bytes = alpha && transforms.size() == 1 && transforms[0].type == kColorIndexing &&
                 meta.cache_bits == 0;
    for (size_t i = 0; bytes && i < meta.groups.size(); ++i)
      if (meta.counted[i])
        for (int j : {kRed, kBlue, kAlpha}) bytes = bytes && meta.groups[i].code[j].single;
    alpha8b_tail = bytes;
    std::vector<uint32_t> data(size_t(xsize) * h), tmp;
    rc = pixels(xsize, h, meta, data.data());
    if (rc != kOk) return rc;
    for (size_t k = transforms.size(); k-- > 0;) {
      inverse_transform(transforms[k], data, &tmp);
      data.swap(tmp);
    }
    argb->swap(data);
    return kOk;
  }

  // DecodeImageData: the entropy-coded pixels into `data`.
  int pixels(int w, int h, const Meta& m, uint32_t* data) {
    const int64_t total = int64_t(w) * h;
    std::vector<uint32_t> cache(m.cache_bits ? size_t(1) << m.cache_bits : 0);
    const int cache_shift = 32 - m.cache_bits;
    const int len_limit = kNumLiteral + kNumLength;
    int64_t pos = 0;
    int col = 0, row = 0;
    auto insert = [&](int64_t from, int64_t to) {
      for (int64_t i = from; i < to; ++i)
        cache[(0x1e35a7bdu * data[i]) >> cache_shift] = data[i];
    };
    while (pos < total) {
      const Group& g = m.groups[group_at(m, col, row)];
      const int code = g.code[kGreen].decode(&br);
      const int64_t start = pos;
      if (code < kNumLiteral) {
        const int red = g.code[kRed].decode(&br);
        const int blue = g.code[kBlue].decode(&br);
        const int alpha = g.code[kAlpha].decode(&br);
        data[pos++] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) | (uint32_t(code) << 8) |
                      uint32_t(blue);
      } else if (code < len_limit) {
        const int length = copy_value(code - kNumLiteral);
        const int dist_symbol = g.code[kDist].decode(&br);
        const int dist = plane_distance(w, copy_value(dist_symbol));
        if (br.over() && !alpha8b_tail) return kCorrupt;
        if (pos < dist || total - pos < length) return kCorrupt;
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
        pos += length;
      } else {
        const int key = code - len_limit;
        if (key >= static_cast<int>(cache.size())) return kCorrupt;
        data[pos++] = cache[key];
      }
      if (br.over()) {
        // libwebp's byte path stops there, an error only with pixels left
        if (!alpha8b_tail || pos < total) return kCorrupt;
        return kOk;
      }
      if (m.cache_bits) insert(start, pos);
      col += static_cast<int>(pos - start);
      while (col >= w) {
        col -= w;
        ++row;
      }
    }
    return kOk;
  }

  int read_bit() { return static_cast<int>(br.read(1)); }

 private:
  static int group_at(const Meta& m, int col, int row) {
    if (m.huffman_bits == 0) return 0;
    return static_cast<int>(
        m.huffman_image[size_t(row >> m.huffman_bits) * m.huffman_xsize + (col >> m.huffman_bits)]);
  }

  // GetCopyLength / GetCopyDistance
  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
  }

  static int plane_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dist = kPlaneDistance[code - 1][0] + kPlaneDistance[code - 1][1] * xsize;
    return dist >= 1 ? dist : 1;
  }

  int read_transform(int* xsize, int ysize) {
    Transform t;
    t.type = static_cast<int>(br.read(2));
    if (seen & (1u << t.type)) return kCorrupt;
    seen |= 1u << t.type;
    t.xsize = *xsize;
    t.ysize = ysize;
    int rc = kOk;
    if (t.type == kPredictor || t.type == kCrossColor) {
      t.bits = 2 + static_cast<int>(br.read(3));
      rc = sub_image(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), &t.data);
    } else if (t.type == kColorIndexing) {
      const int colors = static_cast<int>(br.read(8)) + 1;
      t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> palette;
      rc = sub_image(colors, 1, &palette);
      if (rc == kOk) {  // ExpandColorMap: delta-coded, transparent black past it
        t.data.assign(size_t(1) << (8 >> t.bits), 0);
        t.data[0] = palette[0];
        for (int i = 1; i < colors; ++i) t.data[i] = add_pixels(palette[i], t.data[i - 1]);
      }
    }
    transforms.push_back(std::move(t));
    return rc;
  }

  // ReadHuffmanCode into `code` (alphabet_size symbols)
  int read_code(int alphabet, PrefixCode* code, std::vector<int>* lengths) {
    lengths->assign(alphabet > 256 ? alphabet : 256, 0);
    int* len = lengths->data();
    if (read_bit()) {  // simple code
      const int two = read_bit();
      const int first_bits = read_bit() ? 8 : 1;
      len[br.read(first_bits)] = 1;
      if (two) len[br.read(8)] = 1;
    } else {
      int cl_lengths[kCodeLengthCodes] = {0};
      const int num = static_cast<int>(br.read(4)) + 4;
      for (int i = 0; i < num; ++i) cl_lengths[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
      PrefixCode cl;
      if (!build_code(cl_lengths, kCodeLengthCodes, &cl)) return kCorrupt;
      int max_symbol = alphabet;
      if (read_bit()) {
        const int nbits = 2 + 2 * static_cast<int>(br.read(3));
        max_symbol = 2 + static_cast<int>(br.read(nbits));
        if (max_symbol > alphabet) return kCorrupt;
      }
      int prev = 8, symbol = 0;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int c = cl.decode(&br);
        if (c < 16) {
          len[symbol++] = c;
          if (c) prev = c;
        } else {
          static constexpr int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int repeat = static_cast<int>(br.read(kExtra[c - 16])) + kOffset[c - 16];
          if (symbol + repeat > alphabet) return kCorrupt;
          const int v = c == 16 ? prev : 0;
          while (repeat-- > 0) len[symbol++] = v;
        }
      }
    }
    if (br.over()) return kCorrupt;
    return build_code(len, alphabet, code) ? kOk : kCorrupt;
  }

  // ReadHuffmanCodes: the entropy image (level 0 only) and every group
  int read_codes(int xsize, int ysize, bool level0, Meta* m) {
    int num_groups = 1;
    bool mapped = false;
    if (level0 && read_bit()) {
      m->huffman_bits = 2 + static_cast<int>(br.read(3));
      const int hx = subsample(xsize, m->huffman_bits), hy = subsample(ysize, m->huffman_bits);
      int rc = sub_image(hx, hy, &m->huffman_image);
      if (rc != kOk) return rc;
      m->huffman_xsize = hx;
      int max_group = 0;
      for (auto& v : m->huffman_image) {
        v = (v >> 8) & 0xffff;
        if (static_cast<int>(v) + 1 > max_group) max_group = static_cast<int>(v) + 1;
      }
      num_groups = max_group;
      mapped = num_groups > 1000 || int64_t(num_groups) > int64_t(xsize) * ysize;
    }
    if (br.over()) return kCorrupt;
    m->groups.resize(num_groups);
    m->counted.assign(num_groups, !mapped);
    if (mapped)
      for (uint32_t v : m->huffman_image) m->counted[v] = true;
    std::vector<int> lengths;
    for (int i = 0; i < num_groups; ++i) {
      for (int j = 0; j < 5; ++j) {
        int alphabet = j == kGreen ? kNumLiteral + kNumLength
                                   : j == kDist ? kNumDistance : kNumLiteral;
        if (j == kGreen && m->cache_bits) alphabet += 1 << m->cache_bits;
        const int rc = read_code(alphabet, &m->groups[i].code[j], &lengths);
        if (rc != kOk) return rc;
      }
    }
    return kOk;
  }
};

}  // namespace

int fsvlm::vp8l_info(const uint8_t* data, size_t n, int* w, int* h, int* has_alpha) {
  // VP8LCheckSignature and ReadImageInfo
  if (n < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return kCorrupt;
  BitReader br;
  br.init(data, n);
  br.read(8);
  *w = static_cast<int>(br.read(14)) + 1;
  *h = static_cast<int>(br.read(14)) + 1;
  *has_alpha = static_cast<int>(br.read(1));
  if (br.read(3) != 0) return kCorrupt;
  return kOk;
}

int fsvlm::vp8l_decode_rgba(const uint8_t* data, size_t n, uint8_t* out, size_t stride) {
  int w = 0, h = 0, a = 0;
  int rc = vp8l_info(data, n, &w, &h, &a);
  if (rc != kOk) return rc;
  Decoder dec;
  dec.br.init(data, n);
  dec.br.pos = 40;
  std::vector<uint32_t> argb;
  rc = dec.level0(w, h, false, &argb);
  if (rc != kOk) return rc;
  for (int y = 0; y < h; ++y) {
    uint8_t* o = out + y * stride;
    const uint32_t* p = argb.data() + size_t(y) * w;
    for (int x = 0; x < w; ++x) {
      o[4 * x] = static_cast<uint8_t>(p[x] >> 16);
      o[4 * x + 1] = static_cast<uint8_t>(p[x] >> 8);
      o[4 * x + 2] = static_cast<uint8_t>(p[x]);
      o[4 * x + 3] = static_cast<uint8_t>(p[x] >> 24);
    }
  }
  return kOk;
}

int fsvlm::vp8l_decode_alpha(const uint8_t* data, size_t n, int w, int h, uint8_t* out) {
  Decoder dec;
  dec.br.init(data, n);
  std::vector<uint32_t> argb;
  const int rc = dec.level0(w, h, true, &argb);
  if (rc != kOk) return rc;
  for (size_t i = 0; i < argb.size(); ++i) out[i] = static_cast<uint8_t>(argb[i] >> 8);
  return kOk;
}
