// The port's Netpbm decoder: P1-P6 (plain and binary bitmaps, graymaps and
// pixmaps) with no library, its output byte-equal to Pillow 12.1's
// Image.open(path).convert("RGB") (PpmImagePlugin).
//
//  - The header as Pillow reads it: the magic ends at whitespace; each
//    token skips whitespace, and a '#' comment runs to the end of its line
//    anywhere in the header, even inside a token, which then goes on after
//    it; a token is at most 10 characters; the raster starts after the one
//    whitespace character that ends the last token.
//  - Bitmaps: 1 is black.  Binary graymaps and pixmaps of maxval 255 are
//    read as they are; a graymap of maxval 65535 is Pillow's mode I;16B;
//    any other maxval is rescaled per sample as Pillow's PpmDecoder does,
//    round(v / maxval * out_max) with out_max 65535 for a graymap above 255
//    (mode I) and 255 otherwise, clipped to out_max.  Plain files drop their
//    comments with the newline that ends them, split on whitespace, refuse
//    a sample above maxval, and rescale the same way.
//  - Mode I and I;16B go to RGB as Pillow converts them: clipped to 255.
//
// Truncated or malformed data returns kCorrupt; an image of more pixels
// than twice Pillow's MAX_IMAGE_PIXELS kTooLarge.

#include <cstdint>
#include <cstring>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

bool is_space(int c) { return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r'; }

struct Header {
  int kind = 0;  // 1..6
  int64_t width = 0, height = 0;
  int64_t maxval = 1;
  size_t raster = 0;  // offset of the first sample
};

// Python's int() of a token of ASCII bytes: an optional sign, digits, and
// single underscores between digits.  False for anything else.
bool parse_int(const std::vector<uint8_t>& tok, int64_t* v) {
  size_t i = 0;
  bool neg = false;
  if (i < tok.size() && (tok[i] == '+' || tok[i] == '-')) neg = tok[i++] == '-';
  if (i == tok.size()) return false;
  int64_t x = 0;
  bool last_digit = false;
  for (; i < tok.size(); ++i) {
    const int c = tok[i];
    if (c >= '0' && c <= '9') {
      x = x * 10 + (c - '0');
      last_digit = true;
    } else if (c == '_' && last_digit && i + 1 < tok.size()) {
      last_digit = false;
    } else {
      return false;
    }
  }
  if (!last_digit) return false;
  *v = neg ? -x : x;
  return true;
}

// PpmImageFile._read_token
int read_token(const uint8_t* d, size_t len, size_t* pos, int64_t* v) {
  std::vector<uint8_t> tok;
  while (tok.size() <= 10) {
    if (*pos >= len) break;
    const int c = d[(*pos)++];
    if (is_space(c)) {
      if (tok.empty()) continue;
      break;
    }
    if (c == '#') {
      while (*pos < len) {
        const int e = d[(*pos)++];
        if (e == '\r' || e == '\n') break;
      }
      continue;
    }
    tok.push_back(static_cast<uint8_t>(c));
  }
  if (tok.empty() || tok.size() > 10) return kCorrupt;
  return parse_int(tok, v) ? kOk : kCorrupt;
}

int parse_header(const uint8_t* d, size_t len, Header* h) {
  // the magic: up to 6 bytes, ended by whitespace or the end of the data
  size_t pos = 0;
  std::vector<uint8_t> magic;
  while (pos < len && magic.size() < 6) {
    const int c = d[pos++];
    if (is_space(c)) break;
    magic.push_back(static_cast<uint8_t>(c));
  }
  if (magic.size() != 2 || magic[0] != 'P' || magic[1] < '1' || magic[1] > '6') return kRefused;
  h->kind = magic[1] - '0';
  int rc = read_token(d, len, &pos, &h->width);
  if (rc == kOk) rc = read_token(d, len, &pos, &h->height);
  if (rc != kOk) return rc;
  if (h->width <= 0 || h->height <= 0) return kCorrupt;
  if (too_large(h->width, h->height)) return kTooLarge;
  if (h->kind != 1 && h->kind != 4) {
    rc = read_token(d, len, &pos, &h->maxval);
    if (rc != kOk) return rc;
    if (h->maxval <= 0 || h->maxval >= 65536) return kCorrupt;
  }
  h->raster = pos;
  return kOk;
}

inline uint8_t clip255(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// The plain formats' samples (PpmPlainDecoder): comments removed with the
// newline that ends them, the rest split on whitespace.
int plain_samples(const uint8_t* d, size_t len, size_t pos, const Header& h, int64_t count,
                  std::vector<int64_t>& out) {
  std::vector<uint8_t> body;
  body.reserve(len - pos);
  for (size_t i = pos; i < len; ++i) {
    if (d[i] == '#') {
      while (i < len && d[i] != '\n' && d[i] != '\r') ++i;
      continue;  // the newline goes with the comment
    }
    body.push_back(d[i]);
  }
  out.clear();
  out.reserve(static_cast<size_t>(count));
  if (h.kind == 1) {  // every non-space byte is one sample: all are '0' or '1'
    for (uint8_t c : body) {
      if (is_space(c)) continue;
      if (c != '0' && c != '1') return kCorrupt;
      if (static_cast<int64_t>(out.size()) < count) out.push_back(c == '1');
    }
    return static_cast<int64_t>(out.size()) == count ? kOk : kCorrupt;
  }
  const int64_t out_max = (h.kind == 2 && h.maxval > 255) ? 65535 : 255;
  size_t i = 0;
  while (static_cast<int64_t>(out.size()) < count) {
    while (i < body.size() && is_space(body[i])) ++i;
    if (i == body.size()) break;
    std::vector<uint8_t> tok;
    while (i < body.size() && !is_space(body[i])) tok.push_back(body[i++]);
    if (tok.size() > 10) return kCorrupt;
    int64_t v;
    if (!parse_int(tok, &v) || v < 0 || v > h.maxval) return kCorrupt;
    out.push_back(py_round_scale(v, h.maxval, out_max));
  }
  return static_cast<int64_t>(out.size()) == count ? kOk : kCorrupt;
}

int decode_pnm(const uint8_t* d, size_t len, int w_expect, int h_expect, uint8_t* out) {
  Header h;
  int rc = parse_header(d, len, &h);
  if (rc != kOk) return rc;
  if (h.width != w_expect || h.height != h_expect) return kCorrupt;
  const int64_t w = h.width, n = h.width * h.height;
  const int bands = (h.kind == 3 || h.kind == 6) ? 3 : 1;
  const int64_t count = n * bands;
  std::vector<int64_t> s;  // samples after Pillow's rescale
  if (h.kind <= 3) {
    rc = plain_samples(d, len, h.raster, h, count, s);
    if (rc != kOk) return rc;
    for (int64_t p = 0; p < n; ++p) {
      uint8_t* o = out + p * 3;
      if (h.kind == 1) {
        o[0] = o[1] = o[2] = s[p] ? 0 : 255;
      } else if (h.kind == 2) {
        o[0] = o[1] = o[2] = clip255(s[p]);
      } else {
        for (int c = 0; c < 3; ++c) o[c] = static_cast<uint8_t>(s[p * 3 + c]);
      }
    }
    return kOk;
  }
  const uint8_t* r = d + h.raster;
  const size_t avail = len - h.raster;
  if (h.kind == 4) {  // rows of ceil(w / 8) bytes, 1 is black
    const size_t stride = static_cast<size_t>((w + 7) / 8);
    if (avail < stride * static_cast<size_t>(h.height)) return kCorrupt;
    for (int64_t y = 0; y < h.height; ++y)
      for (int64_t x = 0; x < w; ++x) {
        const int bit = (r[y * stride + x / 8] >> (7 - x % 8)) & 1;
        uint8_t* o = out + (y * w + x) * 3;
        o[0] = o[1] = o[2] = bit ? 0 : 255;
      }
    return kOk;
  }
  const int in_bytes = h.maxval < 256 ? 1 : 2;
  if (avail < static_cast<size_t>(count) * in_bytes) return kCorrupt;
  const bool as_is = h.maxval == 255 || (h.kind == 5 && h.maxval == 65535);
  const int64_t out_max = (h.kind == 5 && h.maxval > 255) ? 65535 : 255;
  for (int64_t p = 0; p < n; ++p) {
    uint8_t* o = out + p * 3;
    for (int c = 0; c < bands; ++c) {
      const int64_t i = p * bands + c;
      int64_t v = in_bytes == 1 ? r[i] : (r[2 * i] << 8) | r[2 * i + 1];
      if (!as_is) {
        v = py_round_scale(v, h.maxval, out_max);
        if (v > out_max) v = out_max;
      }
      o[c] = clip255(v);
    }
    if (bands == 1) o[1] = o[2] = o[0];
  }
  return kOk;
}

}  // namespace

extern "C" {

// The image's width and height from its header.  Returns 0 on success.
int fsvlm_pnm_size(const uint8_t* data, long len, int* w, int* h) {
  return guarded([&] {
    Header hd;
    const int rc = parse_header(data, static_cast<size_t>(len), &hd);
    if (rc != kOk) return rc;
    *w = static_cast<int>(hd.width);
    *h = static_cast<int>(hd.height);
    return static_cast<int>(kOk);
  });
}

// Full-resolution RGB into `out` (w * h * 3 bytes, w and h from
// fsvlm_pnm_size).  Returns 0 on success.
int fsvlm_pnm_decode_full(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  return guarded([&] { return decode_pnm(data, static_cast<size_t>(len), w, h, out); });
}

}  // extern "C"
