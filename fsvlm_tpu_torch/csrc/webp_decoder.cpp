// The port's WebP decoder: the RIFF container, the ALPH chunk and the first
// frame of an animation, with no library, its output byte-equal to Pillow
// 12.1's Image.open(path).convert("RGB").  Pillow opens every WebP file,
// still or animated, through libwebp 1.6.0's WebPAnimDecoder in MODE_RGBA
// (not premultiplied) with the default decoder options, and convert("RGB")
// drops the alpha channel without compositing.  So:
//
//  - The container is parsed as libwebp's demuxer (src/demux/demux.c)
//    parses it, and refused where it or the WebPGetFeatures check before it
//    refuses: the RIFF size at least 12 and a file not shorter than it
//    (bytes past it are ignored); chunk sizes padded to even and inside the
//    RIFF payload; a simple file's first chunk VP8 or VP8L, and fewer than 8
//    bytes left after it refused; VP8X of exactly 10 bytes, its flags (only
//    the five defined) and canvas (area below 2^32);
//    ALPH before its image, never before VP8L; ANIM before the ANMF frames,
//    each with its offset (x2), the image's own size and its ALPH plus VP8
//    or its VP8L, inside the canvas; a still image of exactly the canvas's
//    size; ICCP, EXIF, XMP and unknown chunks skipped.  A still image's
//    ALPH is dropped unless VP8X sets the alpha flag.
//  - The first frame is always a key frame (anim_decode.c): the canvas is
//    zero-filled and the frame decoded into its rectangle with no blending,
//    so pixels outside it are (0, 0, 0); ANIM's background colour is not
//    used.  The codecs are vp8_decoder.cpp (lossy, libwebp's fancy
//    upsampling) and vp8l_decoder.cpp (lossless).
//  - ALPH (src/dec/alpha_dec.c): compression 0 (raw, w * h bytes at least)
//    or 1 (a headerless VP8L stream, its green channel), the filters none,
//    horizontal, vertical and gradient undone with libwebp's first-row and
//    first-column rules, pre-processing 0 or 1 (its dithering strength is 0
//    in the default options), the reserved bits 0.  Alpha never changes the
//    RGB that convert("RGB") returns; it is decoded all the same, so that a
//    corrupt ALPH chunk fails where Pillow fails.
//  - No EXIF orientation and no ICC profile are applied, as Pillow's open
//    applies none.
//
// A file the demuxer or a codec refuses, truncated data included, returns
// kCorrupt; a canvas of more pixels than twice Pillow's MAX_IMAGE_PIXELS
// kTooLarge, checked after the container is parsed (Pillow's order: the
// decoder is built, then the bomb check runs) and before any buffer is
// sized.

#include <cstdint>
#include <cstring>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
constexpr uint32_t kAnimationFlag = 0x02, kAlphaFlag = 0x10, kAllValidFlags = 0x3e;

uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }
uint32_t fourcc(const char* s) { return le32(reinterpret_cast<const uint8_t*>(s)); }

enum Parse { kParseOk, kNeedMore, kParseError };

struct Chunk {
  size_t offset = 0, size = 0;  // from the chunk's header, header included
};

struct Frame {
  int x_offset = 0, y_offset = 0, width = 0, height = 0;
  int frame_num = 0;
  bool complete = false;
  Chunk image, alpha;
};

struct Demux {
  const uint8_t* buf = nullptr;
  size_t start = 0, end = 0, riff_end = 0;
  bool is_ext = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  std::vector<Frame> frames;

  size_t left() const { return end - start; }
  bool invalid(size_t size) const { return size > riff_end - start; }  // SizeIsInvalid
  uint32_t read32() {
    const uint32_t v = le32(buf + start);
    start += 4;
    return v;
  }
  uint32_t read24() {
    const uint32_t v = le24(buf + start);
    start += 3;
    return v;
  }
};

// WebPGetFeatures on a VP8 or VP8L chunk (its header and available payload)
bool features(const uint8_t* chunk, size_t size, int* w, int* h) {
  if (size < 12) return false;
  const uint32_t declared = le32(chunk + 4);
  if (declared > kMaxChunkPayload) return false;
  int alpha = 0;
  if (std::memcmp(chunk, "VP8L", 4) == 0)
    return vp8l_info(chunk + 8, size - 8, w, h, &alpha) == kOk;
  return vp8_info(chunk + 8, size - 8, declared, w, h) == kOk;
}

// StoreFrame: an ALPH and an image chunk from the current position
Parse store_frame(Demux* d, int frame_num, size_t min_size, Frame* f) {
  int alpha_chunks = 0, image_chunks = 0;
  if (d->left() < 8 || d->left() < min_size) return kNeedMore;
  Parse status = kParseOk;
  bool done = false;
  do {
    const size_t chunk_start = d->start;
    const uint32_t tag = d->read32();
    const uint32_t payload = d->read32();
    if (payload > kMaxChunkPayload) return kParseError;
    const uint32_t padded = payload + (payload & 1);
    const size_t available = padded > d->left() ? d->left() : padded;
    if (d->invalid(padded)) return kParseError;
    if (padded > d->left()) status = kNeedMore;
    const Chunk chunk{chunk_start, 8 + available};
    bool stop = false;
    if (tag == fourcc("ALPH")) {
      if (alpha_chunks == 0) {
        ++alpha_chunks;
        f->alpha = chunk;
        f->frame_num = frame_num;
        d->start += available;
      } else {
        stop = true;
      }
    } else if (tag == fourcc("VP8L") || tag == fourcc("VP8 ")) {
      if (tag == fourcc("VP8L") && alpha_chunks > 0) return kParseError;
      if (image_chunks == 0) {
        int w = 0, h = 0;
        if (!features(d->buf + chunk_start, chunk.size, &w, &h)) return kParseError;
        ++image_chunks;
        f->image = chunk;
        f->width = w;
        f->height = h;
        f->frame_num = frame_num;
        f->complete = status == kParseOk;
        d->start += available;
      } else {
        stop = true;
      }
    } else {
      stop = true;
    }
    if (stop) {
      d->start -= 8;
      done = true;
    }
    if (d->start == d->riff_end) {
      done = true;
    } else if (d->left() < 8) {
      status = kNeedMore;
    }
  } while (!done && status == kParseOk);
  return status;
}

bool add_frame(Demux* d, const Frame& f) {
  if (!d->frames.empty() && !d->frames.back().complete) return false;
  d->frames.push_back(f);
  return true;
}

Parse parse_single_image(Demux* d) {
  if (!d->frames.empty()) return kParseError;
  if (d->invalid(8)) return kParseError;
  if (d->left() < 8) return kNeedMore;
  Frame f;
  const Parse status = store_frame(d, 1, 0, &f);
  if (status == kParseError) return status;
  if (!(d->flags & kAlphaFlag) && f.alpha.size > 0) f.alpha = Chunk();
  if (!d->is_ext && f.width > 0 && f.height > 0) {
    d->canvas_w = f.width;
    d->canvas_h = f.height;
  }
  if (!add_frame(d, f)) return kParseError;
  return status;
}

Parse parse_animation_frame(Demux* d, uint32_t chunk_size) {
  const bool animation = d->flags & kAnimationFlag;
  if (d->invalid(16) || chunk_size < 16) return kParseError;
  if (d->left() < 16) return kNeedMore;
  const uint32_t payload = chunk_size - 16;
  Frame f;
  f.x_offset = 2 * static_cast<int>(d->read24());
  f.y_offset = 2 * static_cast<int>(d->read24());
  const uint64_t w = 1 + uint64_t(d->read24()), h = 1 + uint64_t(d->read24());
  d->start += 4;  // duration and the dispose and blend bits
  if (w * h >= (uint64_t(1) << 32)) return kParseError;
  const size_t frame_start = d->start;
  Parse status = store_frame(d, static_cast<int>(d->frames.size()) + 1, payload, &f);
  if (status != kParseError && d->start - frame_start > payload) status = kParseError;
  if (status != kParseError && animation && f.frame_num > 0 && !add_frame(d, f))
    status = kParseError;
  return status;
}

Parse parse_vp8x_chunks(Demux* d) {
  const bool animation = d->flags & kAnimationFlag;
  int anim_chunks = 0;
  Parse status = kParseOk;
  do {
    const uint32_t tag = d->read32();
    const uint32_t size = d->read32();
    if (size > kMaxChunkPayload) return kParseError;
    const uint32_t padded = size + (size & 1);
    if (d->invalid(padded)) return kParseError;
    if (tag == fourcc("VP8X")) {
      return kParseError;
    } else if (tag == fourcc("ALPH") || tag == fourcc("VP8 ") || tag == fourcc("VP8L")) {
      if (anim_chunks > 0 || animation) return kParseError;
      d->start -= 8;
      status = parse_single_image(d);
    } else if (tag == fourcc("ANIM") && anim_chunks == 0) {
      if (padded < 6) return kParseError;
      if (d->left() < padded) {
        status = kNeedMore;
      } else {
        ++anim_chunks;
        d->start += padded;  // the background colour and loop count, unused
      }
    } else if (tag == fourcc("ANMF")) {
      if (anim_chunks == 0) return kParseError;
      status = parse_animation_frame(d, padded);
    } else {
      if (tag == fourcc("ANIM") && padded < 6) return kParseError;
      if (padded <= d->left()) {
        d->start += padded;
      } else {
        status = kNeedMore;
      }
    }
    if (d->start == d->riff_end) break;
    if (d->left() < 8) status = kNeedMore;
  } while (status == kParseOk);
  return status;
}

Parse parse_vp8x(Demux* d) {
  if (d->left() < 8) return kNeedMore;
  d->is_ext = true;
  d->start += 4;
  uint32_t size = d->read32();
  if (size > kMaxChunkPayload || size < 10) return kParseError;
  size += size & 1;
  if (d->invalid(size)) return kParseError;
  if (d->left() < size) return kNeedMore;
  d->flags = d->buf[d->start];
  d->start += 4;
  const uint64_t w = 1 + uint64_t(d->read24()), h = 1 + uint64_t(d->read24());
  if (w * h >= (uint64_t(1) << 32)) return kParseError;
  d->canvas_w = static_cast<int>(w);
  d->canvas_h = static_cast<int>(h);
  d->start += size - 10;
  if (d->invalid(8)) return kParseError;
  if (d->left() < 8) return kNeedMore;
  return parse_vp8x_chunks(d);
}

bool frame_in_bounds(const Frame& f, bool exact, int cw, int ch) {
  if (exact)
    return f.x_offset == 0 && f.y_offset == 0 && f.width == cw && f.height == ch;
  return int64_t(f.width) + f.x_offset <= cw && int64_t(f.height) + f.y_offset <= ch;
}

// IsValidSimpleFormat / IsValidExtendedFormat on a fully parsed file
bool valid(const Demux& d) {
  if (d.canvas_w <= 0 || d.canvas_h <= 0 || d.frames.empty()) return false;
  if (!d.is_ext) return d.frames[0].width > 0 && d.frames[0].height > 0;
  const bool animation = d.flags & kAnimationFlag;
  if (d.flags & ~kAllValidFlags) return false;
  for (const Frame& f : d.frames) {
    if (!animation && f.frame_num > 1) return false;
    if (!f.complete) return false;
    if (f.alpha.size > 0 && f.alpha.offset > f.image.offset) return false;
    if (f.width <= 0 || f.height <= 0) return false;
    if (!frame_in_bounds(f, !animation, d.canvas_w, d.canvas_h)) return false;
  }
  return true;
}

// WebPDemux on the whole file: kOk with the canvas and the frames, or kCorrupt
int demux(const uint8_t* data, size_t len, Demux* d) {
  if (len < 20 || std::memcmp(data, "RIFF", 4) != 0 || std::memcmp(data + 8, "WEBP", 4) != 0)
    return kCorrupt;
  const uint32_t riff_size = le32(data + 4);
  if (riff_size < 12 || riff_size > kMaxChunkPayload) return kCorrupt;
  // WebPAnimDecoderNew validates the file with WebPGetFeatures before it
  // demuxes it, and that takes a VP8X chunk of exactly 10 bytes only
  if (std::memcmp(data + 12, "VP8X", 4) == 0 && le32(data + 16) != 10) return kCorrupt;
  d->buf = data;
  d->riff_end = size_t(riff_size) + 8;
  if (len < d->riff_end) return kCorrupt;  // a partial file
  d->end = d->riff_end;
  d->start = 12;
  Parse status;
  if (std::memcmp(data + 12, "VP8X", 4) == 0) {
    status = parse_vp8x(d);
  } else if (std::memcmp(data + 12, "VP8 ", 4) == 0 || std::memcmp(data + 12, "VP8L", 4) == 0) {
    status = parse_single_image(d);
  } else {
    return kCorrupt;  // Pillow does not take it for WebP
  }
  if (status != kParseOk || !valid(*d)) return kCorrupt;
  return kOk;
}

// VP8DecompressAlphaRows for a w x h frame: the alpha plane at `out`
int decode_alpha(const uint8_t* data, size_t size, int w, int h, uint8_t* out) {
  if (size <= 1) return kCorrupt;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6) != 0) return kCorrupt;
  const size_t n = size_t(w) * h;
  std::vector<uint8_t> deltas;
  const uint8_t* in = data + 1;
  if (method == 0) {
    if (size - 1 < n) return kCorrupt;
  } else {
    deltas.resize(n);
    const int rc = vp8l_decode_alpha(data + 1, size - 1, w, h, deltas.data());
    if (rc != kOk) return rc;
    in = deltas.data();
  }
  // WebPUnfilters: the first row of every filter but none is horizontal
  // from 0; a row's first pixel is the pixel above
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + size_t(y) * w;
    uint8_t* o = out + size_t(y) * w;
    const uint8_t* prev = y > 0 ? o - w : nullptr;
    if (filter == 0) {
      std::memcpy(o, row, w);
    } else if (filter == 1 || prev == nullptr) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = o[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < w; ++x) o[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {
      uint8_t top_left = prev[0], left = prev[0];
      for (int x = 0; x < w; ++x) {
        const uint8_t top = prev[x];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
        o[x] = left;
      }
    }
  }
  return kOk;
}

// The first frame of the parsed file composited on its zeroed RGBA canvas
int decode_canvas(const uint8_t* data, const Demux& d, uint8_t* canvas) {
  const Frame& f = d.frames[0];
  const size_t stride = size_t(d.canvas_w) * 4;
  std::memset(canvas, 0, stride * d.canvas_h);
  uint8_t* dst = canvas + size_t(f.y_offset) * stride + size_t(f.x_offset) * 4;
  const uint8_t* image = data + f.image.offset;
  const uint8_t* payload = image + 8;
  const size_t payload_size = f.image.size - 8;
  if (std::memcmp(image, "VP8L", 4) == 0)
    return vp8l_decode_rgba(payload, payload_size, dst, stride);
  int rc = vp8_decode_rgba(payload, payload_size, dst, stride);
  if (rc != kOk || f.alpha.size == 0) return rc;
  // the ALPH payload at its declared (unpadded) size
  const uint8_t* alph = data + f.alpha.offset;
  std::vector<uint8_t> alpha(size_t(f.width) * f.height);
  rc = decode_alpha(alph + 8, le32(alph + 4), f.width, f.height, alpha.data());
  if (rc != kOk) return rc;
  for (int y = 0; y < f.height; ++y)
    for (int x = 0; x < f.width; ++x) dst[y * stride + 4 * x + 3] = alpha[size_t(y) * f.width + x];
  return kOk;
}

int decode_webp(const uint8_t* data, size_t len, int w, int h, uint8_t* out, int channels) {
  Demux d;
  int rc = demux(data, len, &d);
  if (rc != kOk) return rc;
  if (too_large(d.canvas_w, d.canvas_h)) return kTooLarge;
  if (d.canvas_w != w || d.canvas_h != h) return kCorrupt;
  if (channels == 4) return decode_canvas(data, d, out);
  std::vector<uint8_t> canvas(size_t(w) * h * 4);
  rc = decode_canvas(data, d, canvas.data());
  if (rc != kOk) return rc;
  for (size_t i = 0, n = size_t(w) * h; i < n; ++i) std::memcpy(out + 3 * i, &canvas[4 * i], 3);
  return kOk;
}

}  // namespace

extern "C" {

// The canvas's width and height, once the container parses as libwebp's
// demuxer parses it.  Returns 0 on success.
int fsvlm_webp_size(const uint8_t* data, long len, int* w, int* h) {
  return guarded([&] {
    Demux d;
    const int rc = demux(data, static_cast<size_t>(len), &d);
    if (rc != kOk) return rc;
    if (too_large(d.canvas_w, d.canvas_h)) return static_cast<int>(kTooLarge);
    *w = d.canvas_w;
    *h = d.canvas_h;
    return static_cast<int>(kOk);
  });
}

// The first frame on its canvas as RGB into `out` (w * h * 3 bytes, w and h
// from fsvlm_webp_size).  Returns 0 on success.
int fsvlm_webp_decode_full(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  return guarded([&] { return decode_webp(data, static_cast<size_t>(len), w, h, out, 3); });
}

// The same canvas as RGBA (w * h * 4 bytes): the bytes of Pillow's RGBA
// mode, alpha included.
int fsvlm_webp_decode_rgba(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  return guarded([&] { return decode_webp(data, static_cast<size_t>(len), w, h, out, 4); });
}

}  // extern "C"
