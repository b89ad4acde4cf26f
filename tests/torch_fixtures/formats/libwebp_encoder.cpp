// Writes a WebP with libwebp's encoder in layouts Pillow's WEBP options do
// not reach, for make_fixtures.py, which builds it with g++ -lwebp and feeds
// it the pixels.  Not part of the port: its fixtures are committed.
//
//   libwebp_encoder OUT W H NCHAN [KEY=VALUE ...] < pixels
//
// pixels: W*H*NCHAN bytes (3: RGB, 4: RGBA), row-major.  Keys set
// WebPConfig's fields of the same name: quality, method, lossless,
// filter_type (0 simple, 1 normal), filter_sharpness, filter_strength,
// partitions (log2 of the token partitions; libwebp writes them at methods
// 0-2 only, its token buffer of methods 3-6 keeps one), segments, sns_strength,
// alpha_compression, alpha_filtering, alpha_quality.  Two more
// rewrite libwebp's file:
//
//   raw_alpha=F   the alpha plane as an uncompressed ALPH chunk under alpha
//                 filter F (0 none, 1 horizontal, 2 vertical, 3 gradient),
//                 before the VP8 chunk of the RGB, in a VP8X file
//   anim=CW,CH,X,Y  a two-frame animation on a CW x CH canvas whose first
//                 ANMF frame is the image at offset (X, Y) (both even) and
//                 whose second is the same image at (0, 0)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <webp/encode.h>

namespace {

using Bytes = std::vector<unsigned char>;

void put32(Bytes* b, unsigned v) {
  for (int i = 0; i < 4; ++i) b->push_back((v >> (8 * i)) & 0xff);
}

void put24(Bytes* b, unsigned v) {
  for (int i = 0; i < 3; ++i) b->push_back((v >> (8 * i)) & 0xff);
}

void chunk(Bytes* b, const char* tag, const Bytes& payload) {
  b->insert(b->end(), tag, tag + 4);
  put32(b, static_cast<unsigned>(payload.size()));
  b->insert(b->end(), payload.begin(), payload.end());
  if (payload.size() & 1) b->push_back(0);
}

Bytes riff(const Bytes& body) {
  Bytes out = {'R', 'I', 'F', 'F'};
  put32(&out, static_cast<unsigned>(body.size() + 4));
  out.insert(out.end(), {'W', 'E', 'B', 'P'});
  out.insert(out.end(), body.begin(), body.end());
  return out;
}

Bytes vp8x(unsigned flags, int w, int h) {
  Bytes p = {static_cast<unsigned char>(flags), 0, 0, 0};
  put24(&p, w - 1);
  put24(&p, h - 1);
  Bytes b;
  chunk(&b, "VP8X", p);
  return b;
}

// the chunks after "WEBP" of libwebp's file, past a VP8X chunk
Bytes image_chunks(const Bytes& file) {
  size_t pos = 12;
  if (std::memcmp(&file[pos], "VP8X", 4) == 0) pos += 8 + 10;
  return Bytes(file.begin() + pos, file.end());
}

Bytes encode(const WebPConfig& config, const unsigned char* px, int w, int h, int nchan) {
  WebPPicture pic;
  if (!WebPPictureInit(&pic)) std::exit(5);
  pic.width = w;
  pic.height = h;
  pic.use_argb = config.lossless;
  const int ok = nchan == 4 ? WebPPictureImportRGBA(&pic, px, w * 4)
                            : WebPPictureImportRGB(&pic, px, w * 3);
  if (!ok) std::exit(6);
  WebPMemoryWriter writer;
  WebPMemoryWriterInit(&writer);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &writer;
  if (!WebPEncode(&config, &pic)) {
    std::fprintf(stderr, "WebPEncode failed: %d\n", pic.error_code);
    std::exit(7);
  }
  Bytes out(writer.mem, writer.mem + writer.size);
  WebPMemoryWriterClear(&writer);
  WebPPictureFree(&pic);
  return out;
}

// the forward of libwebp's alpha unfilters
Bytes filter_alpha(const Bytes& a, int w, int h, int filter) {
  Bytes d(a.size());
  for (int y = 0; y < h; ++y) {
    const unsigned char* row = &a[size_t(y) * w];
    const unsigned char* up = y ? row - w : nullptr;
    for (int x = 0; x < w; ++x) {
      int pred;
      if (filter == 0) {
        pred = 0;
      } else if (filter == 1 || !up) {
        pred = x ? row[x - 1] : up ? up[0] : 0;
      } else if (filter == 2) {
        pred = up[x];
      } else {
        const int g = x ? row[x - 1] + up[x] - up[x - 1] : up[0];
        pred = g < 0 ? 0 : g > 255 ? 255 : g;
      }
      d[size_t(y) * w + x] = static_cast<unsigned char>(row[x] - pred);
    }
  }
  return d;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr, "usage: %s OUT W H NCHAN [KEY=VALUE ...]\n", argv[0]);
    return 2;
  }
  const int w = std::atoi(argv[2]), h = std::atoi(argv[3]), nchan = std::atoi(argv[4]);
  std::vector<unsigned char> px(static_cast<size_t>(w) * h * nchan);
  if (std::fread(px.data(), 1, px.size(), stdin) != px.size()) return 3;
  WebPConfig config;
  if (!WebPConfigInit(&config)) return 4;
  int raw_alpha = -1, anim[4] = {0, 0, 0, 0};
  bool animate = false;
  for (int i = 5; i < argc; ++i) {
    const std::string arg = argv[i];
    const size_t eq = arg.find('=');
    const std::string key = arg.substr(0, eq);
    const char* val = argv[i] + eq + 1;
    const int v = std::atoi(val);
    if (key == "quality") config.quality = static_cast<float>(std::atof(val));
    else if (key == "method") config.method = v;
    else if (key == "lossless") config.lossless = v;
    else if (key == "filter_type") config.filter_type = v;
    else if (key == "filter_sharpness") config.filter_sharpness = v;
    else if (key == "filter_strength") config.filter_strength = v;
    else if (key == "partitions") config.partitions = v;
    else if (key == "segments") config.segments = v;
    else if (key == "sns_strength") config.sns_strength = v;
    else if (key == "alpha_compression") config.alpha_compression = v;
    else if (key == "alpha_filtering") config.alpha_filtering = v;
    else if (key == "alpha_quality") config.alpha_quality = v;
    else if (key == "raw_alpha") raw_alpha = v;
    else if (key == "anim") {
      animate = std::sscanf(val, "%d,%d,%d,%d", &anim[0], &anim[1], &anim[2], &anim[3]) == 4;
      if (!animate) return 2;
    } else {
      std::fprintf(stderr, "unknown key %s\n", key.c_str());
      return 2;
    }
  }
  if (!WebPValidateConfig(&config)) return 4;
  Bytes file;
  if (raw_alpha >= 0) {
    if (nchan != 4) return 2;
    std::vector<unsigned char> rgb(size_t(w) * h * 3), alpha(size_t(w) * h);
    for (size_t i = 0; i < alpha.size(); ++i) {
      std::memcpy(&rgb[3 * i], &px[4 * i], 3);
      alpha[i] = px[4 * i + 3];
    }
    Bytes alph = {static_cast<unsigned char>(raw_alpha << 2)};
    const Bytes deltas = filter_alpha(alpha, w, h, raw_alpha);
    alph.insert(alph.end(), deltas.begin(), deltas.end());
    Bytes body = vp8x(0x10, w, h);
    chunk(&body, "ALPH", alph);
    const Bytes image = image_chunks(encode(config, rgb.data(), w, h, 3));
    body.insert(body.end(), image.begin(), image.end());
    file = riff(body);
  } else {
    file = encode(config, px.data(), w, h, nchan);
  }
  if (animate) {
    const Bytes image = image_chunks(file);
    Bytes body = vp8x(0x02 | (nchan == 4 ? 0x10 : 0), anim[0], anim[1]);
    Bytes params;
    put32(&params, 0xff336699u);  // a background colour the decoder ignores
    params.push_back(0);
    params.push_back(0);
    chunk(&body, "ANIM", params);
    for (int f = 0; f < 2; ++f) {
      Bytes frame;
      put24(&frame, f ? 0 : anim[2] / 2);
      put24(&frame, f ? 0 : anim[3] / 2);
      put24(&frame, w - 1);
      put24(&frame, h - 1);
      put24(&frame, 100);
      frame.push_back(0);
      frame.insert(frame.end(), image.begin(), image.end());
      chunk(&body, "ANMF", frame);
    }
    file = riff(body);
  }
  FILE* out = std::fopen(argv[1], "wb");
  if (!out || std::fwrite(file.data(), 1, file.size(), out) != file.size()) return 8;
  return std::fclose(out) == 0 ? 0 : 8;
}
