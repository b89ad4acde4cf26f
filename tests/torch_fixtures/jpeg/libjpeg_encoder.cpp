// Writes a JPEG with libjpeg at sampling factors and colour spaces Pillow's
// encoder does not offer (4:1:1, 4:4:0, YCCK, Adobe RGB, grayscale at 2x2),
// arithmetic-coded, or progressive under a scan script of its own, for
// make_fixtures.py (this directory's and tests/torch_fixtures/formats/'s),
// which build it with g++ -ljpeg and feed it the pixels.  Not part of the
// port: its fixtures are committed.
//
//   libjpeg_encoder OUT W H NCOMP SAMPLING QUALITY PROGRESSIVE RESTART_ROWS SPACE
//                   [ARITH [SCANS]] < pixels
//
// pixels: W*H*NCOMP bytes, row-major.  SAMPLING: "hv,hv,..." per component
// (e.g. "41,11,11").  SPACE: 0 = the default JPEG colour space (YCbCr for 3
// components, CMYK for 4), 1 = RGB for 3 components, YCCK for 4.  ARITH: 0
// for Huffman coding, 1 for arithmetic coding with libjpeg's default
// conditioning, or "L,U,K" for arithmetic coding with DC conditioning
// bounds L and U and AC conditioning K on every table.  SCANS: a
// progressive scan script, scans split by ';', each "COMPS:Ss-Se:Ah-Al"
// (e.g. "012:0-0:0-1;0:1-5:0-2"), which may leave coefficients unrefined.

#include <cstdio>
#include <cstdlib>
#include <vector>

#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc < 10 || argc > 12) {
    std::fprintf(stderr, "usage: %s OUT W H NCOMP SAMPLING QUALITY PROGRESSIVE RESTART_ROWS SPACE"
                 " [ARITH [SCANS]]\n", argv[0]);
    return 2;
  }
  const int w = std::atoi(argv[2]), h = std::atoi(argv[3]), nc = std::atoi(argv[4]);
  const char* samp = argv[5];
  const int quality = std::atoi(argv[6]), progressive = std::atoi(argv[7]);
  const int restart_rows = std::atoi(argv[8]), space = std::atoi(argv[9]);
  std::vector<unsigned char> img(static_cast<size_t>(w) * h * nc);
  if (std::fread(img.data(), 1, img.size(), stdin) != img.size()) return 3;
  FILE* f = std::fopen(argv[1], "wb");
  if (!f) return 4;
  jpeg_compress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, f);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
  if (space) jpeg_set_colorspace(&c, nc == 3 ? JCS_RGB : JCS_YCCK);
  jpeg_set_quality(&c, quality, TRUE);
  for (int k = 0; k < nc; ++k) {
    c.comp_info[k].h_samp_factor = samp[k * 3] - '0';
    c.comp_info[k].v_samp_factor = samp[k * 3 + 1] - '0';
  }
  if (progressive) jpeg_simple_progression(&c);
  c.restart_in_rows = restart_rows;
  if (argc > 10 && argv[10][0] != '0') {
    c.arith_code = TRUE;
    int l, u, k;
    if (std::sscanf(argv[10], "%d,%d,%d", &l, &u, &k) == 3) {
      for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
        c.arith_dc_L[t] = static_cast<UINT8>(l);
        c.arith_dc_U[t] = static_cast<UINT8>(u);
        c.arith_ac_K[t] = static_cast<UINT8>(k);
      }
    }
  }
  std::vector<jpeg_scan_info> scans;
  if (argc > 11) {
    for (const char* p = argv[11]; *p;) {
      jpeg_scan_info si{};
      while (*p >= '0' && *p <= '9') si.component_index[si.comps_in_scan++] = *p++ - '0';
      if (std::sscanf(p, ":%d-%d:%d-%d", &si.Ss, &si.Se, &si.Ah, &si.Al) != 4) return 5;
      scans.push_back(si);
      while (*p && *p != ';') ++p;
      if (*p == ';') ++p;
    }
    c.scan_info = scans.data();
    c.num_scans = static_cast<int>(scans.size());
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = &img[static_cast<size_t>(c.next_scanline) * w * nc];
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  std::fclose(f);
  return 0;
}
