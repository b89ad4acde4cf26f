"""Write the committed BMP, Netpbm, GIF, TIFF, JPEG-variant and WebP
fixtures and their expected decodes.

    python tests/torch_fixtures/formats/make_fixtures.py

BMP, Netpbm, GIF, TIFF and the lossless JPEG are written by ``encoders.py``
(numpy, struct and zlib, no Pillow) from seeded numpy pixels, at the sizes
of the public sets that hold such files: GTSRB's PPM signs, the AT&T/ORL
PGM faces, the Yale GIF faces, UC Merced's 256 x 256 and NCT-CRC-HE's
224 x 224 TIFF tiles; and in the layouts only a hand-written encoder
reaches (RLE4/RLE8 with deltas, OS/2 and V4/V5 BMP headers, bitfields,
plain Netpbm with comments, 16-bit maxvals, a local-table interlaced GIF
frame smaller than its screen, a GIF table left full without a clear code,
tiled planar big-endian LZW with the predictor, old-style LZW, associated
alpha, CMYK, a 16-bit colormap, FillOrder 2, an Orientation tag).  The
arithmetic-coded and block-smoothed JPEGs come from
``tests/torch_fixtures/jpeg/libjpeg_encoder.cpp`` (built here with
``g++ -ljpeg``: it needs libjpeg's header and library), which writes
arithmetic coding and scan scripts that leave coefficients unrefined; each
stays under Pillow's 64 KiB read chunk, past which Pillow 12.1 cannot read
an arithmetic-coded scan, but for one file past it, whose ``full`` digest
Pillow gives with the whole file in one read.

The WebP files come from their own seed, so the files above keep their
bytes: photo-sized lossy and lossless stills from Pillow's encoder, and,
from ``libwebp_encoder.cpp`` (built here with ``g++ -lwebp``: it needs
libwebp's header and library), the layouts Pillow's options do not reach:
the simple loop filter with a nonzero sharpness, 2, 4 and 8 token
partitions, one segment and four with their map, raw ALPH chunks under each
alpha filter, a VP8L-compressed ALPH, and animations (lossy with alpha,
lossless) whose first frame is smaller than the canvas, at an offset.  Their
``full`` digests are Pillow 12.1's decode with its libwebp 1.6.0, whatever
wrote the file.

``expected.json`` holds, per readable file, the sha256 and the byte sum of
four uint8 arrays computed here from the JAX package's own means:

- ``full``: Pillow's ``Image.open(path).convert("RGB")``;
- ``raw256``: ``fsvlm_tpu.native.decode_file(path, 256)`` (its libjpeg
  build), None for every file but the DCT JPEGs;
- ``cache256``: the JAX package's ``RawDatasetWrapper`` view at 256;
- ``eval224``: the JAX eval view before normalizing (bicubic resize of the
  shorter edge to 224, centre crop);

``truncated`` the names that must raise ValueError, and ``refused`` those
that must raise naming ROADMAP A16.  ``tests/test_torch_formats.py`` and
``chip_smoke.py`` (phase 23) hold the port's decodes to these digests.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from encoders import (encode_bmp, encode_gif, encode_lossless_jpeg, encode_pnm,  # noqa: E402
                      encode_tiff, jpeg_parts, rle_encode)

SEED = 24
WEBP_SEED = 25
TIFF_SEED = 26
PRE_SIZE = 256
EVAL_SIZE = (224, 224)
JPEG_DIR = os.path.join(os.path.dirname(HERE), "jpeg")


def scene(rng, h, w, c=3):
    """Smooth blobs over a gradient, with a little noise: a photo's
    statistics at a file size the repo can hold."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, c))
    for ch in range(c):
        img[..., ch] = 60 + 80 * (x / w) * rng.uniform(0.3, 1) + 60 * (y / h) * rng.uniform(0.3, 1)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.08, 0.3) * min(h, w)
        blob = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))
        img += blob[..., None] * rng.uniform(-90, 90, c)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).round().astype(np.int64)


def quantize(img, levels):
    """An RGB scene to palette indices and their palette (median colours)."""
    g = img.mean(-1)
    edges = np.quantile(g, np.linspace(0, 1, levels + 1)[1:-1])
    idx = np.digitize(g, edges)
    pal = np.array([img[idx == k].mean(0) if (idx == k).any() else [0, 0, 0]
                    for k in range(levels)]).round().astype(np.int64)
    return idx, pal


def _libjpeg(exe, rng, name, w, h, nc, samp, prog, rst, arith, scans=None, noise=0):
    path = os.path.join(HERE, name)
    args = [exe, path, str(w), str(h), str(nc), samp, "88", str(prog), str(rst), "0", arith]
    if scans:
        args.append(scans)
    pixels = np.clip(scene(rng, h, w, nc) + rng.normal(0, noise, (h, w, nc)), 0, 255)
    pixels = pixels.astype(np.uint8)
    subprocess.run(args, input=pixels.tobytes(), check=True)
    with open(path, "rb") as f:
        return f.read()


def _files(rng, exe):
    """name -> bytes (the libjpeg files are written by the encoder itself)."""
    files = {}
    img = scene(rng, 192, 256)
    files["bmp_rgb24_256x192.bmp"] = encode_bmp(img[..., ::-1], 24)
    idx, pal = quantize(scene(rng, 120, 160), 200)
    files["bmp_pal8_rle8_160x120.bmp"] = encode_bmp(
        idx, 8, compression=1, palette=pal,
        rle=rle_encode(idx, False, deltas=[(10, 20, 5, 0), (30, 100, 7, 2)]))
    idx, pal = quantize(scene(rng, 61, 97), 16)
    files["bmp_pal4_rle4_97x61.bmp"] = encode_bmp(idx, 4, compression=2, palette=pal,
                                                  rle=rle_encode(idx, True))
    idx, pal = quantize(scene(rng, 96, 128), 256)
    files["bmp_os2_pal8_128x96.bmp"] = encode_bmp(idx, 8, header=12, palette=pal)
    img = scene(rng, 90, 120)
    words = ((img[..., 0] >> 3) << 11) | ((img[..., 1] >> 2) << 5) | (img[..., 2] >> 3)
    files["bmp_565_v5_topdown_120x90.bmp"] = encode_bmp(
        words, 16, header=124, compression=3, masks=(0xF800, 0x7E0, 0x1F), top_down=True)
    img = scene(rng, 80, 100, 4)
    files["bmp_bgra32_v4_100x80.bmp"] = encode_bmp(
        img, 32, header=108, compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    files["bmp_bw1_64x64.bmp"] = encode_bmp(scene(rng, 64, 64, 1)[..., 0] > 128, 1,
                                            palette=[(0, 0, 0), (255, 255, 255)])
    files["gtsrb_p6_53x57.ppm"] = encode_pnm(scene(rng, 57, 53), 6)
    files["orl_p5_92x112.pgm"] = encode_pnm(scene(rng, 112, 92, 1)[..., 0], 5)
    files["p5_maxval1000_40x30.pgm"] = encode_pnm(scene(rng, 30, 40, 1)[..., 0] * 1000 // 255, 5,
                                                  1000)
    files["p6_maxval65535_50x40.ppm"] = encode_pnm(scene(rng, 40, 50) * 257, 6, 65535)
    files["p3_plain_comments_33x21.ppm"] = encode_pnm(scene(rng, 21, 33) * 100 // 255, 3, 100,
                                                      comments=True)
    files["p4_bitmap_45x37.pbm"] = encode_pnm(scene(rng, 37, 45, 1)[..., 0] < 128, 4)
    files["p1_plain_20x12.pbm"] = encode_pnm(scene(rng, 12, 20, 1)[..., 0] < 128, 1,
                                             comments=True)
    g = scene(rng, 243, 320, 1)[..., 0]
    files["yale_gray_320x243.gif"] = encode_gif(g, global_palette=np.stack([np.arange(256)] * 3,
                                                                           -1))
    idx, pal = quantize(scene(rng, 150, 200), 64)
    files["gif_local_interlaced_sub_230x170.gif"] = encode_gif(
        idx, screen=(230, 170), offset=(17, 9), global_palette=pal[::-1][:16],
        local_palette=pal, interlace=True, transparency=5, min_code=6)
    idx, pal = quantize(scene(rng, 128, 128), 256)
    files["gif_full_table_128x128.gif"] = encode_gif(idx, global_palette=pal,
                                                     clear_when_full=False)
    files["ucmerced_rgb_lzw_pred_256x256.tif"] = encode_tiff(
        scene(rng, 256, 256), 2, compression=5, predictor=2, rows_per_strip=16)
    files["nctcrc_rgb_raw_224x224.tif"] = encode_tiff(scene(rng, 224, 224), 2, rows_per_strip=32)
    files["tiff_tiled_planar_lzw_mm_120x90.tiff"] = encode_tiff(
        scene(rng, 90, 120), 2, order=">", compression=5, predictor=2, tile=(32, 32), planar=2)
    img = scene(rng, 80, 100, 4)
    img[..., :3] = img[..., :3] * img[..., 3:] // 255
    files["tiff_rgba_assoc_deflate_100x80.tif"] = encode_tiff(img, 2, compression=8, extra=(1,))
    idx, pal = quantize(scene(rng, 55, 77), 16)
    cmap = np.zeros((3, 16), np.int64)
    cmap[:, :len(pal)] = pal.T * 257 + rng.integers(0, 256, pal.T.shape)
    files["tiff_pal4_packbits_77x55.tif"] = encode_tiff(idx, 3, bits=4, compression=32773,
                                                        colormap=cmap)
    files["tiff_gray16_mm_deflate_64x48.tif"] = encode_tiff(
        scene(rng, 48, 64, 1) * 2, 1, bits=16, order=">", compression=32946, tile=(16, 16))
    files["tiff_cmyk_lzw_64x48.tif"] = encode_tiff(scene(rng, 48, 64, 4), 5, compression=5)
    files["tiff_minwhite1_fill2_90x60.tif"] = encode_tiff(
        scene(rng, 60, 90, 1) > 128, 0, bits=1, fillorder=2, rows_per_strip=7)
    files["tiff_lzw_oldstyle_80x60.tif"] = encode_tiff(scene(rng, 60, 80), 2, compression=5,
                                                       lzw_old_style=True)
    files["tiff_orientation6_60x40.tif"] = encode_tiff(scene(rng, 40, 60), 2, orientation=6)
    # uncompressed YCbCr: Pillow's raw decoder reads RGBX, four bytes a pixel,
    # past the data, and calls the file truncated
    files["truncated_tiff_ycbcr_raw_32x32.tif"] = encode_tiff(scene(rng, 32, 32), 6)
    files["jpeg_lossless_pred7_96x64.jpg"] = encode_lossless_jpeg(scene(rng, 64, 96), predictor=7,
                                                                  pt=1, restart_rows=16)
    whole = encode_gif(scene(rng, 60, 80, 1)[..., 0], global_palette=np.stack([np.arange(256)] * 3,
                                                                               -1)[::-1])
    files["truncated_gif_80x60.gif"] = whole[:len(whole) // 2]
    for name, args in {
            "jpeg_arith_seq_420_300x200.jpg": (300, 200, 3, "22,11,11", 0, 0, "1"),
            "jpeg_arith_prog_rst_cond_240x180.jpg": (240, 180, 3, "21,11,11", 1, 2, "2,4,3"),
            "jpeg_smoothed_unrefined_400x300.jpg": (
                400, 300, 3, "22,11,11", 1, 0, "0",
                "012:0-0:0-1;0:1-5:0-2;0:6-63:0-2;1:1-63:0-1;2:1-63:0-1;0:1-63:2-1"),
            "jpeg_smoothed_dconly_chroma_256x256.jpg": (
                256, 256, 3, "11,11,11", 1, 0, "0", "012:0-0:0-0;0:1-63:0-0"),
            "jpeg_arith_smoothed_gray_200x150.jpg": (200, 150, 1, "11", 1, 0, "1",
                                                     "0:0-0:0-1;0:1-2:0-0;0:3-63:0-1"),
            "jpeg_arith_past_64k_444_480x360.jpg": (480, 360, 3, "11,11,11", 0, 0, "1", None,
                                                    24),
    }.items():
        files[name] = _libjpeg(exe, rng, name, *args)
    return files


def _webp_files(rng, exe):
    """name -> bytes of the WebP fixtures (libwebp_encoder.cpp's written by
    it, Pillow's here)."""
    import io

    from PIL import Image

    def pillow(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, format="WEBP", **kw)
        return buf.getvalue()

    def libwebp(name, img, *args):
        path = os.path.join(HERE, name)
        h, w, c = img.shape
        subprocess.run([exe, path, str(w), str(h), str(c), *args],
                       input=np.ascontiguousarray(img.astype(np.uint8)).tobytes(), check=True)
        with open(path, "rb") as f:
            return f.read()

    def photo(h, w, c=3):
        """scene() with a photo's edges and grain: a lossy encoder then
        spends 4x4 modes and tokens on it, not only flat 16x16 blocks."""
        img = scene(rng, h, w, c).astype(np.float64)
        y, x = np.mgrid[0:h, 0:w]
        img += 40 * ((x // 9 + y // 13) % 2)[..., None] * rng.uniform(-1, 1, c)
        img += 25 * np.sin(x * 0.9 + y * 0.4)[..., None]
        return np.clip(img + rng.normal(0, 10, img.shape), 0, 255).round().astype(np.int64)

    def with_alpha(img):
        h, w, _ = img.shape
        y, x = np.mgrid[0:h, 0:w]
        a = np.clip(128 + 120 * np.sin(x / 7.0) * np.cos(y / 5.0), 0, 255).round()
        a[h // 3:h // 2, w // 4:w // 2] = 0  # a fully transparent patch keeps its RGB
        return np.concatenate([img, a[..., None].astype(np.int64)], -1)

    files = {"webp_lossy_photo_500x375.webp": pillow(photo(375, 500), quality=80),
             "webp_lossless_photo_333x251.webp": pillow(photo(251, 333), lossless=True)}
    for name, img, args in [
            ("webp_lossy_simple_sharp5_97x61.webp", photo(61, 97),
             ["filter_type=0", "filter_sharpness=5", "filter_strength=60"]),
            ("webp_lossy_parts2_120x90.webp", photo(90, 120), ["method=2", "partitions=1"]),
            ("webp_lossy_parts4_120x90.webp", photo(90, 120), ["method=2", "partitions=2"]),
            ("webp_lossy_parts8_121x89.webp", photo(89, 121),
             ["method=0", "partitions=3", "quality=90"]),
            ("webp_lossy_seg1_96x64.webp", photo(64, 96), ["segments=1"]),
            ("webp_lossy_seg4_map_130x98.webp", photo(98, 130),
             ["segments=4", "sns_strength=100", "filter_sharpness=2"]),
            ("webp_lossy_alpha_raw_none_80x60.webp", with_alpha(photo(60, 80)),
             ["alpha_compression=0"]),
            ("webp_lossy_alpha_raw_horizontal_81x59.webp", with_alpha(photo(59, 81)),
             ["raw_alpha=1"]),
            ("webp_lossy_alpha_raw_vertical_64x48.webp", with_alpha(photo(48, 64)),
             ["raw_alpha=2"]),
            ("webp_lossy_alpha_raw_gradient_63x47.webp", with_alpha(photo(47, 63)),
             ["raw_alpha=3"]),
            ("webp_lossy_alpha_vp8l_best_99x77.webp", with_alpha(photo(77, 99)),
             ["alpha_filtering=2", "alpha_quality=80"]),
            ("webp_lossy_anim_offset_alpha_150x110.webp", with_alpha(photo(61, 97)),
             ["anim=150,110,34,18"]),
            ("webp_lossless_anim_offset_140x100.webp", photo(57, 83),
             ["lossless=1", "anim=140,100,40,22"]),
    ]:
        files[name] = libwebp(name, img, *args)
    whole = pillow(photo(61, 97), quality=75)
    files["truncated_webp_97x61.webp"] = whole[:len(whole) // 2]
    return files


def _tiff_files(rng):
    """name -> bytes of the TIFF kinds read through libtiff's other codecs
    in Pillow (their own seed, so the files above keep their bytes): JPEG,
    CCITT, BigTIFF and the F / I modes from Pillow's writer; YCbCr blocks
    (edge blocks, tiles, ReferenceBlackWhite, the 4:4 strip libtiff reads
    short), JPEG tiles of whole streams, old-style JPEG, signed, float with
    the floating-point predictor, 12-bit and FillOrder 2 16-bit samples from
    encoders.py, the JPEG streams from Pillow's JPEG encoder; CIELab from
    Pillow's writer; LZMA and ZSTD, which the port leaves to ROADMAP A16, as
    the refused files."""
    import io

    from PIL import Image

    def pillow(im, **kw):
        b = io.BytesIO()
        im.save(b, "TIFF", **kw)
        return b.getvalue()

    def jpeg(block, **kw):
        b = io.BytesIO()
        Image.fromarray(block.astype(np.uint8)).save(b, "JPEG", **kw)
        return b.getvalue()

    def page(h, w):  # text-like black marks on white, mode 1
        a = scene(rng, h, w, 1)[..., 0] > 90
        for _ in range(40):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            a[y0:y0 + rng.integers(2, 9), x0:x0 + rng.integers(3, 80)] = False
        return Image.fromarray(a)

    def set_short(data, tag, value):
        b = bytearray(data)
        at = int.from_bytes(b[4:8], "little")
        for i in range(int.from_bytes(b[at:at + 2], "little")):
            e = at + 2 + 12 * i
            if int.from_bytes(b[e:e + 2], "little") == tag:
                b[e + 8:e + 10] = value.to_bytes(2, "little")
        return bytes(b)

    files = {}
    rgb = Image.fromarray(scene(rng, 72, 96).astype(np.uint8))
    files["tiff_jpeg_rgb_tables_96x72.tif"] = pillow(rgb, compression="jpeg", quality=85)
    files["tiff_jpeg_ycbcr_tables_96x72.tif"] = pillow(
        Image.fromarray(scene(rng, 72, 96).astype(np.uint8)).convert("YCbCr"),
        compression="jpeg", quality=85)
    files["tiff_jpeg_gray_strips_80x60.tif"] = pillow(
        Image.fromarray(scene(rng, 60, 80, 1)[..., 0].astype(np.uint8)), compression="jpeg",
        strip_size=80 * 16)
    files["tiff_ccitt_g3_2d_320x240.tif"] = pillow(page(240, 320), compression="group3",
                                                   tiffinfo={292: 1})
    files["tiff_ccitt_g4_320x240.tif"] = pillow(page(240, 320), compression="group4")
    files["tiff_ccitt_rle_200x150.tif"] = pillow(page(150, 200), compression="tiff_ccitt")
    files["tiff_ccitt_rlew_minwhite_200x150.tif"] = set_short(
        pillow(page(150, 200), compression="tiff_raw_16"), 262, 0)
    files["tiff_bigtiff_lzw_100x80.tif"] = pillow(Image.fromarray(scene(rng, 80, 100).astype(
        np.uint8)), big_tiff=True, compression="tiff_lzw")
    files["tiff_float_f_deflate_64x48.tif"] = pillow(Image.fromarray(
        (scene(rng, 48, 64, 1)[..., 0] * 1.7 - 60).astype(np.float32), "F"),
        compression="tiff_adobe_deflate")
    files["tiff_int32_i_lzw_64x48.tif"] = pillow(Image.fromarray(
        (scene(rng, 48, 64, 1)[..., 0].astype(np.int32) * 3 - 200), "I"), compression="tiff_lzw")
    ycc = scene(rng, 67, 99)
    files["tiff_ycbcr22_lzw_tiles_99x67.tif"] = encode_tiff(ycc, 6, compression=5, ycbcr=(2, 2),
                                                           tile=(32, 32))
    files["tiff_ycbcr42_deflate_refbw_101x75.tif"] = encode_tiff(
        scene(rng, 75, 101), 6, compression=8, ycbcr=(4, 2), rows_per_strip=16,
        ref_bw=[(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)],
        luma=[(2126, 10000), (7152, 10000), (722, 10000)])
    files["tiff_ycbcr44_packbits_75x53.tif"] = encode_tiff(scene(rng, 53, 75), 6,
                                                          compression=32773, ycbcr=(4, 4),
                                                          rows_per_strip=8)
    files["tiff_jpeg_sub22_tiles_120x90.tif"] = encode_tiff(
        scene(rng, 90, 120), 6, compression=7, ycbcr=(2, 2), tile=(64, 64),
        jpeg=lambda b: jpeg(b, quality=80, subsampling=2))
    gray = scene(rng, 70, 90, 1)
    tables = jpeg_parts(jpeg(gray[:16, :16, 0], quality=75))[0]
    files["tiff_jpeg_minwhite_abbrev_90x70.tif"] = encode_tiff(
        gray, 0, compression=7, rows_per_strip=24, jpeg_tables=tables,
        jpeg=lambda b: jpeg_parts(jpeg(b[..., 0], quality=75))[1])
    stream = jpeg(scene(rng, 64, 96), quality=85, subsampling=2)
    files["tiff_ojpeg_jfif_96x64.tif"] = encode_tiff(
        np.zeros((64, 96, 3), np.uint8), 6, compression=6, jpeg=lambda b: stream,
        extra_tags={513: (4, [8]), 514: (4, [len(stream)])})
    files["tiff_s16_mm_deflate_pred_64x48.tif"] = encode_tiff(
        (scene(rng, 48, 64, 1) * 3 - 250).astype(np.int16), 1, bits=16, order=">", compression=8,
        predictor=2, sample_format=2)
    files["tiff_f32_mm_lzw_fppred_64x48.tif"] = encode_tiff(
        (scene(rng, 48, 64, 1) * 1.3 - 20).astype(np.float32), 1, bits=32, order=">",
        compression=5, predictor=3, sample_format=3, rows_per_strip=16)
    files["tiff_gray12_strips_64x48.tif"] = encode_tiff(scene(rng, 48, 64, 1) * 16, 1, bits=12,
                                                        rows_per_strip=16)
    files["tiff_gray16_fill2_64x48.tif"] = encode_tiff(scene(rng, 48, 64, 1) + 100, 1, bits=16,
                                                       fillorder=2, rows_per_strip=16)
    lab = np.stack([scene(rng, 48, 64, 1)[..., 0], scene(rng, 48, 64, 1)[..., 0] - 40,
                    scene(rng, 48, 64, 1)[..., 0] + 60], -1).clip(0, 255).astype(np.uint8)
    files["tiff_lab_lzw_64x48.tif"] = pillow(Image.frombytes("LAB", (64, 48), lab.tobytes()),
                                             compression="tiff_lzw")
    small = Image.fromarray(scene(rng, 48, 64).astype(np.uint8))
    files["tiff_lzma_refused_64x48.tif"] = pillow(small, compression="lzma")
    files["tiff_zstd_refused_64x48.tif"] = pillow(small, compression="zstd")
    return files


def digest(a):
    a = np.ascontiguousarray(a, np.uint8)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sum": int(a.sum(dtype=np.int64))}


def _encoder():
    """Build libjpeg_encoder.cpp (needs libjpeg's header and library)."""
    exe = os.path.join(tempfile.mkdtemp(), "libjpeg_encoder")
    subprocess.run(["g++", "-O2", "-o", exe, os.path.join(JPEG_DIR, "libjpeg_encoder.cpp"),
                    "-ljpeg"], check=True)
    return exe


def _webp_encoder():
    """Build libwebp_encoder.cpp (needs libwebp's header and library)."""
    exe = os.path.join(tempfile.mkdtemp(), "libwebp_encoder")
    subprocess.run(["g++", "-O2", "-o", exe, os.path.join(HERE, "libwebp_encoder.cpp"), "-lwebp"],
                   check=True)
    return exe


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from PIL import Image

    from fsvlm_tpu import native
    from fsvlm_tpu.data import transforms as jax_transforms
    from fsvlm_tpu.data.base_dataset import Datum
    from fsvlm_tpu.data.loader import RawDatasetWrapper

    if not native.native_available():
        raise SystemExit("fsvlm_tpu.native is not built (make -C native)")
    expected, truncated, refused = {}, [], []
    files = _files(np.random.default_rng(SEED), _encoder())
    files.update(_webp_files(np.random.default_rng(WEBP_SEED), _webp_encoder()))
    files.update(_tiff_files(np.random.default_rng(TIFF_SEED)))
    for name, data in files.items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        if name.startswith("truncated"):
            truncated.append(name)
            continue
        if "refused" in name:
            refused.append(name)
            continue
        im = Image.open(path)
        if "past_64k" in name:
            # Pillow 12.1 cannot read an arithmetic scan across its 64 KiB
            # read chunk; with the whole file in one read it can
            im.decodermaxblock = 1 << 26
        full = im.convert("RGB")
        raw = native.decode_file(path, PRE_SIZE)
        cache = RawDatasetWrapper([Datum(impath=path)], pre_size=PRE_SIZE)[0]["img"]
        view = jax_transforms._resize_center_crop(full, EVAL_SIZE,
                                                  jax_transforms._PIL_INTERP["bicubic"])
        expected[name] = {"full": digest(np.asarray(full)),
                          "raw256": None if raw is None else digest(raw),
                          "cache256": digest(cache), "eval224": digest(np.asarray(view))}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump({"digests": expected, "truncated": truncated, "refused": refused}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    names = [n for n in os.listdir(HERE) if not n.endswith((".py", ".json", ".cpp")) and
             not n.startswith("__")]
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in names)
    print(f"wrote {len(names)} fixtures and expected.json: {total} bytes in {HERE}")


if __name__ == "__main__":
    main()
