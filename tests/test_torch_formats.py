"""The port's BMP, Netpbm, GIF and TIFF decoders and its JPEG variants
(fsvlm_tpu_torch/csrc/*_decoder.cpp, through fsvlm_tpu_torch.native)
against their references, on the CPU: the decoders are host C++ built with
g++ at first use, so they run on the CPU too.  Every comparison is exact.

- ``read_image`` against Pillow's ``Image.open(path).convert("RGB")`` on
  files written at run time by ``tests/torch_fixtures/formats/encoders.py``
  (numpy, struct and zlib): every BMP header, depth, palette, bitfields and
  RLE layout; P1-P6 with comments and maxvals below, at and above 255; GIF
  frames with global and local tables, interlace, a frame smaller or larger
  than its screen, a transparent index, every minimum code size, a table
  left full; TIFF in both byte orders, uncompressed, PackBits, LZW (both
  styles) and Deflate, strips and tiles, both planar configurations, the
  predictor, every photometric the port reads, extra samples, FillOrder 2
  and the orientations; lossless JPEG with every predictor, point
  transforms and restarts.  Where Pillow refuses a layout, the port raises.
- the committed arithmetic-coded and block-smoothed JPEGs against Pillow,
  and their ``decode_file`` view against ``fsvlm_tpu.native.decode_file``;
- the loader's cache and eval views against the JAX package's
  ``RawDatasetWrapper`` and ``DatasetWrapper``;
- the committed fixtures under tests/torch_fixtures/formats against their
  committed digests, the check ``chip_smoke.py`` phase 23 makes on the card;
- truncated and corrupt files raising ``ValueError``, Pillow's bomb limit,
  the TIFF and JPEG kinds the port leaves to ROADMAP A16 raising
  ``NotImplementedError``, a WebP under a JPEG name read as Pillow reads it
  (tests/test_torch_webp.py holds WebP itself, tests/test_torch_tiff.py the
  TIFF kinds read through libtiff's other codecs); eight threads giving the
  same bytes.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from fsvlm_tpu import native as jax_native
from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.data import transforms as jax_transforms
from fsvlm_tpu.data.base_dataset import Datum as JaxDatum
from fsvlm_tpu.data.loader import DatasetWrapper as JaxWrapper
from fsvlm_tpu.data.loader import RawDatasetWrapper as JaxRaw
from fsvlm_tpu_torch import native
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.data import imageops, loader, transforms
from fsvlm_tpu_torch.data.base_dataset import Datum
from fsvlm_tpu_torch.utils import read_image

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "formats")
_spec = importlib.util.spec_from_file_location("format_encoders",
                                               os.path.join(FIXTURES, "encoders.py"))
enc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(enc)

with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _pillow(data):
    """Pillow's decode of the bytes, or the exception it raises."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - Pillow's refusal is the reference
        return e


def _same_as_pillow(tmp_path, data, name="x"):
    """The port's read_image of the bytes equals Pillow's, or both refuse
    (the port with ValueError: Pillow reads the file no more than it)."""
    path = tmp_path / name
    path.write_bytes(data)
    ref = _pillow(data)
    if isinstance(ref, Exception):
        with pytest.raises(ValueError):
            read_image(str(path))
        return None
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def _palette(rng, n):
    return rng.integers(0, 256, (n, 3))


# ------------------------------------------------------------------ BMP
H, W = 11, 13


def _bmp_case(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    header = int(case.split("_")[0][1:])
    kind = case.split("_", 1)[1]
    if kind in ("pal1", "pal4", "pal8"):
        bits = int(kind[3:])
        n = 1 << bits
        return enc.encode_bmp(rng.integers(0, n, (H, W)), bits, header=header,
                              palette=_palette(rng, n))
    if kind == "pal8_short":  # biClrUsed below 2^bits, indices past it
        return enc.encode_bmp(rng.integers(0, 256, (H, W)), 8, header=header,
                              palette=_palette(rng, 7))
    if kind == "gray8":
        return enc.encode_bmp(rng.integers(0, 256, (H, W)), 8, header=header,
                              palette=np.stack([np.arange(256)] * 3, -1))
    if kind == "bw1":
        return enc.encode_bmp(rng.integers(0, 2, (H, W)), 1, header=header,
                              palette=[(0, 0, 0), (255, 255, 255)])
    if kind == "bw8":  # Pillow reads the 8-bit rows of a black-and-white palette as 1 bit
        return enc.encode_bmp(rng.integers(0, 2, (H, W)), 8, header=header,
                              palette=[(0, 0, 0), (255, 255, 255)])
    if kind == "rgb24":
        return enc.encode_bmp(rng.integers(0, 256, (H, W, 3)), 24, header=header)
    if kind == "rgb16":
        return enc.encode_bmp(rng.integers(0, 65536, (H, W)), 16, header=header)
    if kind == "x32":
        return enc.encode_bmp(rng.integers(0, 256, (H, W, 4)), 32, header=header)
    if kind == "topdown24":
        return enc.encode_bmp(rng.integers(0, 256, (H, W, 3)), 24, header=header, top_down=True)
    if kind.startswith("bf"):
        masks = {"bf565": (0xF800, 0x7E0, 0x1F), "bf555": (0x7C00, 0x3E0, 0x1F),
                 "bfbgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                 "bfabgr": (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                 "bfrgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                 "bfodd": (0x3F, 0xFC0, 0xF000)}[kind]
        bits = 32 if len(masks) == 4 else 16
        px = rng.integers(0, 256, (H, W, 4)) if bits == 32 else rng.integers(0, 65536, (H, W))
        return enc.encode_bmp(px, bits, header=header, compression=3, masks=masks)
    if kind == "alphabitfields":  # compression 6: Pillow refuses it
        return enc.encode_bmp(rng.integers(0, 256, (H, W, 4)), 32, header=header, compression=6,
                              masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    rle4 = kind.startswith("rle4")
    bits, n = (4, 16) if rle4 else (8, 256)
    idx = np.repeat(rng.integers(0, n, (H, 5)), 3, axis=1)[:, :W]
    idx[3] = rng.integers(0, n, W)
    pal = _palette(rng, n)
    comp = 2 if rle4 else 1
    if kind.endswith("delta"):
        stream = enc.rle_encode(idx, rle4, deltas=[(2, 3, 4, 0), (5, 1, 2, 3)])
    elif kind.endswith("odd"):  # an odd RLE4 run, a run past the row, a short stream
        row = bytes([0, 5, 0x12, 0x34, 0x50, 0, 20, 0x77, 0, 0])
        stream = row * H + b"\x00\x01"
    elif kind.endswith("early"):
        stream = enc.rle_encode(idx, rle4)[:30] + b"\x00\x01"
    elif kind.endswith("topdown"):
        return enc.encode_bmp(idx, bits, header=header, compression=comp, palette=pal,
                              rle=enc.rle_encode(idx[::-1], rle4), top_down=True)
    else:
        stream = enc.rle_encode(idx, rle4)
    return enc.encode_bmp(idx, bits, header=header, compression=comp, palette=pal, rle=stream)


BMP_CASES = (
    [f"h12_{k}" for k in ("pal1", "pal4", "pal8", "pal8_short", "rgb24", "bw1")] +
    [f"h40_{k}" for k in ("pal1", "pal4", "pal8", "pal8_short", "gray8", "bw1", "bw8", "rgb24",
                          "rgb16", "x32", "topdown24", "bf565", "bf555", "bfbgra", "bfabgr",
                          "bfrgba", "bfodd", "alphabitfields", "rle8", "rle8_delta", "rle8_odd",
                          "rle8_early", "rle8_topdown", "rle4", "rle4_delta", "rle4_odd",
                          "rle4_early")] +
    [f"h{h}_{k}" for h in (52, 56, 64, 108, 124) for k in ("pal8", "x32", "bf565", "bfbgra",
                                                           "rle8", "rle4_delta")])


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_matches_pillow(tmp_path, case):
    _same_as_pillow(tmp_path, _bmp_case(case), "x.bmp")


# ------------------------------------------------------------------ Netpbm
PNM_CASES = [(1, 1, False), (1, 1, True), (4, 1, False), (2, 255, False), (2, 100, True),
             (2, 1000, False), (5, 255, False), (5, 7, True), (5, 1000, False), (5, 65535, False),
             (5, 4095, False), (3, 255, True), (3, 17, False), (3, 300, False), (6, 255, False),
             (6, 100, True), (6, 256, False), (6, 65535, False)]


@pytest.mark.parametrize("kind,maxval,comments", PNM_CASES)
def test_netpbm_matches_pillow(tmp_path, kind, maxval, comments):
    rng = np.random.default_rng(kind * 100003 + maxval)
    top = 2 if kind in (1, 4) else maxval + 1
    shape = (H, W, 3) if kind in (3, 6) else (H, W)
    data = enc.encode_pnm(rng.integers(0, top, shape), kind, maxval, comments=comments)
    got = _same_as_pillow(tmp_path, data, "x.ppm")
    assert got is not None


def test_netpbm_pillow_quirks_are_matched(tmp_path):
    """A comment inside a header token continues the token; a binary sample
    above maxval is clipped; a plain sample above it, and a plain bitmap
    byte other than 0 and 1, raise in both."""
    for data in (b"P5\n2 2\n1#c\n00\n\x00\x10\x64\xff", b"P6 1 1 2#x\n55 \x01\x02\x03",
                 b"P2\n2 2\n100\n1 2 3 101\n", b"P1\n2 2\n0101 2\n", b"P3 1 1 255 1 2 3"):
        _same_as_pillow(tmp_path, data, "q.pgm")


# ------------------------------------------------------------------ GIF
GIF_CASES = ["global", "local", "interlaced", "sub_transparent", "sub_background", "grows",
             "gray", "short_table", "no_table", "min_code_1", "min_code_2", "min_code_4",
             "full_table", "tiny"]


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_matches_pillow(tmp_path, case):
    rng = np.random.default_rng(sum(map(ord, case)))
    h, w = (1, 1) if case == "tiny" else (33, 27)
    mc = int(case[-1]) if case.startswith("min_code") else 8
    k = 1 << mc
    idx = rng.integers(0, k, (h, w))
    pal = _palette(rng, k)
    kw = {"global_palette": pal, "min_code": mc}
    if case == "local":
        kw = {"global_palette": _palette(rng, 4), "local_palette": pal, "min_code": mc}
    elif case == "interlaced":
        kw["interlace"] = True
    elif case == "sub_transparent":
        kw.update(local_palette=pal, global_palette=None, screen=(w + 9, h + 4), offset=(5, 3),
                  transparency=3, interlace=True)
    elif case == "sub_background":
        kw.update(screen=(w + 9, h + 4), offset=(5, 3), background=7)
    elif case == "grows":
        kw.update(screen=(w - 5, h - 10), offset=(2, 4))
    elif case == "gray":
        kw["global_palette"] = np.stack([np.arange(256)] * 3, -1)
    elif case == "short_table":
        kw.update(global_palette=pal[:4], table_bits=2)
    elif case == "no_table":
        kw.pop("global_palette")
    elif case == "full_table":
        idx = rng.integers(0, 256, (120, 150))
        kw["clear_when_full"] = False
    _same_as_pillow(tmp_path, enc.encode_gif(idx, **kw), "x.gif")


# ------------------------------------------------------------------ TIFF
def _tiff_case(case, order, comp):
    rng = np.random.default_rng(sum(map(ord, case + order)) + comp)
    h, w = 19, 23
    kw = dict(order=order, compression=comp)
    layout, _, rest = case.partition(":")
    if layout == "strips":
        kw["rows_per_strip"] = 4
    elif layout == "tiles":
        kw["tile"] = (16, 16)
    if rest.startswith("gray"):  # gray0/gray1 at bits: min-is-white / min-is-black
        photo, bits = int(rest[4]), int(rest[6:])
        return enc.encode_tiff(rng.integers(0, 1 << bits, (h, w)), photo, bits=bits, **kw)
    if rest == "rgbxx":
        return enc.encode_tiff(rng.integers(0, 256, (h, w, 5)), 2, extra=(0, 0), **kw)
    if rest.startswith("rgba"):
        bits, planar, extra = rest[4:].split(".")
        extra = None if extra == "none" else (int(extra),)
        return enc.encode_tiff(rng.integers(0, 1 << int(bits), (h, w, 4)), 2, bits=int(bits),
                               planar=int(planar), extra=extra, **kw)
    if rest.startswith("rgb"):
        bits, planar, pred = (int(x) for x in rest[3:].split("."))
        return enc.encode_tiff(rng.integers(0, 1 << bits, (h, w, 3)), 2, bits=bits,
                               planar=planar, predictor=pred, **kw)
    if rest.startswith("pal"):
        bits = int(rest[3:])
        return enc.encode_tiff(rng.integers(0, 1 << bits, (h, w)), 3, bits=bits,
                               colormap=rng.integers(0, 65536, (3, 1 << bits)), **kw)
    if rest.startswith("cmyk"):
        bits = int(rest[4:])
        return enc.encode_tiff(rng.integers(0, 1 << bits, (h, w, 4)), 5, bits=bits, **kw)
    if rest == "la":
        return enc.encode_tiff(rng.integers(0, 256, (h, w, 2)), 1, extra=(2,), **kw)
    if rest == "fill2":
        return enc.encode_tiff(rng.integers(0, 2, (h, w)), 1, bits=1, fillorder=2, **kw)
    if rest == "lzw_old":
        return enc.encode_tiff(rng.integers(0, 256, (h, w, 3)), 2, lzw_old_style=True, **kw)
    raise AssertionError(case)


TIFF_KINDS = ["gray0.1", "gray1.2", "gray0.4", "gray1.8", "gray0.8", "gray1.16", "rgb8.1.1",
              "rgb8.2.2", "rgb16.1.2", "rgb16.2.1", "rgba8.1.1", "rgba8.2.none", "rgba8.1.2",
              "rgba16.1.1", "pal1", "pal4", "pal8", "cmyk8", "cmyk16", "la", "rgbxx", "fill2"]
TIFF_CASES = ([("strip1:" + k, "<", c) for k in TIFF_KINDS for c in (1, 5)] +
              [("tiles:" + k, ">", c) for k in TIFF_KINDS for c in (32773, 8)] +
              [("strips:" + k, o, 32946) for k in ("rgb8.2.2", "rgba8.2.1", "gray1.16", "pal4")
               for o in "<>"] +
              [("strips:lzw_old", o, 5) for o in "<>"])


@pytest.mark.parametrize("case,order,comp", TIFF_CASES)
def test_tiff_matches_pillow(tmp_path, case, order, comp):
    _same_as_pillow(tmp_path, _tiff_case(case, order, comp), "x.tif")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_is_applied_as_pillow_applies_it(tmp_path, orientation):
    img = np.random.default_rng(orientation).integers(0, 256, (9, 14, 3))
    got = _same_as_pillow(tmp_path, enc.encode_tiff(img, 2, orientation=orientation,
                                                    compression=5), "o.tif")
    assert got.shape[:2] == ((14, 9) if orientation >= 5 else (9, 14))


# ------------------------------------------------------------------ JPEG variants
@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt,restart,channels", [(0, 0, 3), (2, 4, 3), (1, 0, 1)])
def test_lossless_jpeg_matches_pillow(tmp_path, predictor, pt, restart, channels):
    rng = np.random.default_rng(predictor * 7 + pt)
    y, x = np.mgrid[0:13, 0:19]
    img = np.clip((x * 9 + y * 5)[..., None] + rng.integers(-20, 20, (13, 19, channels)), 0, 255)
    data = enc.encode_lossless_jpeg(img[..., 0] if channels == 1 else img, predictor=predictor,
                                    pt=pt, restart_rows=restart)
    got = _same_as_pillow(tmp_path, data, "l.jpg")
    assert got is not None
    assert native.decode_file(str(tmp_path / "l.jpg"), 64) is None
    assert jax_native.decode_file(str(tmp_path / "l.jpg"), 64) is None


def test_lossless_jpeg_read_as_ycbcr_is_refused_as_by_pillow(tmp_path):
    data = enc.encode_lossless_jpeg(np.zeros((8, 8, 3), np.int64), jfif=True)
    assert isinstance(_pillow(data), OSError)
    path = tmp_path / "y.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="refuses too"):
        read_image(str(path))


JPEG_VARIANTS = sorted(n for n in EXPECTED["digests"] if n.startswith("jpeg_") and
                       EXPECTED["digests"][n]["raw256"] is not None)


@pytest.mark.parametrize("name", JPEG_VARIANTS)
@pytest.mark.parametrize("pre_size", [64, 224, 256])
def test_arithmetic_and_smoothed_jpegs_match_both_references(name, pre_size):
    """read_image against Pillow (libjpeg-turbo 3.1), decode_file against
    the JAX package's native build (libjpeg-turbo 2.1): the two smooth
    blocks at the image's edges differently, and each view follows its own."""
    path = os.path.join(FIXTURES, name)
    im = Image.open(path)
    im.decodermaxblock = 1 << 26  # the whole file in one read (see the next test)
    np.testing.assert_array_equal(read_image(path), np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(native.decode_file(path, pre_size),
                                  jax_native.decode_file(path, pre_size))


def test_an_arithmetic_scan_past_pillows_read_chunk():
    """Pillow 12.1 feeds libjpeg 64 KiB at a time, and libjpeg's arithmetic
    decoder cannot suspend: an arithmetic scan that runs past the first
    chunk raises in Pillow (the JAX package's read_image then retries it
    forever), while the JAX build's decode_file reads it.  The port reads
    it as libjpeg does: Pillow's pixels with the whole file in one read."""
    path = os.path.join(FIXTURES, "jpeg_arith_past_64k_444_480x360.jpg")
    assert os.path.getsize(path) > 1 << 16
    with open(path, "rb") as f:
        assert isinstance(_pillow(f.read()), OSError)
    im = Image.open(path)
    im.decodermaxblock = 1 << 26
    np.testing.assert_array_equal(read_image(path), np.asarray(im.convert("RGB")))
    assert jax_native.decode_file(path, 256) is not None


@pytest.mark.parametrize("marker,why", [(0xC5, "hierarchical"), (0xCB, "arithmetic lossless"),
                                        (0xC1, "12-bit")])
def test_jpeg_kinds_pillow_refuses_keep_their_refusal(tmp_path, marker, why):
    """Pillow 12.1 reads none of these (hierarchical and arithmetic lossless
    frames libjpeg-turbo refuses, 12-bit samples Pillow's plugin refuses),
    so the JAX package reads none: the port names ROADMAP A16 for them."""
    data = bytearray(enc.encode_lossless_jpeg(np.zeros((8, 8), np.int64)))
    sof = data.index(b"\xff\xc3")
    data[sof + 1] = marker
    if why == "12-bit":
        data[sof + 4] = 12
    assert isinstance(_pillow(bytes(data)), OSError)
    path = tmp_path / "k.jpg"
    path.write_bytes(bytes(data))
    for fn in (read_image, lambda p: native.decode_file(p, 64)):
        with pytest.raises(NotImplementedError, match="A16"):
            fn(str(path))


# ------------------------------------------------------------------ refusals and errors
def test_webp_named_jpg_is_read_and_unread_tiff_kinds_raise_naming_a16(tmp_path):
    """A WebP under a JPEG name is read as Pillow reads it; an uncompressed
    YCbCr TIFF raises ValueError as Pillow calls it truncated (its raw RGBX
    runs past the data); the compressions ROADMAP A16 keeps raise naming
    it."""
    webp = tmp_path / "x.jpg"  # the magic bytes decide, not the extension
    Image.fromarray(np.random.default_rng(2).integers(0, 256, (4, 4, 3), np.uint8)).save(
        webp, format="WEBP")
    np.testing.assert_array_equal(read_image(str(webp)), _pillow(webp.read_bytes()))
    assert native.decode_file(str(webp), 64) is None  # as the JAX package's libjpeg build
    rng = np.random.default_rng(3)
    path = os.path.join(FIXTURES, "truncated_tiff_ycbcr_raw_32x32.tif")
    assert isinstance(_pillow(open(path, "rb").read()), OSError)
    with pytest.raises(ValueError, match="corrupt or truncated TIFF"):
        read_image(path)
    path = os.path.join(FIXTURES, "tiff_lzma_refused_64x48.tif")
    with pytest.raises(NotImplementedError, match="LZMA.*A16"):
        read_image(path)
    assert native.decode_file(path, 64) is None  # no decode_file view of a TIFF at all
    for compression in (34925, 50000, 50001, 32809):
        data = bytearray(enc.encode_tiff(rng.integers(0, 256, (8, 8, 3)), 2))
        i = data.index(struct.pack("<HHI", 259, 3, 1))
        data[i + 8:i + 10] = struct.pack("<H", compression)
        path = tmp_path / f"c{compression}.tif"
        path.write_bytes(bytes(data))
        with pytest.raises(NotImplementedError, match="A16"):
            read_image(str(path))


@pytest.mark.parametrize("fmt", ["bmp", "pnm", "gif", "tiff", "lossless"])
def test_truncated_and_corrupt_files_raise_valueerror(tmp_path, fmt):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (40, 30, 3))
    whole = {"bmp": lambda: enc.encode_bmp(img, 24),
             "pnm": lambda: enc.encode_pnm(img, 6),
             "gif": lambda: enc.encode_gif(img[..., 0], global_palette=_palette(rng, 256)),
             "tiff": lambda: enc.encode_tiff(img, 2, compression=5),
             "lossless": lambda: enc.encode_lossless_jpeg(img)}[fmt]()
    for data in (whole[:len(whole) // 2], whole[:20]):
        path = tmp_path / f"t.{fmt}"
        path.write_bytes(data)
        assert isinstance(_pillow(data), (OSError, ValueError, SyntaxError, EOFError, IndexError,
                                          struct.error))
        with pytest.raises(ValueError, match="corrupt or truncated|refuses too"):
            read_image(str(path))


@pytest.mark.parametrize("fmt", ["bmp", "pnm", "gif", "tiff"])
def test_a_header_past_pillows_bomb_limit_raises(tmp_path, fmt):
    big = 20000
    data = {"bmp": struct.pack("<2sIHHIIiiHHIIiiII", b"BM", 0, 0, 0, 54, 40, big, big, 1, 24, 0,
                               0, 0, 0, 0, 0),
            "pnm": f"P6\n{big} {big}\n255\n".encode(),
            "gif": enc.encode_gif(np.zeros((1, 1), np.int64), screen=(big, big), min_code=2),
            "tiff": enc.encode_tiff(np.zeros((2, 2), np.int64), 1)}[fmt]
    if fmt == "tiff":
        data = bytearray(data)
        for tag in (256, 257):
            i = data.index(struct.pack("<HHI", tag, 3, 1))
            data[i + 8:i + 10] = struct.pack("<H", big)
        data = bytes(data)
    path = tmp_path / f"bomb.{fmt}"
    path.write_bytes(data)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path)
    with pytest.raises(ValueError, match="decompression bomb"):
        read_image(str(path))


def test_eight_threads_decode_the_same_bytes():
    paths = sorted(os.path.join(FIXTURES, n) for n in EXPECTED["digests"])
    serial = [read_image(p) for p in paths]
    with ThreadPoolExecutor(max_workers=8) as pool:
        for i, img in enumerate(pool.map(read_image, paths * 3)):
            np.testing.assert_array_equal(img, serial[i % len(paths)])


# ------------------------------------------------------------------ loader views
def _cfgs():
    def setup(cfg):
        cfg.INPUT.SIZE = (224, 224)
        cfg.INPUT.INTERPOLATION = "bicubic"
        cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
        cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
        cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
        return cfg

    return setup(jax_get_cfg_default()), setup(get_cfg_base())


FORMAT_FILES = sorted(n for n in EXPECTED["digests"] if not n.startswith("jpeg_"))


@pytest.mark.parametrize("name", FORMAT_FILES)
def test_cache_and_eval_views_match_the_jax_wrappers(name):
    path = os.path.join(FIXTURES, name)
    assert native.decode_file(path, 256) is None
    got = loader.RawDatasetWrapper([Datum(impath=path)], pre_size=128)[0]["img"]
    np.testing.assert_array_equal(got, JaxRaw([JaxDatum(impath=path)], pre_size=128)[0]["img"])
    jcfg, pcfg = _cfgs()
    got = loader.DatasetWrapper([Datum(impath=path)], transforms.TestTransform(pcfg))[0]["img"]
    ref = JaxWrapper([JaxDatum(impath=path)], jax_transforms.TestTransform(jcfg))[0]["img"]
    # the port's eval view is uint8 (it normalizes on the device); JAX's is
    # that view normalized on the host
    norm = (got.astype(np.float32) / 255.0 - np.asarray(pcfg.INPUT.PIXEL_MEAN, np.float32)) / (
        np.asarray(pcfg.INPUT.PIXEL_STD, np.float32))
    np.testing.assert_array_equal(np.asarray(ref), norm.astype(np.float32))


# ------------------------------------------------------------------ committed fixtures
def _digest(a):
    a = np.ascontiguousarray(a, np.uint8)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sum": int(a.sum(dtype=np.int64))}


@pytest.mark.parametrize("name", sorted(EXPECTED["digests"]))
def test_committed_fixtures_match_their_expected_digests(name):
    path = os.path.join(FIXTURES, name)
    want = EXPECTED["digests"][name]
    full = read_image(path)
    assert _digest(full) == want["full"]
    raw = native.decode_file(path, 256)
    assert (raw is None) == (want["raw256"] is None)
    if raw is not None:
        assert _digest(raw) == want["raw256"]
    cache = loader.RawDatasetWrapper([Datum(impath=path)], pre_size=256)[0]["img"]
    assert _digest(cache) == want["cache256"]
    assert _digest(imageops.resize_center_crop(full, (224, 224), "bicubic")) == want["eval224"]


def test_the_truncated_and_refused_fixtures_raise():
    assert EXPECTED["truncated"] == ["truncated_tiff_ycbcr_raw_32x32.tif",
                                     "truncated_gif_80x60.gif", "truncated_webp_97x61.webp"]
    for name, kind in zip(EXPECTED["truncated"], ("TIFF", "GIF", "WebP")):
        with pytest.raises(ValueError, match=f"corrupt or truncated {kind} data"):
            read_image(os.path.join(FIXTURES, name))
    assert EXPECTED["refused"] == ["tiff_lzma_refused_64x48.tif", "tiff_zstd_refused_64x48.tif"]
    for name in EXPECTED["refused"]:
        with pytest.raises(NotImplementedError, match="LZMA, ZSTD.*A16"):
            read_image(os.path.join(FIXTURES, name))
