"""The TIFF kinds the port's decoder reads through libtiff's codecs in
Pillow 12.1 (fsvlm_tpu_torch/csrc/tiff_decoder.cpp, ccitt_decoder.cpp and
jpeg_decoder.cpp, through fsvlm_tpu_torch.native), byte-equal to
``Image.open(path).convert("RGB")`` on the CPU, on files written at run time
by Pillow's own TIFF writer and by ``tests/torch_fixtures/formats/
encoders.py`` (the layouts Pillow does not write):

- BigTIFF in both byte orders (Pillow 12.1 reads "MM\\0+" as a classic
  header and so reads no big-endian BigTIFF: both refuse it);
- SampleFormat 2 and 3 (signed and float: modes I and F), 12- and 32-bit
  gray, 16-bit gray with FillOrder 2, uncompressed, LZW, Deflate with
  either predictor and PackBits, in both byte orders;
- YCbCr through libtiff's RGBA interface at every subsampling, in strips
  and tiles, edge blocks included, with its coefficients and reference
  black and white given or not; uncompressed YCbCr as Pillow's raw RGBX;
- JPEG-in-TIFF at photometric 6, 2, 1 and 0, strips and tiles, with and
  without JPEGTables, and old-style JPEG whose JPEGInterchangeFormat is a
  whole JFIF stream;
- CCITT: Modified Huffman RLE, T.4 one- and two-dimensional, T.6 and the
  word-aligned RLE, min-is-white and min-is-black, FillOrder 2, strips;
- seeded corruptions and truncations of the strips, read as Pillow reads
  them (a codec's error, libtiff's RGBA interface putting what decoded, a
  T.4 stream decoded again without EOLs);
- LZMA, ZSTD, WebP, Thunderscan and SGILog raising NotImplementedError
  naming ROADMAP A16.

Not held here, with their reasons: a T.6 strip whose data ends before its
last row (Pillow's rows past it are its buffer's uninitialized bytes) and a
JPEG-in-TIFF scan with corrupt entropy-coded data (libjpeg warns and goes
on inside libtiff; the port raises ValueError).
"""

import importlib.util
import io
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from fsvlm_tpu_torch import native
from fsvlm_tpu_torch.utils import read_image

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "formats")
_spec = importlib.util.spec_from_file_location("format_encoders",
                                               os.path.join(FIXTURES, "encoders.py"))
enc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(enc)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _same_as_pillow(tmp_path, data, name="x.tif"):
    """read_image of the bytes (from a file, as Pillow reads them here)
    equals Pillow's decode, or both raise (the port ValueError)."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except Exception:  # noqa: BLE001 - Pillow's refusal is the reference
        with pytest.raises(ValueError):
            read_image(str(path))
        return None
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def _pillow_tiff(im, **kw):
    b = io.BytesIO()
    im.save(b, "TIFF", **kw)
    return b.getvalue()


def _scene(rng, h, w, c=3):
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([40 + 150 * x / w + rng.normal(0, 9, (h, w)) for _ in range(c)], -1)
    a += (30 * np.sin(y / 4.0))[..., None]
    return np.clip(a, 0, 255).round().astype(np.uint8)


def _ycc(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([40 + 150 * x / w + rng.normal(0, 9, (h, w)), 128 + 90 * np.sin(y / 5.0),
                  128 + 80 * np.cos(x / 7.0)], -1)
    return np.clip(a, 0, 255).round().astype(np.int64)


def _pillow_jpeg(block, **kw):
    b = io.BytesIO()
    Image.fromarray(block[..., 0] if block.shape[2] == 1 else block).save(b, "JPEG", **kw)
    return b.getvalue()


def _doc(rng, h, w):
    """A page of text-like black marks on white, with speckle: mode 1."""
    a = np.ones((h, w), bool)
    for _ in range(12):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        a[y0:y0 + rng.integers(1, 12), x0:x0 + rng.integers(1, 60)] = False
    a ^= rng.random((h, w)) < 0.02
    return Image.fromarray(a)


def _set_short(data, tag, value):
    """A classic little-endian TIFF with one SHORT or LONG tag's value set."""
    b = bytearray(data)
    at = struct.unpack("<I", b[4:8])[0]
    for i in range(struct.unpack("<H", b[at:at + 2])[0]):
        e = at + 2 + 12 * i
        t, typ = struct.unpack("<HH", b[e:e + 4])
        if t == tag:
            b[e + 8:e + 12] = struct.pack("<H" if typ == 3 else "<I", value).ljust(4, b"\0")
            return bytes(b)
    raise KeyError(tag)


# ------------------------------------------------------------------ BigTIFF
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("comp,pred", [(1, 1), (5, 2), (8, 1), (32773, 1)])
@pytest.mark.parametrize("order", ["<", ">"])
def test_bigtiff_matches_pillow(tmp_path, order, comp, pred, layout):
    rng = np.random.default_rng(comp + pred)
    kw = dict(rows_per_strip=7) if layout == "strips" else dict(tile=(16, 16))
    got = _same_as_pillow(tmp_path, enc.encode_tiff(rng.integers(0, 256, (29, 35, 3)), 2,
                                                    order=order, compression=comp,
                                                    predictor=pred, big=True, **kw))
    assert (got is None) == (order == ">")  # Pillow reads no big-endian BigTIFF


@pytest.mark.parametrize("strip_size", [None, 45 * 3 * 4])
@pytest.mark.parametrize("mode", ["RGB", "L", "I;16"])
def test_bigtiff_from_pillows_writer(tmp_path, mode, strip_size):
    """Pillow's own BigTIFF (its writer makes one uncompressed; compressed,
    through libtiff, a classic TIFF)."""
    im = Image.fromarray(_scene(np.random.default_rng(1), 37, 45)).convert(mode)
    data = _pillow_tiff(im, big_tiff=True, **({} if strip_size is None else
                                              {"strip_size": strip_size}))
    assert data[:4] == b"II+\x00"
    assert _same_as_pillow(tmp_path, data) is not None


# ------------------------------------------------------------------ sample kinds
def _kind_samples(rng, kind, h, w):
    """(samples, photometric, bits, SampleFormat) of a sample kind."""
    if kind == "s8":
        return rng.integers(0, 256, (h, w)), 1, 8, 2
    if kind == "s16":
        return rng.integers(-400, 700, (h, w)).astype(np.int16), 1, 16, 2
    if kind == "s32":
        return rng.integers(-400, 700, (h, w)).astype(np.int32), 1, 32, 2
    if kind in ("f32", "f32w"):
        f = rng.normal(100, 130, (h, w)).astype(np.float32)
        f[0, :5] = [np.nan, np.inf, -np.inf, -0.7, 254.99]
        return f, 1 if kind == "f32" else 0, 32, 3
    if kind == "u32":
        return rng.integers(0, 2 ** 32, (h, w), dtype=np.uint64).astype(np.uint32), 1, 32, None
    if kind == "u12":
        return rng.integers(0, 4096, (h, w)), 1, 12, None
    raise AssertionError(kind)


SAMPLE_KINDS = ["s8", "s16", "s32", "f32", "f32w", "u32", "u12"]


@pytest.mark.parametrize("comp,pred", [(1, 1), (5, 1), (8, 2), (32946, 1), (32773, 1)])
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("kind", SAMPLE_KINDS)
def test_signed_float_12_and_32_bit_samples_match_pillow(tmp_path, kind, order, comp, pred):
    rng = np.random.default_rng(sum(map(ord, kind + order)) + comp)
    samples, photo, bits, sf = _kind_samples(rng, kind, 29, 35)
    layout = dict(rows_per_strip=8) if comp != 8 else dict(tile=(16, 16))
    _same_as_pillow(tmp_path, enc.encode_tiff(samples, photo, bits=bits, order=order,
                                              compression=comp, predictor=pred, sample_format=sf,
                                              **layout))


@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("comp", [5, 8])
@pytest.mark.parametrize("order", ["<", ">"])
def test_float_samples_with_the_floating_point_predictor(tmp_path, order, comp, layout):
    rng = np.random.default_rng(comp)
    f = rng.normal(100, 130, (21, 33)).astype(np.float32)
    kw = dict(rows_per_strip=5) if layout == "strips" else dict(tile=(16, 16))
    got = _same_as_pillow(tmp_path, enc.encode_tiff(f, 1, bits=32, order=order, compression=comp,
                                                    predictor=3, sample_format=3, **kw))
    assert got is not None
    # integer samples take no floating-point predictor: libtiff fails them
    assert _same_as_pillow(tmp_path, enc.encode_tiff(rng.integers(0, 255, (9, 9)), 1,
                                                     compression=comp, predictor=3)) is None


@pytest.mark.parametrize("comp,pred", [(1, 1), (5, 1), (8, 2), (32773, 1)])
@pytest.mark.parametrize("order", ["<", ">"])
def test_16_bit_gray_with_fillorder_2(tmp_path, order, comp, pred):
    rng = np.random.default_rng(comp)
    got = _same_as_pillow(tmp_path, enc.encode_tiff(rng.integers(0, 700, (29, 35)), 1, bits=16,
                                                    order=order, compression=comp,
                                                    predictor=pred, fillorder=2))
    assert (got is None) == (order == ">")  # Pillow's table: II min-is-black only


@pytest.mark.parametrize("comp", [None, "tiff_lzw", "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["F", "I", "I;16", "I;16B"])
def test_sample_modes_from_pillows_writer(tmp_path, mode, comp):
    rng = np.random.default_rng(len(mode))
    if mode == "F":
        im = Image.fromarray(rng.normal(100, 120, (23, 31)).astype(np.float32), "F")
    elif mode == "I":
        im = Image.fromarray(rng.integers(-300, 600, (23, 31)).astype(np.int32), "I")
    else:
        dtype = "<u2" if mode == "I;16" else ">u2"
        im = Image.frombytes(mode, (31, 23), rng.integers(0, 600, (23, 31)).astype(dtype).tobytes())
    data = _pillow_tiff(im, **({} if comp is None else {"compression": comp}))
    assert _same_as_pillow(tmp_path, data) is not None


# ------------------------------------------------------------------ YCbCr
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("h,w", [(32, 32), (29, 35), (31, 17)])
@pytest.mark.parametrize("comp", [5, 8, 32773])
@pytest.mark.parametrize("sub", ["11", "21", "22", "42", "44", "41", "12", "14", "24"])
def test_ycbcr_matches_pillow_at_every_subsampling(tmp_path, sub, comp, h, w, layout):
    """Subsampled blocks through TIFFRGBAImage: each pixel its own Y and its
    block's Cb and Cr, libtiff's edge blocks (its 4:4 tiles skip 10 bytes a
    hidden block, a strip reads whole scanlines of a row of blocks / vs);
    4:1 vertical and 2:4 have no put function: both refuse them."""
    rng = np.random.default_rng(int(sub) + comp + h)
    kw = dict(rows_per_strip=8) if layout == "strips" else dict(tile=(16, 16))
    got = _same_as_pillow(tmp_path, enc.encode_tiff(_ycc(rng, h, w), 6, compression=comp,
                                                    ycbcr=(int(sub[0]), int(sub[1])), **kw))
    assert (got is None) == (sub in ("14", "24"))


@pytest.mark.parametrize("sub", ["11", "22", "42"])
@pytest.mark.parametrize("ref_bw,luma", [
    ([(15, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)], None),
    (None, [(2126, 10000), (7152, 10000), (722, 10000)]),
    ([(1, 3), (510, 2), (100, 1), (7, 0), (256, 1), (0, 1)],
     [(2990, 10000), (5870, 10000), (1140, 10000)]),
], ids=["bt601_ranges", "bt709_luma", "odd_rationals"])
def test_ycbcr_coefficients_and_reference_black_white(tmp_path, sub, ref_bw, luma):
    rng = np.random.default_rng(int(sub))
    got = _same_as_pillow(tmp_path, enc.encode_tiff(
        _ycc(rng, 29, 35), 6, compression=5, ycbcr=(int(sub[0]), int(sub[1])), ref_bw=ref_bw,
        luma=luma, rows_per_strip=16))
    assert got is not None


@pytest.mark.parametrize("orientation", range(1, 9))
def test_ycbcr_orientation_is_pillows_exif_transpose(tmp_path, orientation):
    rng = np.random.default_rng(orientation)
    got = _same_as_pillow(tmp_path, enc.encode_tiff(_ycc(rng, 29, 35), 6, compression=5,
                                                    ycbcr=(2, 2), rows_per_strip=8,
                                                    orientation=orientation))
    assert got.shape[:2] == ((35, 29) if orientation >= 5 else (29, 35))


@pytest.mark.parametrize("sub", ["11", "22"])
def test_ycbcr_predictor_and_uncompressed(tmp_path, sub):
    """The horizontal predictor over libtiff's scanlines of a row of blocks;
    an uncompressed YCbCr file is Pillow's raw decoder with rawmode RGBX
    (four bytes a pixel, no conversion), which runs past the data: both
    raise, the port with ValueError, as Pillow calls it truncated."""
    rng = np.random.default_rng(int(sub))
    ss = (int(sub[0]), int(sub[1]))
    assert _same_as_pillow(tmp_path, enc.encode_tiff(_ycc(rng, 29, 35), 6, compression=8,
                                                     ycbcr=ss, predictor=2,
                                                     rows_per_strip=8)) is not None
    assert _same_as_pillow(tmp_path, enc.encode_tiff(_ycc(rng, 29, 35), 6, ycbcr=ss)) is None


@pytest.mark.parametrize("sub", [(1, 1), (2, 2)], ids=["11", "22"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("comp", [5, 8, 32773, 7])
def test_ycbcr_in_separate_planes(tmp_path, comp, layout, sub):
    """PlanarConfiguration 2: libtiff's RGBA interface puts separate YCbCr
    planes at 1:1 only (putseparate8bitYCbCr11tile; a JPEG plane is one
    component, unconverted): other subsamplings fail in both."""
    rng = np.random.default_rng(comp + len(layout))
    img = _ycc(rng, 29, 35)
    kw = dict(rows_per_strip=16) if layout == "strips" else dict(tile=(16, 16))
    if comp == 7:
        kw["jpeg"] = lambda block: _pillow_jpeg(block.astype(np.uint8), quality=80)
    got = _same_as_pillow(tmp_path, enc.encode_tiff(img, 6, compression=comp, planar=2,
                                                    extra_tags={530: (3, list(sub))}, **kw))
    assert (got is None) == (sub != (1, 1))


# ------------------------------------------------------------------ JPEG
@pytest.mark.parametrize("tables", [True, False], ids=["tables", "whole"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("h,w", [(40, 48), (37, 45)])
@pytest.mark.parametrize("photometric,sub", [(6, 0), (6, 1), (6, 2), (2, 0), (1, None), (0, None)])
def test_jpeg_in_tiff_matches_pillow(tmp_path, photometric, sub, h, w, layout, tables):
    """Compression 7: each strip or tile a JPEG stream (Pillow's JPEG
    encoder's, split into JPEGTables and an abbreviated image as libtiff
    writes them, or whole); YCbCr converted by libjpeg (fancy upsampling),
    RGB and gray samples as stored."""
    rng = np.random.default_rng(photometric * 7 + (sub or 0) + h)
    img = _scene(rng, h, w, 1 if photometric in (0, 1) else 3)
    opts = dict(quality=80) if sub is None else dict(quality=80, subsampling=sub)
    kw = dict(rows_per_strip=16) if layout == "strips" else dict(tile=(16, 16))
    if photometric == 6:
        kw["ycbcr"] = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[sub]
    if tables:
        kw["jpeg_tables"] = enc.jpeg_parts(_pillow_jpeg(img[:16, :16], **opts))[0]

        def segment(block):
            return enc.jpeg_parts(_pillow_jpeg(block, **opts))[1]
    else:
        def segment(block):
            return _pillow_jpeg(block, **opts)
    got = _same_as_pillow(tmp_path, enc.encode_tiff(img, photometric, compression=7,
                                                    jpeg=segment, **kw))
    assert (got is None) == (photometric == 2 and sub != 0)  # libtiff: RGB is not subsampled


@pytest.mark.parametrize("strips", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L"])
def test_jpeg_from_pillows_writer(tmp_path, mode, strips):
    im = Image.fromarray(_scene(np.random.default_rng(3), 37, 45)).convert(mode)
    kw = dict(strip_size=45 * 3 * 8) if strips else {}
    assert _same_as_pillow(tmp_path, _pillow_tiff(im, compression="jpeg", **kw)) is not None


@pytest.mark.parametrize("tag,stream", [((1, 1), 2), ((2, 2), 0)], ids=["exceeds", "less"])
def test_jpeg_sampling_other_than_the_tags_is_refused(tmp_path, tag, stream):
    """libtiff refuses a luma sampling that exceeds YCbCrSubsampling, and
    fails a smaller one after its warning: both raise."""
    img = _scene(np.random.default_rng(4), 40, 48)
    assert _same_as_pillow(tmp_path, enc.encode_tiff(
        img, 6, compression=7, ycbcr=tag, rows_per_strip=16,
        jpeg=lambda b: _pillow_jpeg(b, subsampling=stream))) is None


def test_jpeg_last_strip_of_the_full_strip_height(tmp_path):
    img = _scene(np.random.default_rng(5), 37, 48)
    got = _same_as_pillow(tmp_path, enc.encode_tiff(
        img, 6, compression=7, ycbcr=(2, 2), rows_per_strip=16,
        jpeg=lambda b: _pillow_jpeg(np.pad(b, ((0, 16 - b.shape[0]), (0, 0), (0, 0)),
                                           mode="edge"), subsampling=2)))
    assert got is not None


def _ojpeg(stream, h, w, **kw):
    return enc.encode_tiff(np.zeros((h, w, 3), np.uint8), 6, compression=6,
                           jpeg=lambda block: stream,
                           extra_tags={513: (4, [8]), 514: (4, [len(stream)])}, **kw)


@pytest.mark.parametrize("tag", [None, (2, 2), (1, 1)])
@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("h,w", [(32, 48), (29, 35), (17, 70)])
def test_old_style_jpeg_matches_pillow(tmp_path, h, w, sub, tag):
    """Compression 6 whose JPEGInterchangeFormat is a whole JFIF stream:
    libjpeg's raw (not upsampled) samples packed as YCbCr blocks at the
    stream's subsampling, then libtiff's YCbCr to RGB."""
    rng = np.random.default_rng(h + sub)
    stream = _pillow_jpeg(_scene(rng, h, w), quality=85, subsampling=sub)
    assert _same_as_pillow(tmp_path, _ojpeg(stream, h, w, ycbcr=tag)) is not None


def test_old_style_jpeg_past_one_strip_is_left_to_a16(tmp_path):
    stream = _pillow_jpeg(_scene(np.random.default_rng(6), 32, 48), subsampling=2)
    path = tmp_path / "o.tif"
    path.write_bytes(_ojpeg(stream, 32, 48, rows_per_strip=16))
    with pytest.raises(NotImplementedError, match="A16"):
        read_image(str(path))


# ------------------------------------------------------------------ CCITT
CCITT = ["tiff_ccitt", "group3", "group4", "tiff_raw_16"]


@pytest.mark.parametrize("variant", ["plain", "min_is_white", "fill_order_2", "strips"])
@pytest.mark.parametrize("h,w", [(40, 64), (37, 45), (61, 1700), (5, 2600)])
@pytest.mark.parametrize("comp", CCITT)
def test_ccitt_matches_pillow(tmp_path, comp, h, w, variant):
    """Pillow writes each CCITT compression from mode 1 (min-is-black); the
    same file as min-is-white, and read with FillOrder 2 where the tag is
    written, must read as Pillow reads it."""
    im = _doc(np.random.default_rng(h + w + len(comp)), h, w)
    kw = dict(strip_size=((w + 7) // 8) * 7) if variant == "strips" else {}
    data = _pillow_tiff(im, compression=comp, **kw)
    if variant == "min_is_white":
        data = _set_short(data, 262, 0)
    elif variant == "fill_order_2" and 266 in Image.open(io.BytesIO(data)).tag_v2:
        data = _set_short(data, 266, 2)
    got = _same_as_pillow(tmp_path, data)
    # libtiff fails its own word-aligned RLE at some widths: both raise there
    assert got is not None or comp == "tiff_raw_16"


@pytest.mark.parametrize("options", [1, 4, 5], ids=["2d", "fill_bits", "2d_fill_bits"])
@pytest.mark.parametrize("h,w", [(40, 64), (61, 1700)])
def test_ccitt_t4_options(tmp_path, h, w, options):
    im = _doc(np.random.default_rng(h + options), h, w)
    data = _pillow_tiff(im, compression="group3", tiffinfo={292: options})
    assert _same_as_pillow(tmp_path, data) is not None


# ------------------------------------------------------------------ corrupt data
def _base(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    im1 = Image.fromarray(rng.random((40, 64)) < 0.3)
    if kind in CCITT or kind == "group3_2d":
        return _pillow_tiff(im1, compression=kind.replace("_2d", ""),
                            **({"tiffinfo": {292: 1}} if kind == "group3_2d" else {}))
    if kind == "ycbcr_lzw":
        return enc.encode_tiff(_ycc(rng, 29, 35), 6, compression=5, ycbcr=(2, 2), rows_per_strip=8)
    if kind == "ycbcr_packbits_tiles":
        return enc.encode_tiff(_ycc(rng, 29, 35), 6, compression=32773, ycbcr=(4, 2),
                               tile=(16, 16))
    if kind == "s16_mm_deflate":
        return enc.encode_tiff(rng.integers(-300, 300, (20, 30)).astype(np.int16), 1, bits=16,
                               order=">", compression=8, predictor=2, sample_format=2)
    if kind == "f32_lzw":
        return _pillow_tiff(Image.fromarray(rng.normal(0, 200, (20, 30)).astype(np.float32), "F"),
                            compression="tiff_lzw")
    raise AssertionError(kind)


CORRUPT_KINDS = ["tiff_ccitt", "group3", "group3_2d", "tiff_raw_16", "ycbcr_lzw",
                 "ycbcr_packbits_tiles", "s16_mm_deflate", "f32_lzw"]


@pytest.mark.parametrize("trial", range(6))
@pytest.mark.parametrize("kind", CORRUPT_KINDS)
def test_corrupt_and_truncated_strips_read_as_pillow_reads_them(tmp_path, kind, trial):
    """Seeded corruptions of a strip's or tile's bytes (and, every third
    trial, its byte count cut short) read as Pillow reads them: a codec
    error fails the image, libtiff's RGBA interface (YCbCr) puts what
    decoded and zeros past it, a Deflate stream is read only as far as its
    output fills, a T.4 stream whose EOL search runs out is decoded again
    from the strip's start without EOLs."""
    data = _base(kind)
    rng = np.random.default_rng(1000 * len(kind) + trial)
    tags = Image.open(io.BytesIO(data)).tag_v2
    offsets, counts = tags.get(273) or tags.get(324), tags.get(279) or tags.get(325)
    j = int(rng.integers(0, len(offsets)))
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        d[int(rng.integers(offsets[j], offsets[j] + counts[j]))] = int(rng.integers(0, 256))
    if trial % 3 == 0 and len(counts) == 1 and data[:4] == b"II*\x00":
        d = bytearray(_set_short(bytes(d), 279, int(rng.integers(1, counts[0]))))
    _same_as_pillow(tmp_path, bytes(d))


# ------------------------------------------------------------------ ROADMAP A16
@pytest.mark.parametrize("compression", ["lzma", "zstd", 50001, 32809, 34676, 34677])
def test_the_compressions_left_to_a16_raise_naming_it(tmp_path, compression):
    """LZMA and ZSTD from Pillow's writer (which it reads back), and WebP,
    Thunderscan and SGILog set on an uncompressed file: NotImplementedError
    naming ROADMAP A16 and the five kinds it keeps."""
    im = Image.fromarray(_scene(np.random.default_rng(7), 24, 32))
    if isinstance(compression, str):
        data = _pillow_tiff(im, compression=compression)
        assert np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).shape == (24, 32, 3)
    else:
        data = _set_short(enc.encode_tiff(np.asarray(im), 2), 259, compression)
    path = tmp_path / "a16.tif"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match="LZMA, ZSTD, WebP, Thunderscan or SGILog.*A16"):
        read_image(str(path))
    assert native.decode_file(str(path), 64) is None


# ------------------------------------------------------------------ LAB
@pytest.mark.parametrize("comp", [None, "tiff_lzw", "tiff_adobe_deflate", "packbits"])
def test_lab_matches_pillows_littlecms_transform(tmp_path, comp):
    """CIELab (photometric 8) converts to RGB through LittleCMS's Lab v4 to
    sRGB transform in Pillow: every L on one image, random a and b, and the
    ends of each axis, uncompressed and through libtiff."""
    rng = np.random.default_rng(8)
    lab = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    lab[0, :, 0] = np.arange(96) * 255 // 95
    lab[1, :8] = [[0, 0, 0], [255, 0, 0], [0, 255, 255], [255, 255, 255], [128, 128, 128],
                  [255, 127, 127], [0, 128, 127], [100, 255, 0]]
    im = Image.frombytes("LAB", (96, 64), lab.tobytes())
    data = _pillow_tiff(im, **({} if comp is None else {"compression": comp}))
    assert Image.open(io.BytesIO(data)).mode == "LAB"
    assert _same_as_pillow(tmp_path, data) is not None


@pytest.mark.parametrize("planar,tile", [(1, (16, 16)), (2, None)])
def test_lab_tiles_and_planes(tmp_path, planar, tile):
    rng = np.random.default_rng(9)
    samples = rng.integers(0, 256, (29, 35, 3))
    kw = dict(tile=tile) if tile else dict(rows_per_strip=8)
    for comp in (1, 5):
        _same_as_pillow(tmp_path, enc.encode_tiff(samples, 8, compression=comp, planar=planar,
                                                  **kw))


@pytest.mark.parametrize("quarter", range(4))
def test_lab_every_input_matches_pillow(tmp_path, quarter):
    """Every one of the 2^24 (L, a, b) byte triples, a quarter of them (the
    top two bits of L) per case, in a 2048 x 2048 CIELab TIFF: the port's
    reproduction of LittleCMS's Lab -> sRGB transform equals Pillow's."""
    v = np.arange(quarter << 22, (quarter + 1) << 22, dtype=np.uint32)
    lab = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    data = _pillow_tiff(Image.frombytes("LAB", (2048, 2048), lab.tobytes()))
    assert _same_as_pillow(tmp_path, data) is not None
