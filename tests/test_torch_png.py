"""The port's PNG decoder (fsvlm_tpu_torch/csrc/png_decoder.cpp, through
fsvlm_tpu_torch.native) against its references, on the CPU: the decoder is
host C++ built with g++ at first use, so it runs on the CPU too.  Every
comparison is exact (byte equality).

- ``read_image`` against Pillow's ``Image.open(path).convert("RGB")`` on PNGs
  written at run time by the fixtures' own encoder (zlib and struct): every
  colour type and bit depth, plain and Adam7, each filter alone and all
  five cycled, the stream split over many IDAT chunks and with empty ones,
  tRNS, a short PLTE, odd sizes and ancillary chunks (APNG's among them);
- the inflate against Python's zlib on stored, fixed and dynamic blocks;
- the errors: truncated data, a bad IHDR CRC, bad zlib data, methods the
  PNG specification does not define;
- a PNG under a ``.jpg`` name: the device-aug cache view against the JAX
  package's ``RawDatasetWrapper`` (its PIL branch);
- eight threads decoding at once give the same bytes;
- the committed fixtures under tests/torch_fixtures/png against their
  committed digests, the check ``chip_smoke.py`` phase 17 makes on the card.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from fsvlm_tpu.data.base_dataset import Datum as JaxDatum
from fsvlm_tpu.data.loader import RawDatasetWrapper as JaxRaw
from fsvlm_tpu_torch import native
from fsvlm_tpu_torch.data import imageops, loader
from fsvlm_tpu_torch.data.base_dataset import Datum
from fsvlm_tpu_torch.utils import read_image

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "png")
_spec = importlib.util.spec_from_file_location("png_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
png = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(png)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _pillow(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _pillow_of(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# (colour type, bit depth): every combination the PNG specification defines
LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
           (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
NAMES = {0: "gray", 2: "rgb", 3: "palette", 4: "gray_alpha", 6: "rgba"}
SIZES = [(1, 1), (5, 3), (17, 33)]  # (h, w): 1x1, 3x5 and 33x17


def _ancillary(h, w):
    """Chunks that convert("RGB") ignores, and an APNG's animation control
    and first frame control: the IDAT image is the default one, frame 0."""
    return [(b"gAMA", struct.pack(">I", 45455)), (b"sRGB", b"\x00"),
            (b"tEXt", b"Comment\x00written by the test"), (b"acTL", struct.pack(">II", 1, 0)),
            (b"fcTL", struct.pack(">IIIIIHHBB", 0, w, h, 0, 0, 1, 1, 0, 0))]


def _trns(color, depth, n_pal):
    if color == 3:
        return bytes(range(0, 256, 256 // n_pal))[:n_pal]
    if color == 0:
        return struct.pack(">H", (1 << depth) - 1)
    if color == 2:
        return struct.pack(">HHH", 1, 2, 3)
    return None  # no tRNS with an alpha channel


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{NAMES[c]}{d}" for c, d in LAYOUTS])
def test_read_image_matches_pillow(tmp_path, layout, interlace):
    """Each variant byte-equal to Pillow: every filter alone and the five
    cycled; the stream in 7- and 3-byte IDATs with empty ones between, in
    one IDAT, and behind ancillary chunks; tRNS (dropped by convert);
    palettes shorter than the indices reach (Pillow's zeros past them)."""
    color, depth = layout
    rng = np.random.RandomState(100 * color + depth + interlace)
    k = 0
    for h, w in SIZES:
        samples = rng.randint(0, 1 << depth, (h, w, png.CHANNELS[color]))
        extra = {}
        if color == 3:
            n_pal = max(1, (1 << depth) // 2)
            extra["palette"] = rng.randint(0, 256, (n_pal, 3))
            extra["trns"] = _trns(color, depth, n_pal)
        elif color in (0, 2):
            extra["trns"] = _trns(color, depth, 0)
        variants = [dict(filters=(f,)) for f in range(5)] + [
            dict(filters=(0, 1, 2, 3, 4), idat_sizes=[7, 3], empty_idat=True),
            dict(filters=(4, 3, 2, 1, 0), ancillary=_ancillary(h, w)),
        ]
        for v in variants:
            path = tmp_path / f"{k}.png"
            path.write_bytes(png.encode_png(samples, color, depth, interlace=interlace, **extra,
                                            **v))
            ref = _pillow(path)
            got = read_image(str(path))
            assert got.dtype == np.uint8 and got.shape == ref.shape == (h, w, 3)
            np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w} {v}")
            k += 1


def test_pillow_quirks_are_matched(tmp_path):
    """The conversions a decoder written from the PNG specification alone
    gets wrong, each against Pillow: 16-bit gray clips to 255 (mode I;16),
    16-bit RGB takes the high byte, 2-bit gray scales by 85, and a palette
    index past a short PLTE gives (0, 0, 0)."""
    cases = {
        "gray16": (np.array([[0x0100, 0x8000, 0xFFFF, 0x00FE, 0x00FF]]), 0, 16, {},
                   [255, 255, 255, 254, 255]),
        "rgb16": (np.array([[[0x1234, 0xABCD, 0x00FF]]]), 2, 16, {}, [[18, 171, 0]]),
        "gray2": (np.array([[0, 1, 2, 3]]), 0, 2, {}, [0, 85, 170, 255]),
        "short_plte": (np.array([[0, 1, 2, 3]]), 3, 8,
                       {"palette": [[10, 20, 30], [40, 50, 60]]},
                       [[10, 20, 30], [40, 50, 60], [0, 0, 0], [0, 0, 0]]),
    }
    for name, (samples, color, depth, extra, want) in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(png.encode_png(samples, color, depth, **extra))
        want = np.asarray(want, np.uint8)
        want = (np.stack([want] * 3, -1) if want.ndim == 1 else want)[None]
        np.testing.assert_array_equal(_pillow(path), want, err_msg=name)
        np.testing.assert_array_equal(read_image(str(path)), want, err_msg=name)


@pytest.mark.parametrize("blocks", ["stored", "fixed", "dynamic", "fast"])
def test_inflate_matches_zlib(tmp_path, blocks):
    """Streams of each block type (``zlib.compressobj`` at level 0, with
    Z_FIXED, at level 9, at level 1), over data with long runs, repeats far
    back in the window and noise: the decoded rows equal Python's zlib's
    decompression of the same stream, and Pillow's decode."""
    rng = np.random.RandomState(7)
    h, w = 300, 301  # 90k bytes: several stored blocks and long distances
    img = rng.randint(0, 256, (h, w))
    img[50:120] = 9  # long runs
    img[200:260] = img[10:70]  # repeats 57k bytes back, past the 32k window in part
    img[:, ::7] = np.arange(h)[:, None] % 256
    level, strategy = {"stored": (0, zlib.Z_DEFAULT_STRATEGY), "fixed": (6, zlib.Z_FIXED),
                       "dynamic": (9, zlib.Z_DEFAULT_STRATEGY),
                       "fast": (1, zlib.Z_DEFAULT_STRATEGY)}[blocks]
    data = png.encode_png(img, 0, 8, filters=(0,), level=level, strategy=strategy)
    idat = data[data.index(b"IDAT") + 4:data.rindex(b"IEND") - 8]
    btype = (idat[2] >> 1) & 3  # the first block's BTYPE
    assert btype == {"stored": 0, "fixed": 1, "dynamic": 2, "fast": btype}[blocks]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()
    path = tmp_path / "z.png"
    path.write_bytes(data)
    got = read_image(str(path))
    np.testing.assert_array_equal(got[..., 0], rows[:, 1:])
    np.testing.assert_array_equal(got, _pillow(path))


def _rgb_png(**kw):
    return png.encode_png(np.random.RandomState(3).randint(0, 256, (20, 30, 3)), 2, 8, **kw)


def _corrupt(kind):
    data = bytearray(_rgb_png())
    if kind == "truncated":
        return bytes(data[:len(data) // 2])
    if kind == "ihdr_crc":
        data[8 + 8 + 13] ^= 1
        return bytes(data)
    if kind == "zlib_data":
        i = data.index(b"IDAT") + 4
        body = bytearray(data[i:data.index(b"IEND") - 8])
        body[len(body) // 2] ^= 0x55
        return bytes(data[:i - 8]) + png._chunk(b"IDAT", bytes(body)) + png._chunk(b"IEND", b"")
    if kind == "adler":
        i = data.index(b"IDAT") + 4
        body = bytearray(data[i:data.index(b"IEND") - 8])
        body[-1] ^= 1
        return bytes(data[:i - 8]) + png._chunk(b"IDAT", bytes(body)) + png._chunk(b"IEND", b"")
    if kind == "filter_type":
        i = data.index(b"IDAT") + 4
        raw = bytearray(zlib.decompress(bytes(data[i:data.index(b"IEND") - 8])))
        raw[0] = 5
        return (bytes(data[:i - 8]) + png._chunk(b"IDAT", zlib.compress(bytes(raw)))
                + png._chunk(b"IEND", b""))
    if kind == "bit_depth":  # 3-bit gray: not a depth of the specification
        return _with_ihdr(png.encode_png(np.zeros((2, 2), int), 0, 8), depth=3)
    raise ValueError(kind)


def _with_ihdr(data, **fields):
    """``data`` with IHDR's fields replaced (its CRC recomputed)."""
    w, h, depth, color, comp, filt, ilace = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(w=w, h=h, depth=depth, color=color, comp=comp, filt=filt, ilace=ilace)
    vals.update(fields)
    body = b"IHDR" + struct.pack(">IIBBBBB", *vals.values())
    return data[:12] + body + struct.pack(">I", zlib.crc32(body) & 0xffffffff) + data[33:]


@pytest.mark.parametrize("kind", ["truncated", "ihdr_crc", "zlib_data", "adler", "filter_type",
                                  "bit_depth"])
def test_corrupt_pngs_raise(tmp_path, kind):
    path = tmp_path / "bad.png"
    path.write_bytes(_corrupt(kind))
    if kind in ("truncated", "ihdr_crc", "zlib_data"):  # Pillow refuses these too
        with pytest.raises((OSError, SyntaxError, ValueError)):
            _pillow(path)
    with pytest.raises(ValueError, match="corrupt or truncated PNG data"):
        read_image(str(path))


@pytest.mark.parametrize("method", [(0, 0, 2), (0, 1, 0), (1, 0, 0)],
                         ids=["interlace2", "filter1", "compression1"])
def test_undefined_methods_raise_naming_a16(tmp_path, method):
    path = tmp_path / "m.png"
    path.write_bytes(_rgb_png(method=method))
    with pytest.raises(NotImplementedError, match="PNG specification does not define.*A16"):
        read_image(str(path))


@pytest.mark.parametrize("kind", ["idat_crc", "compression1"])
def test_stricter_than_pillow_where_documented(tmp_path, kind):
    """ROADMAP C.2: Pillow reads a PNG whose IDAT CRC is wrong and one whose
    IHDR names compression method 1 (it inflates whatever the byte says);
    the port refuses both.  No encoder writes either."""
    if kind == "idat_crc":
        data = bytearray(_rgb_png())
        i = data.index(b"IDAT")
        data[i + 4 + struct.unpack(">I", data[i - 4:i])[0]] ^= 1
        data, error, match = bytes(data), ValueError, "corrupt or truncated PNG data"
    else:
        data, error, match = _rgb_png(method=(1, 0, None)), NotImplementedError, "A16"
    path = tmp_path / "strict.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(_pillow(path), _pillow_of(_rgb_png()))
    with pytest.raises(error, match=match):
        read_image(str(path))


@pytest.mark.parametrize("fmt", ["GIF", "BMP", "TIFF", "WEBP"])
def test_other_formats_go_by_their_magic_bytes(tmp_path, fmt):
    """GIF, BMP, TIFF and WebP under a PNG name are read by their own
    decoders (Pillow's pixels, no decode_file view)."""
    path = tmp_path / "x.png"  # the extension does not matter: the magic bytes do
    Image.fromarray(np.random.RandomState(4).randint(0, 256, (4, 4, 3)).astype(np.uint8)).save(
        path, format=fmt)
    np.testing.assert_array_equal(read_image(str(path)), _pillow(path))
    assert native.decode_file(str(path), 64) is None


def test_a_frame_past_pillows_bomb_limit_raises(tmp_path):
    path = tmp_path / "bomb.png"
    path.write_bytes(_with_ihdr(_rgb_png(), w=20000, h=20000))
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path)
    with pytest.raises(ValueError, match="decompression bomb"):
        read_image(str(path))


@pytest.mark.parametrize("pre_size", [64, 256])
def test_a_png_named_jpg_takes_the_full_decode_in_both_packages(tmp_path, pre_size):
    """The JAX native decoder reads no PNG, so its RawDatasetWrapper resizes
    Pillow's decode (bilinear, shorter edge, centre crop); the port's
    decode_file returns None and its wrapper does the same."""
    path = str(tmp_path / "n01440764_1234.JPEG")
    with open(path, "wb") as f:
        f.write(png.encode_png(np.random.RandomState(5).randint(0, 256, (90, 140, 3)), 2, 8))
    assert native.decode_file(path, pre_size) is None
    got = loader.RawDatasetWrapper([Datum(impath=path)], pre_size=pre_size)[0]["img"]
    ref = JaxRaw([JaxDatum(impath=path)], pre_size=pre_size)[0]["img"]
    assert got.shape == (pre_size, pre_size, 3)
    np.testing.assert_array_equal(got, ref)


def test_eight_threads_decode_the_same_bytes():
    paths = sorted(os.path.join(FIXTURES, n) for n in EXPECTED["digests"])
    serial = [read_image(p) for p in paths]
    with ThreadPoolExecutor(max_workers=8) as pool:
        for _ in range(2):
            for i, img in enumerate(pool.map(read_image, paths * 4)):
                np.testing.assert_array_equal(img, serial[i % len(paths)])


def _digest(a):
    a = np.ascontiguousarray(a, np.uint8)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sum": int(a.sum(dtype=np.int64))}


with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)


@pytest.mark.parametrize("name", sorted(EXPECTED["digests"]))
def test_committed_fixtures_match_their_expected_digests(name):
    path = os.path.join(FIXTURES, name)
    want = EXPECTED["digests"][name]
    full = read_image(path)
    assert _digest(full) == want["full"]
    cache = loader.RawDatasetWrapper([Datum(impath=path)], pre_size=256)[0]["img"]
    assert _digest(cache) == want["cache256"]
    assert _digest(imageops.resize_center_crop(full, (224, 224), "bicubic")) == want["eval224"]


def test_the_truncated_fixture_raises():
    assert EXPECTED["truncated"] == ["truncated_n02103406_4068-1.png"]
    with pytest.raises(ValueError, match="corrupt or truncated PNG data"):
        read_image(os.path.join(FIXTURES, EXPECTED["truncated"][0]))
