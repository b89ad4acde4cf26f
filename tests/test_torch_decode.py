"""The port's JPEG decoder (fsvlm_tpu_torch.native) against its references,
on the CPU: the decoder is host C++ built with g++ at first use, so unlike
the CUDA kernels it runs on the CPU too.  Every comparison is exact (byte
equality).

- ``read_image`` against Pillow's ``Image.open(path).convert("RGB")`` on
  JPEGs Pillow writes at run time: 4:4:4, 4:2:2, 4:2:0, grayscale,
  progressive, restart intervals, sizes off the MCU grid, CMYK;
- ``decode_file(path, P)`` for P in 64, 224 and 256 against
  ``fsvlm_tpu.native.decode_file`` (libjpeg's DCT-scaled decode and the
  float bilinear resize), DCT scaling at 1/2, 1/4 and 1/8 included;
- eight threads decoding at once give the same bytes;
- a missing file, junk bytes, a PNG, a truncated JPEG;
- the committed fixtures under tests/torch_fixtures/jpeg against their
  committed digests, the check ``chip_smoke.py`` phase 12 makes on the card.
"""

import hashlib
import io
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from fsvlm_tpu import native as jax_native
from fsvlm_tpu_torch import native
from fsvlm_tpu_torch.data import imageops, loader
from fsvlm_tpu_torch.data.base_dataset import Datum
from fsvlm_tpu_torch.utils import read_image

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "jpeg")

# name: (width, height, Pillow mode, save options)
CASES = {
    "420": (96, 64, "RGB", dict(quality=90, subsampling=2)),
    "422": (96, 64, "RGB", dict(quality=90, subsampling=1)),
    "444": (96, 64, "RGB", dict(quality=90, subsampling=0)),
    "gray": (70, 50, "L", dict(quality=85)),
    "progressive_420": (120, 90, "RGB", dict(quality=85, subsampling=2, progressive=True)),
    "progressive_444": (77, 51, "RGB", dict(quality=95, subsampling=0, progressive=True)),
    "progressive_gray": (65, 47, "L", dict(quality=80, progressive=True)),
    "restart_blocks": (100, 75, "RGB", dict(quality=85, subsampling=2, restart_marker_blocks=2)),
    "restart_rows_422": (100, 75, "RGB", dict(quality=85, subsampling=1, restart_marker_rows=1)),
    "odd_333x257": (333, 257, "RGB", dict(quality=85, subsampling=2)),
    "odd_17x9": (17, 9, "RGB", dict(quality=85, subsampling=2)),
    "one_pixel": (1, 1, "RGB", dict(quality=85, subsampling=2)),
    "quality_100": (64, 48, "RGB", dict(quality=100, subsampling=2)),
    "quality_10": (64, 48, "RGB", dict(quality=10, subsampling=2)),
    "cmyk": (60, 45, "CMYK", dict(quality=85)),
    "cmyk_progressive": (60, 45, "CMYK", dict(quality=85, progressive=True)),
}


def _content(seed, h, w, channels, noise=6.0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = [127 + 100 * np.sin(rng.uniform(0.02, 0.2) * xx + rng.uniform(0.02, 0.2) * yy + k)
              for k in range(channels)]
    img = np.stack(planes, -1) + rng.normal(0, noise, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


def _write(path, w, h, mode, opts, seed=0):
    arr = _content(seed, h, w, {"L": 1, "RGB": 3, "CMYK": 4}[mode])
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path, "JPEG", **opts)
    return str(path)


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpeg")
    for i, (name, (w, h, mode, opts)) in enumerate(CASES.items()):
        _write(d / f"{name}.jpg", w, h, mode, opts, seed=i)
    # shorter edges 300 and 1100: P 64 takes 1/4 and 1/8, P 256 takes 1/4
    _write(d / "big_400x300.jpg", 400, 300, "RGB", dict(quality=80, subsampling=2), seed=90)
    _write(d / "big_1100x1300_444.jpg", 1100, 1300, "RGB", dict(quality=70, subsampling=0),
           seed=91)
    _write(d / "big_560x600_422.jpg", 560, 600, "RGB", dict(quality=70, subsampling=1), seed=92)
    return d


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_image_matches_pillow(jpeg_dir, name):
    path = str(jpeg_dir / f"{name}.jpg")
    ref = np.asarray(Image.open(path).convert("RGB"))
    got = read_image(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


DECODE_FILE_CASES = sorted([n for n in CASES if not n.startswith("cmyk")] +
                           ["big_400x300", "big_1100x1300_444", "big_560x600_422"])


@pytest.mark.parametrize("pre_size", [64, 224, 256])
@pytest.mark.parametrize("name", DECODE_FILE_CASES)
def test_decode_file_matches_native(jpeg_dir, name, pre_size):
    if not jax_native.native_available():
        pytest.skip("native library not built (run make -C native)")
    path = str(jpeg_dir / f"{name}.jpg")
    ref = jax_native.decode_file(path, pre_size)
    got = native.decode_file(path, pre_size)
    assert ref is not None and got.shape == (pre_size, pre_size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_dct_scaling_cases_take_each_scale(jpeg_dir):
    """The cases above reach the reduced IDCTs: the largest 1/2^k keeping
    the shorter edge >= P (native/decoder.cpp:113-119)."""
    def denom(shorter, p):
        d = 1
        while d < 8 and shorter // (d * 2) >= p:
            d *= 2
        return d

    got = {denom(min(Image.open(jpeg_dir / f"{n}.jpg").size), p)
           for n in DECODE_FILE_CASES for p in (64, 224, 256)}
    assert got == {1, 2, 4, 8}


def test_cmyk_has_no_cache_view_and_the_loader_takes_the_full_decode(jpeg_dir):
    """libjpeg gives no RGB output for CMYK, so the native decode returns
    None in both packages, and the loaders both resize the full decode."""
    from fsvlm_tpu.data.base_dataset import Datum as JaxDatum
    from fsvlm_tpu.data.loader import RawDatasetWrapper as JaxRaw

    path = str(jpeg_dir / "cmyk.jpg")
    assert native.decode_file(path, 32) is None
    if jax_native.native_available():
        assert jax_native.decode_file(path, 32) is None
    got = loader.RawDatasetWrapper([Datum(impath=path)], pre_size=32)[0]["img"]
    ref = JaxRaw([JaxDatum(impath=path)], pre_size=32)[0]["img"]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, imageops.resize_shorter_center_crop(read_image(path), 32))


def test_eight_threads_decode_the_same_bytes(jpeg_dir):
    paths = sorted(str(p) for p in jpeg_dir.iterdir())
    serial_full = [read_image(p) for p in paths]
    serial_raw = [native.decode_file(p, 64) for p in paths]
    with ThreadPoolExecutor(max_workers=8) as pool:
        for _ in range(2):
            full = list(pool.map(read_image, paths * 3))
            raw = list(pool.map(lambda p: native.decode_file(p, 64), paths * 3))
            for i, p in enumerate(paths * 3):
                np.testing.assert_array_equal(full[i], serial_full[i % len(paths)])
                if serial_raw[i % len(paths)] is None:
                    assert raw[i] is None
                else:
                    np.testing.assert_array_equal(raw[i], serial_raw[i % len(paths)])


def test_a_missing_file_raises(tmp_path):
    for fn in (read_image, lambda p: native.decode_file(p, 64)):
        with pytest.raises(IOError, match="No file exists"):
            fn(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("kind", ["junk", "png", "gif", "webp", "empty"])
def test_a_file_that_is_not_a_jpeg_raises_naming_a16(tmp_path, kind):
    """A file in no format the port reads raises naming A16 on both views.
    A PNG, a GIF or a WebP under a JPEG name is read by its own decoder
    (Pillow's pixels), and has no ``decode_file`` view, as in the JAX
    package's libjpeg build."""
    path = tmp_path / "x.jpg"
    if kind == "junk":
        path.write_bytes(b"definitely not a jpeg")
    elif kind == "empty":
        path.write_bytes(b"")
    else:
        Image.fromarray(_content(4, 4, 4, 3)).save(path, format=kind.upper())
    if kind in ("png", "gif", "webp"):
        np.testing.assert_array_equal(read_image(str(path)),
                                      np.asarray(Image.open(path).convert("RGB")))
        assert native.decode_file(str(path), 64) is None
        return
    for fn in (read_image, lambda p: native.decode_file(p, 64)):
        with pytest.raises(NotImplementedError, match="ROADMAP A16"):
            fn(str(path))


def test_corrupt_and_truncated_jpegs_raise(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(_content(5, 64, 64, 3)).save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    for i, bad in enumerate((data[:len(data) // 2], data[:200])):
        path = tmp_path / f"bad{i}.jpg"
        path.write_bytes(bad)
        for fn in (read_image, lambda p: native.decode_file(p, 32)):
            with pytest.raises(ValueError, match="corrupt or truncated"):
                fn(str(path))


def test_a_frame_past_pillows_bomb_limit_raises(tmp_path):
    """A header claiming 20000 x 20000 pixels: Pillow refuses it as a
    decompression bomb, and so does the port, before sizing any buffer."""
    buf = io.BytesIO()
    Image.fromarray(_content(6, 16, 16, 3)).save(buf, "JPEG", quality=90)
    data = bytearray(buf.getvalue())
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = (20000).to_bytes(2, "big") * 2
    path = tmp_path / "bomb.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path)
    for fn in (read_image, lambda p: native.decode_file(p, 64)):
        with pytest.raises(ValueError, match="decompression bomb"):
            fn(str(path))


def test_the_build_is_named_by_its_source_and_flags():
    info = native.build_info()
    assert info["route"] == "B" and info["source"] == "csrc/jpeg_decoder.cpp"
    assert os.path.basename(info["path"]).startswith("libfsvlm_host-")
    assert info["path"] == native.library_path() and os.path.isfile(info["path"])


def _digest(a):
    a = np.ascontiguousarray(a, np.uint8)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sum": int(a.sum(dtype=np.int64))}


with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_committed_fixtures_match_their_expected_digests(name):
    path = os.path.join(FIXTURES, name)
    want = EXPECTED[name]
    full = read_image(path)
    assert _digest(full) == want["full"]
    raw = native.decode_file(path, 256)
    assert (None if raw is None else _digest(raw)) == want["raw256"]
    cache = loader.RawDatasetWrapper([Datum(impath=path)], pre_size=256)[0]["img"]
    assert _digest(cache) == want["cache256"]
    assert _digest(imageops.resize_center_crop(full, (224, 224), "bicubic")) == want["eval224"]
