"""The port's WebP decoder (fsvlm_tpu_torch/csrc/webp_decoder.cpp over
vp8l_decoder.cpp and vp8_decoder.cpp, through fsvlm_tpu_torch.native)
against Pillow 12.1 with its libwebp 1.6.0, on the CPU: the decoder is host
C++ built with g++ at first use, so it runs on the CPU too.  Every
comparison is exact.  The files are written at run time by Pillow's WebP
encoder from seeded numpy images (the layouts its options do not reach are
committed fixtures, tests/test_torch_formats.py's digest cases):

- ``read_image`` against ``Image.open(path).convert("RGB")``: lossy at
  qualities 0-100 and methods 0, 4 and 6, at sizes that hit the fancy
  upsampler's edges and partial macroblocks; lossless at methods 0 and 6 on
  photo-like images and on 2, 4, 16 and 256 colours (every pixel packing of
  the colour-indexing transform); RGBA, lossy at alpha qualities 100, 50
  and 0 and lossless with ``exact`` off and on, where the whole RGBA canvas
  is also held against Pillow's RGBA; the first frame of 3-frame
  animations, lossy, lossless and with alpha;
- the magic bytes decide, not the extension, and ``decode_file`` has no view
  (None), as the JAX package's libjpeg build;
- eight threads give the same bytes; a canvas past Pillow's bomb limit;
- truncation at the RIFF header, inside VP8X, inside ALPH and inside the
  bitstream, seeded byte and chunk corruptions, container layouts no
  encoder writes, and the corrupt streams where libwebp's own behaviour
  shows (its SSE2 inverse DCT, a skipped 4x4 macroblock's Y2 context, the
  ALPH byte path's last symbol): where Pillow refuses, the port raises
  ``ValueError``, and where Pillow still decodes, the bytes are equal;
- the loader's cache view (256) and eval view (224) against the JAX
  package's ``RawDatasetWrapper`` and ``DatasetWrapper``.
"""

import ctypes
import io
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.data import transforms as jax_transforms
from fsvlm_tpu.data.base_dataset import Datum as JaxDatum
from fsvlm_tpu.data.loader import DatasetWrapper as JaxWrapper
from fsvlm_tpu.data.loader import RawDatasetWrapper as JaxRaw
from fsvlm_tpu_torch import native
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.data import loader, transforms
from fsvlm_tpu_torch.data.base_dataset import Datum
from fsvlm_tpu_torch.utils import read_image

SIZES = [(1, 1), (2, 3), (15, 17), (16, 16), (17, 33), (97, 61)]


def _image(h, w, c=3, seed=0):
    """A photo-like image: gradients, edges and grain."""
    rng = np.random.default_rng(seed + 1000 * h + w)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 90 + 60 * np.sin(x[..., None] / 5.0 + rng.uniform(0, 6, c)) * np.cos(y / 7.0)[..., None]
    img = img + 40 * ((x // 6 + y // 5) % 2)[..., None] + rng.normal(0, 12, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def _with_alpha(img, seed=0):
    h, w, _ = img.shape
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w)).astype(np.uint8)
    a[rng.random((h, w)) < 0.3] = 0  # transparent pixels keep their RGB
    a[:, : w // 3] = 255
    return np.concatenate([img, a[..., None]], -1)


def _encode(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _animation(frames, **kw):
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, format="WEBP", save_all=True, append_images=ims[1:], duration=40, **kw)
    return buf.getvalue()


def _pillow(data, mode="RGB"):
    """Pillow's decode of the bytes, or the exception it raises."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert(mode))
    except Exception as e:  # noqa: BLE001 - Pillow's refusal is the reference
        return e


def _same_as_pillow(tmp_path, data, name="x.webp"):
    """The port's read_image of the bytes equals Pillow's, or both refuse
    (the port with ValueError)."""
    path = tmp_path / name
    path.write_bytes(data)
    ref = _pillow(data)
    if isinstance(ref, Exception):
        with pytest.raises(ValueError, match="corrupt or truncated WebP|decompression bomb"):
            read_image(str(path))
        return None
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def _rgba(data):
    """The port's RGBA canvas (fsvlm_webp_decode_rgba): the bytes of
    Pillow's RGBA mode, alpha included."""
    lib = native.load()
    fn = lib.fsvlm_webp_decode_rgba
    fn.argtypes, fn.restype = lib.fsvlm_webp_decode_full.argtypes, ctypes.c_int
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    assert lib.fsvlm_webp_size(buf.ctypes.data_as(native._U8P), len(data), ctypes.byref(w),
                               ctypes.byref(h)) == 0
    out = np.empty((h.value, w.value, 4), np.uint8)
    assert fn(buf.ctypes.data_as(native._U8P), len(data), w.value, h.value,
              out.ctypes.data_as(native._U8P)) == 0
    return out


# ------------------------------------------------------------------ lossy and lossless
@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [0, 10, 50, 75, 100])
@pytest.mark.parametrize("h,w", SIZES)
def test_lossy_matches_pillow(tmp_path, h, w, quality, method):
    _same_as_pillow(tmp_path, _encode(_image(h, w), quality=quality, method=method))


def _colours(h, w, n, seed):
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (n, 3))
    idx = rng.integers(0, n, (h, w))
    idx[: h // 2] = (np.arange(w) * n // max(w, 1))[None] % n  # runs for LZ77
    return palette[idx].astype(np.uint8)


@pytest.mark.parametrize("method", [0, 6])
@pytest.mark.parametrize("colours", [None, 2, 4, 16, 256])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (15, 17), (97, 61)])
def test_lossless_matches_pillow(tmp_path, h, w, colours, method):
    img = _image(h, w) if colours is None else _colours(h, w, colours, h * w + colours)
    _same_as_pillow(tmp_path, _encode(img, lossless=True, method=method))


@pytest.mark.parametrize("options", [dict(quality=70, alpha_quality=100),
                                     dict(quality=70, alpha_quality=50, method=6),
                                     dict(quality=30, alpha_quality=0),
                                     dict(lossless=True, exact=False),
                                     dict(lossless=True, exact=True, method=6)],
                         ids=["aq100", "aq50", "aq0", "lossless", "lossless_exact"])
@pytest.mark.parametrize("h,w", [(2, 3), (17, 33), (97, 61)])
def test_rgba_matches_pillow_in_rgb_and_rgba(tmp_path, h, w, options):
    data = _encode(_with_alpha(_image(h, w), h + w), **options)
    _same_as_pillow(tmp_path, data)
    np.testing.assert_array_equal(_rgba(data), _pillow(data, "RGBA"))


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
@pytest.mark.parametrize("h,w", [(17, 33), (97, 61)])
def test_the_first_frame_of_an_animation_matches_pillow(tmp_path, h, w, kind):
    frames = [_image(h, w, seed=s) for s in range(3)]
    if kind == "alpha":
        frames = [_with_alpha(f, s) for s, f in enumerate(frames)]
    data = _animation(frames, lossless=kind == "lossless", quality=60)
    assert Image.open(io.BytesIO(data)).n_frames == 3
    _same_as_pillow(tmp_path, data)
    np.testing.assert_array_equal(_rgba(data), _pillow(data, "RGBA"))


# ------------------------------------------------------------------ magic, threads, bomb
@pytest.mark.parametrize("name", ["x.png", "x.jpg", "x.gif", "x"])
def test_the_magic_bytes_decide_not_the_extension(tmp_path, name):
    data = _encode(_image(17, 33), quality=80)
    _same_as_pillow(tmp_path, data, name)
    assert native.decode_file(str(tmp_path / name), 64) is None


def test_eight_threads_decode_the_same_bytes(tmp_path):
    paths = []
    for i, (h, w) in enumerate(SIZES):
        img = _image(h, w, seed=i)
        for j, data in enumerate((_encode(img, quality=60), _encode(img, lossless=True),
                                  _encode(_with_alpha(img, i), quality=60))):
            path = tmp_path / f"t{i}_{j}.webp"
            path.write_bytes(data)
            paths.append(str(path))
    serial = [read_image(p) for p in paths]
    with ThreadPoolExecutor(max_workers=8) as pool:
        for i, img in enumerate(pool.map(read_image, paths * 3)):
            np.testing.assert_array_equal(img, serial[i % len(paths)])


def test_a_canvas_past_pillows_bomb_limit_raises(tmp_path):
    """An animation of one small frame on a 20000 x 20000 canvas: Pillow
    refuses it as a decompression bomb, and so does the port, before it
    sizes any buffer."""
    data = bytearray(_animation([_image(8, 8, seed=s) for s in range(2)]))
    i = data.index(b"VP8X") + 12
    data[i:i + 6] = struct.pack("<I", 20000 - 1)[:3] + struct.pack("<I", 20000 - 1)[:3]
    path = tmp_path / "bomb.webp"
    path.write_bytes(bytes(data))
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path)
    with pytest.raises(ValueError, match="decompression bomb"):
        read_image(str(path))


# ------------------------------------------------------------------ truncation and corruption
def _resized(data):
    """The bytes with the RIFF size and the last chunk's size set to what is
    there, so that the container holds and only the payload is short."""
    data = bytearray(data)
    pos, last = 12, 12
    while pos + 8 <= len(data):
        last = pos
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if pos + 8 + n + (n & 1) >= len(data):
            break
        pos += 8 + n + (n & 1)
    n = len(data) - last - 8
    data[last + 4:last + 8] = struct.pack("<I", n)
    if n & 1:
        data += b"\0"
    data[4:8] = struct.pack("<I", len(data) - 8)
    return bytes(data)


def _sources():
    img = _image(37, 45, seed=9)
    return {"lossy": _encode(img, quality=60),
            "lossless": _encode(img, lossless=True),
            "alpha": _encode(_with_alpha(img, 9), quality=60),
            "alpha_lossless": _encode(_with_alpha(img, 9), lossless=True),
            "animation": _animation([img, _image(37, 45, seed=10)], quality=60)}


@pytest.mark.parametrize("where", ["riff_header", "vp8x", "alph", "vp8", "vp8l", "anmf"])
def test_truncations_raise_valueerror(tmp_path, where):
    src = _sources()
    data = {"riff_header": src["lossy"], "vp8x": src["alpha"], "alph": src["alpha"],
            "vp8": src["lossy"], "vp8l": src["lossless"], "anmf": src["animation"]}[where]
    tag, offsets = {"riff_header": (b"RIFF", (12, 16, 19)), "vp8x": (b"VP8X", (6, 12, 17)),
                    "alph": (b"ALPH", (4, 9, 30)), "vp8": (b"VP8 ", (12, 40, len(data) // 2)),
                    "vp8l": (b"VP8L", (10, 40, len(data) // 2)),
                    "anmf": (b"ANMF", (10, 30, 200))}[where]
    cuts = [data.index(tag) + k for k in offsets]
    for cut in cuts:
        for short in (data[:cut], _resized(data[:cut]) if cut > 20 else data[:cut]):
            assert isinstance(_pillow(short), Exception)
            _same_as_pillow(tmp_path, short)


@pytest.mark.parametrize("source", ["lossy", "lossless", "alpha", "alpha_lossless", "animation"])
def test_corrupted_bytes_fail_or_decode_as_pillow(tmp_path, source):
    """Seeded byte changes past the RIFF header: both decoders refuse the
    file, or both read it to the same bytes."""
    data = _sources()[source]
    rng = np.random.default_rng(sum(map(ord, source)))
    for _ in range(40):
        bad = bytearray(data)
        for _ in range(rng.integers(1, 4)):
            bad[rng.integers(12, len(bad))] = rng.integers(0, 256)
        _same_as_pillow(tmp_path, bytes(bad))
        _same_as_pillow(tmp_path, _resized(bytes(bad[:rng.integers(21, len(bad))])))


def test_a_flipped_bit_past_the_int16_coefficient_range_decodes_as_libwebp(tmp_path):
    """One bit flipped in a token partition leaves a stream both decoders
    read, with dequantized coefficients a real encoder never writes: libwebp
    then runs its SSE2 inverse DCT, whose 16-bit lanes wrap where plain C
    int arithmetic does not (found by a seeded fuzz of this file's kind)."""
    rng = np.random.default_rng(0)
    img = np.clip(rng.normal(128, 50, (37, 45, 4)), 0, 255).astype(np.uint8)
    data = bytearray(_encode(img[..., :3], quality=60))
    data[386] ^= 0x20
    assert _same_as_pillow(tmp_path, bytes(data)) is not None


def test_a_skipped_4x4_macroblock_keeps_its_y2_context(tmp_path):
    """One bit flipped in partition 0 marks a 4x4 macroblock skipped beside a
    nonzero Y2 context: libwebp leaves that context as it was (a skipped
    16x16 macroblock clears it), and the tokens after it depend on it (found
    by a seeded fuzz of this file's kind)."""
    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:64, 0:96]
    img = 100 + 60 * np.sin(x / 2) * ((y // 16 + x // 16) % 2) + rng.normal(0, 2, (64, 96))
    img = np.clip(img[..., None] * np.ones(3), 0, 255).astype(np.uint8)
    data = bytearray(_encode(img, quality=int(rng.integers(5, 60))))
    data[53] ^= 1
    assert _same_as_pillow(tmp_path, bytes(data)) is not None


def test_a_shortened_alph_stream_fails_or_decodes_as_libwebp(tmp_path):
    """ALPH chunks cut short by 1-5 bytes inside a sound container: a
    colour-indexed alpha stream with single-symbol red, blue and alpha codes
    takes libwebp's byte path, which accepts a last symbol read past the
    end; every other stream fails there."""
    rng = np.random.default_rng(3)
    for k in range(12):
        h, w = int(rng.integers(5, 40)), int(rng.integers(5, 40))
        img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        img[..., 3] = rng.integers(0, int(rng.integers(2, 6)), (h, w)) * 60
        src = _encode(img, quality=50, alpha_quality=int(rng.choice([20, 50, 100])))
        i = src.index(b"ALPH")
        n = struct.unpack("<I", src[i + 4:i + 8])[0]
        for cut in range(1, min(6, n - 2)):
            chunks = [[t, p[:n - cut] if t == b"ALPH" else p] for t, p in _chunks(src)]
            _same_as_pillow(tmp_path, _riff(chunks))


def _chunks(data):
    """The top-level chunks after "WEBP" as [tag, payload] pairs."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append([data[pos:pos + 4], data[pos + 8:pos + 8 + n]])
        pos += 8 + n + (n & 1)
    return out


def _riff(chunks, pad=True, riff_delta=0):
    body = b"".join(tag + struct.pack("<I", len(p)) + p + (b"\0" if len(p) & 1 and pad else b"")
                    for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body) + 4 + riff_delta) + b"WEBP" + body


def _layout(case):
    """A WebP rebuilt chunk by chunk into a layout an encoder does not write."""
    img = _image(23, 29, seed=5)
    still = _chunks(_encode(_with_alpha(img, 5), quality=60))  # VP8X, ALPH, VP8
    simple = _chunks(_encode(img, quality=60))  # VP8
    lossless = _chunks(_encode(img, lossless=True))  # VP8L
    anim = _chunks(_animation([img, _image(23, 29, seed=6)], quality=60))  # VP8X, ANIM, ANMF x 2
    vp8x = lambda c, flags: [[b"VP8X", bytes([flags]) + c[0][1][1:]]] + c[1:]  # noqa: E731
    extra = [b"ABCD", b"odd"]
    return {
        "vp8x_of_11_bytes": lambda: _riff([[b"VP8X", still[0][1] + b"\0"]] + still[1:]),
        "vp8x_of_12_bytes": lambda: _riff([[b"VP8X", still[0][1] + b"\0\0"]] + still[1:]),
        "unknown_chunk_after_vp8x": lambda: _riff(still[:1] + [extra] + still[1:]),
        "unknown_chunk_at_the_end": lambda: _riff(still + [extra]),
        "unknown_chunk_after_a_simple_image": lambda: _riff(simple + [extra]),
        "iccp_exif_xmp_flagged": lambda: _riff(vp8x(still, 0x10 | 0x20 | 0x08 | 0x04)[:1]
                                               + [[b"ICCP", b"\0" * 9]] + still[1:]
                                               + [[b"EXIF", b"Exif"], [b"XMP ", b"<x/>"]]),
        "exif_not_flagged": lambda: _riff(still + [[b"EXIF", b"Exif\0"]]),
        "reserved_flag_bit": lambda: _riff(vp8x(still, 0x10 | 0x01)),
        "alpha_flag_off": lambda: _riff(vp8x(still, 0x00)),
        "animation_flag_on_a_still": lambda: _riff(vp8x(still, 0x12)),
        "two_images": lambda: _riff(still + still[2:]),
        "alph_before_vp8l": lambda: _riff([still[0], still[1]] + lossless),
        "anim_without_frames": lambda: _riff(anim[:2]),
        "frames_without_anim": lambda: _riff(anim[:1] + anim[2:]),
        "one_frame": lambda: _riff(anim[:3]),
        "frame_past_the_canvas": lambda: _riff(
            anim[:2] + [[b"ANMF", b"\x02\x00\x00" + anim[2][1][3:]]] + anim[3:]),
        "no_pad_byte": lambda: _riff(simple + [[b"ABCD", b"odd"]], pad=False),
        "riff_size_short": lambda: _riff(simple, riff_delta=-2),
        "riff_size_long": lambda: _riff(simple, riff_delta=2),
        "bytes_past_the_riff": lambda: _riff(simple) + b"trailing bytes",
    }[case]()


@pytest.mark.parametrize("case", [
    "vp8x_of_11_bytes", "vp8x_of_12_bytes", "unknown_chunk_after_vp8x", "unknown_chunk_at_the_end",
    "unknown_chunk_after_a_simple_image", "iccp_exif_xmp_flagged", "exif_not_flagged",
    "reserved_flag_bit", "alpha_flag_off", "animation_flag_on_a_still", "two_images",
    "alph_before_vp8l", "anim_without_frames", "frames_without_anim", "one_frame",
    "frame_past_the_canvas", "no_pad_byte", "riff_size_short", "riff_size_long",
    "bytes_past_the_riff"])
def test_container_layouts_fail_or_decode_as_pillow(tmp_path, case):
    """Layouts libwebp's demuxer, or the WebPGetFeatures check that
    WebPAnimDecoderNew makes first, accepts or refuses: the port with it."""
    _same_as_pillow(tmp_path, _layout(case))


@pytest.mark.parametrize("source", ["still_alpha", "animation"])
def test_seeded_chunk_mutations_fail_or_decode_as_pillow(tmp_path, source):
    """Chunks inserted, dropped, duplicated and swapped, VP8X flags flipped,
    sizes and padding changed, seeded: both refuse or both read the same."""
    img = _image(23, 29, seed=7)
    data = (_encode(_with_alpha(img, 7), quality=60) if source == "still_alpha"
            else _animation([img, _image(23, 29, seed=8)], quality=60))
    rng = np.random.default_rng(sum(map(ord, source)))
    tags = [b"ALPH", b"VP8 ", b"VP8L", b"VP8X", b"ANIM", b"ANMF", b"ICCP", b"EXIF", b"ABCD"]
    for _ in range(60):
        chunks, pad, delta = [list(c) for c in _chunks(data)], True, 0
        op, i = rng.integers(0, 6), int(rng.integers(0, len(chunks)))
        if op == 0:
            chunks.insert(i, [tags[rng.integers(len(tags))],
                              rng.integers(0, 256, rng.integers(0, 12)).astype(np.uint8).tobytes()])
        elif op == 1:
            del chunks[i]
        elif op == 2:
            chunks.insert(i, list(chunks[i]))
        elif op == 3 and i + 1 < len(chunks):
            chunks[i], chunks[i + 1] = chunks[i + 1], chunks[i]
        elif op == 4:
            chunks[0][1] = bytes([chunks[0][1][0] ^ (1 << rng.integers(0, 8))]) + chunks[0][1][1:]
        else:
            pad, delta = bool(rng.integers(0, 2)), int(rng.choice([-1, 0, 1, 8]))
            chunks[i][1] = chunks[i][1] + b"\0"
        _same_as_pillow(tmp_path, _riff(chunks, pad, delta))


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


@pytest.mark.parametrize("kind", ["lossy", "lossless", "animation"])
def test_cache_and_eval_views_match_the_jax_wrappers(tmp_path, kind):
    img = _image(150, 201, seed=3)
    data = {"lossy": lambda: _encode(img, quality=85),
            "lossless": lambda: _encode(img, lossless=True),
            "animation": lambda: _animation([img, img[::-1]], quality=85)}[kind]()
    path = str(tmp_path / f"{kind}.webp")
    with open(path, "wb") as f:
        f.write(data)
    assert native.decode_file(path, 256) is None
    got = loader.RawDatasetWrapper([Datum(impath=path)], pre_size=256)[0]["img"]
    np.testing.assert_array_equal(got, JaxRaw([JaxDatum(impath=path)], pre_size=256)[0]["img"])
    jcfg, pcfg = _cfgs()
    got = loader.DatasetWrapper([Datum(impath=path)], transforms.TestTransform(pcfg))[0]["img"]
    ref = JaxWrapper([JaxDatum(impath=path)], jax_transforms.TestTransform(jcfg))[0]["img"]
    # the port's eval view is uint8 (it normalizes on the device); JAX's is
    # that view normalized on the host
    norm = (got.astype(np.float32) / 255.0 - np.asarray(pcfg.INPUT.PIXEL_MEAN, np.float32)) / (
        np.asarray(pcfg.INPUT.PIXEL_STD, np.float32))
    np.testing.assert_array_equal(np.asarray(ref), norm.astype(np.float32))
