"""The port's host train transforms against the JAX package's Pillow
pipeline, on the CPU, byte for byte.

- every imaging pass of ``data.imageops`` (csrc/imaging.cpp) against
  Pillow's own call on the same image, over hypothesis-drawn images from
  1x1 to 300x300: the box resize (bilinear, bicubic, nearest; boxes on and
  off the pixel grid, box sizes equal to the output), the Gaussian blur at
  radii over [0.1, 2.0], HSV both ways with hue shifts over [-25, 25],
  affine and rotate (both signs, +-90), SMOOTH, blend (factors in [0, 1] and
  past it), L, ImageOps and ImageEnhance; HSV, L and blend also
  exhaustively (every RGB triple; every byte pair);
- ``TrainTransform`` for each pipeline of
  tests/torch_fixtures/transforms/expected.json over seeded draws,
  against JAX's ``TrainTransform.__call__``: bit-equal (gaussian_noise and
  instance_norm within 1e-6), the rng left in the same state; the pixel
  stage shipped as uint8 and normalized is the float view;
- the committed fixtures' digests (make_fixtures.py);
- the library is built from csrc/ by g++ and a failed build raises.
"""

import json
import os
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.data import autoaugment as jax_aa
from fsvlm_tpu.data import transforms as jax_transforms
from fsvlm_tpu_torch import native
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.data import imageops, transforms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")
with open(os.path.join(FIXTURES, "transforms", "expected.json")) as _f:
    EXPECTED = json.load(_f)
FILL = (128, 128, 128)
INTERP = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC, "nearest": Image.NEAREST}


@st.composite
def images(draw, max_side=300):
    """uint8 (H, W, 3): noise or smooth gradients (odd widths included)."""
    h = draw(st.integers(1, max_side))
    w = draw(st.integers(1, max_side))
    seed = draw(st.integers(0, 2**31 - 1))
    rs = np.random.RandomState(seed)
    if draw(st.booleans()):
        return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w, 1), y * 255 // max(h, 1), (x + y) % 256], -1)
    return np.clip(base + rs.randint(-8, 9, (h, w, 3)), 0, 255).astype(np.uint8)


def _eq(got, ref):
    ref = np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------- passes
@settings(max_examples=60, deadline=None)
@given(img=images(), data=st.data())
@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
def test_box_resize_matches_pillow(interp, img, data):
    h, w = img.shape[:2]
    bw, bh = data.draw(st.integers(1, w)), data.draw(st.integers(1, h))
    j, i = data.draw(st.integers(0, w - bw)), data.draw(st.integers(0, h - bh))
    frac = data.draw(st.sampled_from([0.0, 0.25, 0.5, 0.73]))
    box = (j + frac * (bw > 1), i, j + bw, i + bh - frac * (bh > 1))
    if data.draw(st.booleans()):  # the output at the box's size
        size = (bw, bh)
    else:
        size = (data.draw(st.integers(1, 240)), data.draw(st.integers(1, 240)))
    ref = Image.fromarray(img).resize(size, INTERP[interp], box=box)
    _eq(imageops.resize(img, size, interp, box=box), ref)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_box_resize_origin_off_zero_at_the_output_size(interp):
    """A box of whole pixels at the output's size is Pillow's crop; off the
    grid it takes both passes."""
    img = np.random.RandomState(0).randint(0, 256, (50, 60, 3)).astype(np.uint8)
    for box in [(5, 7, 25, 37), (5.5, 7, 25.5, 37), (0, 3, 20, 33), (0, 0, 20, 30)]:
        ref = Image.fromarray(img).resize((20, 30), INTERP[interp], box=box)
        _eq(imageops.resize(img, (20, 30), interp, box=box), ref)
    np.testing.assert_array_equal(imageops.resize(img, (20, 30), interp, box=(5, 7, 25, 37)),
                                  img[7:37, 5:25])


def test_resize_refuses_what_pillow_refuses():
    img = np.zeros((10, 12, 3), np.uint8)
    for box, match in [((-1, 0, 5, 5), "negative"), ((0, 0, 13, 5), "exceed"),
                       ((5, 0, 4, 5), "empty")]:
        with pytest.raises(ValueError, match=match):
            imageops.resize(img, (4, 4), "bicubic", box=box)
        with pytest.raises(ValueError, match=match):
            Image.fromarray(img).resize((4, 4), Image.BICUBIC, box=box)


@settings(max_examples=80, deadline=None)
@given(img=images(), radius=st.floats(0.1, 2.0))
def test_gaussian_blur_matches_pillow(img, radius):
    ref = Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius=radius))
    _eq(imageops.gaussian_blur(img, radius), ref)


@settings(max_examples=60, deadline=None)
@given(img=images(), shift=st.floats(-25.0, 25.0))
def test_hsv_round_trip_with_a_hue_shift_matches_pillow(img, shift):
    ref_hsv = np.asarray(Image.fromarray(img).convert("HSV"))
    hsv = imageops.to_hsv(img)
    _eq(hsv, ref_hsv)
    hsv[..., 0] = (hsv[..., 0].astype(int) + int(shift)) % 256
    _eq(imageops.from_hsv(hsv), Image.fromarray(hsv, "HSV").convert("RGB"))


def _all_rgb():
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(
        4096, 4096, 3)


def test_hsv_and_l_on_every_rgb_triple():
    a = _all_rgb()
    im = Image.fromarray(a)
    _eq(imageops.to_hsv(a), im.convert("HSV"))
    _eq(imageops.from_hsv(a), Image.fromarray(a, "HSV").convert("RGB"))
    _eq(imageops.to_l(a), im.convert("L"))
    _eq(imageops.grayscale(a), im.convert("L").convert("RGB"))


def test_blend_on_every_byte_pair():
    p = np.arange(65536)
    x = np.stack([p >> 8, p & 255, (p * 7) & 255], -1).astype(np.uint8).reshape(256, 256, 3)
    y = np.stack([p & 255, p >> 8, (p * 13) & 255], -1).astype(np.uint8).reshape(256, 256, 3)
    alphas = list(np.random.RandomState(0).uniform(-1.0, 3.0, 24)) + [0.0, 1.0, 0.5, 1.9, -0.5]
    for alpha in alphas:
        ref = Image.blend(Image.fromarray(x), Image.fromarray(y), float(alpha))
        _eq(imageops.blend(x, y, alpha), ref)


@settings(max_examples=60, deadline=None)
@given(img=images(), v=st.floats(0.0, 0.45), sign=st.sampled_from([-1, 1]))
def test_affine_ops_match_pillow(img, v, sign):
    im, v = Image.fromarray(img), sign * v
    h, w = img.shape[:2]
    _eq(imageops.affine(img, (1, v, 0, 0, 1, 0), FILL), jax_aa._shear_x(im, v))
    _eq(imageops.affine(img, (1, 0, 0, v, 1, 0), FILL), jax_aa._shear_y(im, v))
    _eq(imageops.affine(img, (1, 0, v * w, 0, 1, 0), FILL), jax_aa._translate_x(im, v))
    _eq(imageops.affine(img, (1, 0, 0, 0, 1, v * h), FILL), jax_aa._translate_y(im, v))


@settings(max_examples=60, deadline=None)
@given(img=images(), angle=st.one_of(st.floats(-30.0, 30.0),
                                     st.sampled_from([90, -90, 180, 270, 0, 360, -30.0])))
def test_rotate_matches_pillow(img, angle):
    _eq(imageops.rotate(img, angle, FILL), Image.fromarray(img).rotate(angle, fillcolor=FILL))


@settings(max_examples=60, deadline=None)
@given(img=images(), factor=st.one_of(st.floats(0.0, 1.0), st.floats(1.0, 3.0)))
def test_smooth_and_the_enhancers_match_pillow(img, factor):
    im = Image.fromarray(img)
    _eq(imageops.smooth(img), im.filter(ImageFilter.SMOOTH))
    _eq(imageops.brightness(img, factor), ImageEnhance.Brightness(im).enhance(factor))
    _eq(imageops.contrast(img, factor), ImageEnhance.Contrast(im).enhance(factor))
    _eq(imageops.color(img, factor), ImageEnhance.Color(im).enhance(factor))
    _eq(imageops.sharpness(img, factor), ImageEnhance.Sharpness(im).enhance(factor))


@settings(max_examples=60, deadline=None)
@given(img=images(), div=st.integers(1, 80), threshold=st.integers(0, 256),
       bits=st.integers(1, 8))
def test_imageops_match_pillow(img, div, threshold, bits):
    low = (img // div).astype(np.uint8)  # few levels: equalize's and autocontrast's edges
    for a in (img, low):
        im = Image.fromarray(a)
        _eq(imageops.autocontrast(a), ImageOps.autocontrast(im))
        _eq(imageops.equalize(a), ImageOps.equalize(im))
        _eq(imageops.solarize(a, threshold), ImageOps.solarize(im, threshold))
        _eq(imageops.posterize(a, bits), ImageOps.posterize(im, bits))
        _eq(imageops.invert(a), ImageOps.invert(im))
        _eq(imageops.to_l(a), im.convert("L"))


def test_flip_pad_and_paste():
    img = np.random.RandomState(3).randint(0, 256, (7, 9, 3)).astype(np.uint8)
    _eq(imageops.flip_lr(img), Image.fromarray(img).transpose(Image.FLIP_LEFT_RIGHT))
    assert imageops.pad(img, 4).shape == (15, 17, 3)
    ref = Image.fromarray(img)
    ref.paste(FILL, (2, 1, 6, 5))
    _eq(imageops.paste_fill(img, (2, 1, 6, 5), FILL), ref)


# ----------------------------------------------------------- TrainTransform
def _pipeline_cfgs(spec):
    cfgs = (jax_get_cfg_default(), get_cfg_base())
    for cfg in cfgs:
        cfg.INPUT.TRANSFORMS = tuple(spec["transforms"])
        cfg.INPUT.INTERPOLATION = spec["interpolation"]
        cfg.INPUT.SIZE = tuple(spec["size"])
        cfg.INPUT.PIXEL_MEAN = list(jax_transforms.CLIP_PIXEL_MEAN)
        cfg.INPUT.PIXEL_STD = list(jax_transforms.CLIP_PIXEL_STD)
        cfg.INPUT.NO_TRANSFORM = spec["no_transform"]
    return cfgs


def _normalized(u8, cfg):
    x = u8.astype(np.float32) / 255.0
    if "normalize" in cfg.INPUT.TRANSFORMS:
        x = (x - np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32)) / np.asarray(
            cfg.INPUT.PIXEL_STD, np.float32)
    return x.astype(np.float32)


@pytest.mark.parametrize("name", sorted(EXPECTED["pipelines"]))
def test_train_transform_matches_jax(name):
    spec = EXPECTED["pipelines"][name]
    jcfg, pcfg = _pipeline_cfgs(spec)
    rs = np.random.RandomState(spec["seed"])
    jt, pt = jax_transforms.build_transform(jcfg), transforms.build_transform(pcfg)
    for trial in range(12):
        h, w = rs.randint(max(spec["size"]) // 2 + 28, 320, 2)  # random_crop needs >= 56
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if spec["no_transform"]:
            np.testing.assert_array_equal(_normalized(pt(img), pcfg), jt(Image.fromarray(img)))
            continue
        r1, r2, r3 = (random.Random(trial) for _ in range(3))
        ref = jt(Image.fromarray(img), rng=r1)
        got = pt(img, rng=r2)
        assert got.dtype == np.float32 and got.shape == ref.shape
        if spec["exact"]:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        assert r1.getstate() == r2.getstate()  # the same draws in the same order
        if pt.uint8_suffices(pcfg):  # what the loader ships then
            np.testing.assert_array_equal(_normalized(pt.pixels(img, r3), pcfg), ref)
            assert r3.getstate() == r1.getstate()


def test_train_transform_refuses_unknown_choices_and_uses_its_own_rng():
    _, pcfg = _pipeline_cfgs(EXPECTED["pipelines"]["recipe_bicubic"])
    pcfg.INPUT.TRANSFORMS = ("random_flip", "sharpen")
    with pytest.raises(ValueError, match="sharpen"):
        transforms.TrainTransform(pcfg)
    pcfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
    img = np.random.RandomState(1).randint(0, 256, (90, 70, 3)).astype(np.uint8)
    a = transforms.TrainTransform(pcfg, rng=random.Random(5))
    b = transforms.TrainTransform(pcfg, rng=random.Random(5))
    np.testing.assert_array_equal(a(img), b(img))
    pcfg.INPUT.INTERPOLATION = "lanczos"
    with pytest.raises(ValueError, match="INTERPOLATION"):
        transforms.TrainTransform(pcfg)


def test_uint8_suffices_only_where_the_trainer_normalizes_alike():
    _, pcfg = _pipeline_cfgs(EXPECTED["pipelines"]["simclr"])
    tfm = transforms.TrainTransform(pcfg)
    assert tfm.uint8_suffices(pcfg)
    other = get_cfg_base()
    other.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
    assert not tfm.uint8_suffices(other)
    other.INPUT.PIXEL_MEAN = list(pcfg.INPUT.PIXEL_MEAN)
    other.INPUT.TRANSFORMS = ("random_resized_crop",)
    assert not tfm.uint8_suffices(other)
    _, pcfg = _pipeline_cfgs(EXPECTED["pipelines"]["randaugment"])  # cutout: a float stage
    assert not transforms.TrainTransform(pcfg).uint8_suffices(pcfg)


# ----------------------------------------------------------------- fixtures
@pytest.mark.parametrize("name", sorted(EXPECTED["pipelines"]))
def test_fixture_digests(name):
    """The port on the committed JPEGs against make_fixtures.py's digests of
    the JAX package's outputs (as chip_smoke.py phase 13 checks them)."""
    import hashlib

    spec = EXPECTED["pipelines"][name]
    _, pcfg = _pipeline_cfgs(spec)
    tfm = transforms.build_transform(pcfg)
    for i, (f, want) in enumerate(sorted(EXPECTED["digests"][name].items())):
        img = native.read_image(os.path.join(FIXTURES, "jpeg", f))
        if spec["no_transform"]:
            x = _normalized(tfm(img), pcfg)
        else:
            x = tfm(img, rng=random.Random(spec["seed"] + i))
        assert list(x.shape) == want["shape"], f
        if spec["exact"]:
            assert hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest() == want["sha256"]
        else:
            sample = x.ravel()[::EXPECTED["sample_stride"]]
            np.testing.assert_allclose(sample, want["sample"], rtol=0, atol=1e-6, err_msg=f)
            assert abs(float(x.sum(dtype=np.float64)) - want["sum"]) <= 1e-6 * x.size


def test_the_imaging_library_builds_from_the_sources_and_a_failed_build_raises(tmp_path,
                                                                               monkeypatch):
    info = native.build_info()
    assert os.path.isfile(info["path"])
    assert os.path.join("csrc", "imaging.cpp") in " ".join(native.SOURCES)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
