"""uint8 image operations as Pillow computes them, without Pillow.

The JAX package's data layer works on PIL images (``Image.resize``,
``transform``, ``rotate``, ``filter``, ``convert``, ``blend``, ``point`` and
the Python of ``ImageOps``, ``ImageEnhance`` and ``ImageStat``:
fsvlm_tpu/data/transforms.py, data/autoaugment.py, data/loader.py).  The
port does not depend on Pillow, so these functions reproduce its 8-bit
arithmetic on (H, W, 3) uint8 numpy arrays, byte for byte:

- ``resize(img, (w, h), interpolation, box)``: bilinear and bicubic (a =
  -0.5) are two separable passes, horizontal first, each rounded to uint8.
  Each output pixel's filter is centred at ``box0 + (i + 0.5) * scale``
  with scale = box width / out width (float32 box, as Pillow parses it),
  its support widened by ``max(scale, 1)``; its taps are normalized to sum
  1, then turned into fixed point with 22 fractional bits.  A pass is
  skipped where Pillow skips it; a box of whole pixels whose size is the
  output's is a crop, as in Pillow.  Nearest samples the source under
  ``box0 + (i + 0.5) * scale``, the positions accumulated in float64 as
  Pillow's affine scaler does.  The same size with no box is a copy;
- ``affine`` and ``rotate``: ``Image.transform(size, AFFINE, data,
  fillcolor=...)`` and ``Image.rotate(angle, fillcolor=...)`` with nearest
  sampling (``rotate`` builds Pillow's matrix in Python, sends 0/90/180/270
  to a transpose as Pillow does, then takes the affine path);
- ``gaussian_blur``, ``to_hsv`` / ``from_hsv``, ``smooth`` (the SMOOTH
  filter), ``blend``, ``to_l`` / ``grayscale``, ``point``: the
  per-pixel passes of csrc/imaging.cpp (``fsvlm_tpu_torch.native``, built
  by g++ at first use), each with the GIL released;
- ``autocontrast``, ``equalize``, ``solarize``, ``posterize``, ``invert``
  (``ImageOps``) and the four ``ImageEnhance`` factors: Pillow's Python,
  line for line, over those passes;
- ``flip_lr``, ``crop``, ``pad``, ``paste_fill``: copies.
"""

import math

import numpy as np

from .. import native

FILTERS = {"bilinear": 2, "bicubic": 3}  # Pillow's resampling numbers
SMOOTH_KERNEL = np.asarray([1, 1, 1, 1, 5, 1, 1, 1, 1], np.float32) / np.float32(13)


def _rgb(img, what):
    """``img`` as a contiguous uint8 (H, W, 3) array, the one layout the
    passes of csrc/imaging.cpp take; anything else raises."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{what} takes uint8 (H, W, 3) arrays, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def resize(img, size, interpolation="bilinear", box=None):
    """``Image.fromarray(img).resize((w, h), ..., box=box)`` for a uint8
    (H, W, 3) array; ``size`` is (w, h) and ``box`` (x0, y0, x1, y1), as
    Pillow takes them."""
    img = _rgb(img, "resize")
    out_w, out_h = int(size[0]), int(size[1])
    h, w, c = img.shape
    if box is None:
        box = (0, 0, w, h)
    if (out_w, out_h) == (w, h) and tuple(box) == (0, 0, w, h):
        return img.copy()
    if interpolation != "nearest" and interpolation not in FILTERS:
        raise ValueError(f"Unknown interpolation: {interpolation} "
                         f"(choices: nearest, {', '.join(FILTERS)})")
    if out_w < 1 or out_h < 1:
        raise ValueError("height and width must be > 0")
    x0, y0, x1, y1 = (np.float32(v) for v in box)  # Pillow parses the box as C floats
    if x0 < 0 or y0 < 0:
        raise ValueError("box offset can't be negative")
    if x1 > w or y1 > h:
        raise ValueError("box can't exceed original image size")
    if x1 - x0 < 0 or y1 - y0 < 0:
        raise ValueError("box can't be empty")
    if (x0 - int(x0) == 0 and x1 - x0 == out_w and y0 - int(y0) == 0
            and y1 - y0 == out_h):  # whole pixels at the output's size: a crop
        return crop(img, int(x0), int(y0), out_w, out_h)
    if interpolation == "nearest":
        a = (float(x1 - x0) / out_w, 0.0, float(x0), 0.0, float(y1 - y0) / out_h, float(y0))
        return _affine(img, a, (out_w, out_h), np.zeros((out_h, out_w, c), np.uint8))
    out = np.empty((out_h, out_w, c), np.uint8)
    native.imaging("resample", img, h, w, c, FILTERS[interpolation], x0, y0, x1, y1, out_w, out_h,
                   out)
    return out


def crop(img, left, top, width, height):
    """``Image.crop((left, top, left + width, top + height))`` of a box inside
    the image."""
    h, w = img.shape[:2]
    if left < 0 or top < 0 or left + width > w or top + height > h:
        raise ValueError(f"crop box ({left}, {top}, {width}, {height}) leaves the {w}x{h} image")
    return np.ascontiguousarray(img[top:top + height, left:left + width])


def flip_lr(img):
    """``transpose(Image.FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(img[:, ::-1])


def pad(img, padding):
    """Zero padding of ``padding`` pixels on every side."""
    return np.pad(img, ((padding, padding), (padding, padding), (0, 0)), mode="constant")


def paste_fill(img, box, color):
    """``img.copy(); paste(color, box)``: the box (x0, y0, x1, y1) filled."""
    out = img.copy()
    x0, y0, x1, y1 = box
    out[y0:y1, x0:x1] = color
    return out


def _affine(img, a, size, out):
    native.imaging("affine_nearest", img, img.shape[0], img.shape[1], img.shape[2],
                   np.ascontiguousarray(a, np.float64), size[1], size[0], out)
    return out


def affine(img, data, fill):
    """``Image.transform(img.size, Image.AFFINE, data, fillcolor=fill)``
    (nearest): output pixel (x, y) takes the source pixel under (a x + b y
    + c, d x + e y + f); outside the source, ``fill``."""
    img = _rgb(img, "affine")
    if len(data) < 6:
        raise ValueError(f"affine takes 6 coefficients, got {len(data)}")
    h, w, c = img.shape
    out = np.empty((h, w, c), np.uint8)
    out[...] = np.asarray(fill, np.uint8)
    return _affine(img, tuple(float(v) for v in data[:6]), (w, h), out)


def rotate(img, angle, fill):
    """``Image.rotate(angle, fillcolor=fill)`` (nearest, no expand): Pillow's
    transposes at 0, 180 and (square images) 90 and 270 degrees, else its
    matrix about the centre (cos and sin rounded to 15 places)."""
    img = _rgb(img, "rotate")
    h, w = img.shape[:2]
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2]
    m[5] = m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return affine(img, m, fill)


def gaussian_blur(img, radius):
    """``img.filter(ImageFilter.GaussianBlur(radius))``."""
    img = _rgb(img, "gaussian_blur")
    out = np.empty_like(img)
    native.imaging("gaussian_blur", img, *img.shape, float(radius), out)
    return out


def to_hsv(img):
    """``convert("HSV")`` of an RGB image."""
    img = _rgb(img, "to_hsv")
    out = np.empty_like(img)
    native.imaging("rgb_to_hsv", img, img.shape[0] * img.shape[1], out)
    return out


def from_hsv(hsv):
    """``Image.fromarray(hsv, "HSV").convert("RGB")``."""
    hsv = _rgb(hsv, "from_hsv")
    out = np.empty_like(hsv)
    native.imaging("hsv_to_rgb", hsv, hsv.shape[0] * hsv.shape[1], out)
    return out


def to_l(img):
    """``convert("L")``: (H, W) uint8, (R 19595 + G 38470 + B 7471 + 2^15)
    >> 16."""
    img = _rgb(img, "to_l")
    out = np.empty(img.shape[:2], np.uint8)
    native.imaging("grayscale", img, img.shape[0] * img.shape[1], 1, out)
    return out


def grayscale(img):
    """``convert("L").convert("RGB")``."""
    img = _rgb(img, "grayscale")
    out = np.empty_like(img)
    native.imaging("grayscale", img, img.shape[0] * img.shape[1], 3, out)
    return out


def blend(im1, im2, alpha):
    """``Image.blend(im1, im2, alpha)``: im1 + alpha (im2 - im1) in float,
    truncated for alpha in [0, 1], clipped to 0-255 outside it."""
    im1, im2 = _rgb(im1, "blend"), _rgb(im2, "blend")
    if im1.shape != im2.shape:
        raise ValueError(f"blend: images do not match, {im1.shape} and {im2.shape}")
    out = np.empty_like(im1)
    native.imaging("blend", im1, im2, im1.size, float(alpha), out)
    return out


def smooth(img):
    """``img.filter(ImageFilter.SMOOTH)``: the 3x3 kernel (1 1 1, 1 5 1, 1 1
    1) / 13 in float, border pixels kept."""
    img = _rgb(img, "smooth")
    out = np.empty_like(img)
    native.imaging("filter3x3", img, *img.shape, SMOOTH_KERNEL, 0.0, out)
    return out


def point(img, lut):
    """``img.point(flat_lut)`` for a table of 256 entries per band (Pillow
    clips each entry to 0-255); a table of 256 serves every band."""
    img = _rgb(img, "point")
    c = img.shape[2]
    table = np.clip(np.asarray(lut, np.int64).reshape(-1, 256), 0, 255).astype(np.uint8)
    if len(table) == 1:
        table = np.repeat(table, c, axis=0)
    out = np.empty_like(img)
    native.imaging("lut", img, img.shape[0] * img.shape[1], c, np.ascontiguousarray(table), out)
    return out


def _histograms(img):
    return [np.bincount(img[..., b].ravel(), minlength=256) for b in range(img.shape[2])]


# ------------------------------------------------------------------ ImageOps
def autocontrast(img):
    """``ImageOps.autocontrast(img)`` (no cutoff, nothing ignored)."""
    lut = []
    for h in _histograms(img):
        nz = np.flatnonzero(h)
        lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (255, 0)
        if hi <= lo:
            lut.append(np.arange(256))
        else:
            scale = 255.0 / (hi - lo)
            offset = -lo * scale
            lut.append(np.clip(np.trunc(np.arange(256) * scale + offset), 0, 255))
    return point(img, np.stack(lut))


def equalize(img):
    """``ImageOps.equalize(img)``."""
    lut = []
    for h in _histograms(img):
        histo = h[h > 0]
        step = (int(histo.sum()) - int(histo[-1])) // 255 if len(histo) > 1 else 0
        if not step:
            lut.append(np.arange(256))
        else:
            n = step // 2 + np.concatenate([[0], np.cumsum(h)[:-1]])
            lut.append(n // step)
    return point(img, np.stack(lut))


def solarize(img, threshold=128):
    """``ImageOps.solarize(img, threshold)``."""
    i = np.arange(256)
    return point(img, np.where(i < threshold, i, 255 - i))


def posterize(img, bits):
    """``ImageOps.posterize(img, bits)``."""
    return point(img, np.arange(256) & ~(2 ** (8 - bits) - 1))


def invert(img):
    """``ImageOps.invert(img)``."""
    return point(img, 255 - np.arange(256))


# -------------------------------------------------------------- ImageEnhance
def brightness(img, factor):
    """``ImageEnhance.Brightness(img).enhance(factor)``."""
    return blend(np.zeros_like(img), img, factor)


def contrast(img, factor):
    """``ImageEnhance.Contrast(img).enhance(factor)``: the degenerate image is
    the L mean, ``int(mean + 0.5)`` (ImageStat), in every band."""
    l_img = to_l(img)
    mean = int(int(l_img.sum(dtype=np.int64)) / l_img.size + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def color(img, factor):
    """``ImageEnhance.Color(img).enhance(factor)``."""
    return blend(grayscale(img), img, factor)


def sharpness(img, factor):
    """``ImageEnhance.Sharpness(img).enhance(factor)``."""
    return blend(smooth(img), img, factor)


# ------------------------------------------------------------------ views
def resize_center_crop(img, size, interpolation):
    """The eval view (transforms.py:_resize_center_crop): resize so the
    shorter edge is max(size), the long edge truncated as torchvision's
    Resize does, then crop (th, tw) from the centre, offsets rounded."""
    th, tw = size
    h, w = img.shape[:2]
    target = max(th, tw)
    if w <= h:
        nw, nh = target, int(target * h / w)
    else:
        nw, nh = int(target * w / h), target
    img = resize(img, (nw, nh), interpolation)
    return crop(img, int(round((nw - tw) / 2.0)), int(round((nh - th) / 2.0)), tw, th)


def resize_shorter_center_crop(img, size):
    """The device-aug cache view (loader.py:RawDatasetWrapper): bilinear
    resize so the shorter edge is ``size`` (both edges rounded), then a
    ``size`` square from the centre, offsets floored."""
    h, w = img.shape[:2]
    s = size / min(w, h)
    nw, nh = round(w * s), round(h * s)
    img = resize(img, (nw, nh), "bilinear")
    return crop(img, (nw - size) // 2, (nh - size) // 2, size, size)
