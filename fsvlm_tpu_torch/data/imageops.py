"""uint8 image resampling as Pillow computes it, without Pillow.

The JAX package's data layer resizes with PIL (``Image.resize``, then
``crop``: fsvlm_tpu/data/transforms.py:192-225, data/loader.py:170-183).
The port does not depend on Pillow, so these functions reproduce its 8-bit
arithmetic on (H, W, 3) uint8 numpy arrays, byte for byte:

- bilinear and bicubic (a = -0.5) are two separable passes, horizontal
  first, each rounded to uint8.  Each output pixel's filter is centred at
  ``(i + 0.5) * in / out``, its support widened by ``max(in / out, 1)``;
  its taps are normalized to sum 1, then turned into fixed point with 22
  fractional bits, rounded half away from zero; the sum starts at half a
  unit and is shifted down and clamped to 0-255;
- nearest takes the source pixel under ``(i + 0.5) * in / out``, the
  positions accumulated in float64 as Pillow's affine scaler does;
- a resize to the same size returns a copy (Pillow's shortcut).

The taps are computed here in numpy; each pass's sums run in C++
(``fsvlm_tpu_torch.native.resample_pass``, ``csrc/resample.cpp``, built by
g++ at first use), with the GIL released.
"""

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coefficients(in_size, out_size, filt, support):
    """(first source index, fixed-point taps) per output index: (out,) int64
    and (out, ksize) int64, taps past a window's end 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = filt((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):  # summed in tap order, as Pillow's loop
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.where(scaled < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, fixed.astype(np.int64)


def _pass(img, out_size, filt, support, axis):
    """One separable pass along ``axis`` (1: horizontal, 0: vertical)."""
    from ..native import resample_pass

    xmin, kk = _coefficients(img.shape[axis], out_size, filt, support)
    return resample_pass(img, out_size, xmin, kk, axis)


def _nearest_index(in_size, out_size):
    scale = in_size / out_size
    pos, out = scale * 0.5, np.empty(out_size, np.int64)
    for i in range(out_size):
        out[i] = int(pos)
        pos += scale
    return np.minimum(out, in_size - 1)


def resize(img, size, interpolation="bilinear"):
    """``Image.fromarray(img).resize((w, h), ...)`` for a uint8 (H, W, 3)
    array; ``size`` is (w, h), as Pillow takes it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize takes uint8 (H, W, C) arrays, got {img.dtype} {img.shape}")
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (out_w, out_h) == (w, h):
        return img.copy()
    if interpolation == "nearest":
        return img[_nearest_index(h, out_h)][:, _nearest_index(w, out_w)]
    if interpolation not in FILTERS:
        raise ValueError(f"Unknown interpolation: {interpolation} "
                         f"(choices: nearest, {', '.join(FILTERS)})")
    filt, support = FILTERS[interpolation]
    out = img
    if out_w != w:
        out = _pass(out, out_w, filt, support, axis=1)
    if out_h != h:
        out = _pass(out, out_h, filt, support, axis=0)
    return out


def crop(img, left, top, width, height):
    """``Image.crop((left, top, left + width, top + height))`` of a box inside
    the image."""
    h, w = img.shape[:2]
    if left < 0 or top < 0 or left + width > w or top + height > h:
        raise ValueError(f"crop box ({left}, {top}, {width}, {height}) leaves the {w}x{h} image")
    return np.ascontiguousarray(img[top:top + height, left:left + width])


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
