"""On-device image preprocessing (counterpart of fsvlm_tpu.ops.preprocess).

The train step gathers uint8 images from a device-resident cache and runs
random-resized-crop + horizontal flip + CLIP-normalize on the device
(fsvlm_tpu/ops/preprocess.py:31-121).  The random draws are split from the
arithmetic, so that a caller (or a test) can hand in its own boxes and flips:

- ``sample_crop_boxes`` / ``sample_flips``: torchvision RandomResizedCrop box
  sampling (10 area/ratio tries, first valid wins, clamped-aspect center
  crop when none is valid) and fair coin flips, drawn from an explicit
  ``torch.Generator`` on the images' device;
- ``crop_resize_flip_normalize``: the bilinear crop-resize of each image's
  box to (out, out), the flip and (x/255 - mean)/std, in fp32.

JAX's threefry bits cannot be reproduced here, so the two packages draw
different boxes from one seed; given the same boxes and flips they compute
the same pixels.
"""

import math

import torch

# CLIP's pixel statistics (fsvlm_tpu/data/transforms.py:21-22)
CLIP_PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
CLIP_PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]


def _stats(mean, std, device):
    """mean and std as float32 tensors on ``device`` (a list is copied there,
    which waits for the device; pass device tensors on a hot path)."""
    mean = torch.as_tensor(mean if mean is not None else CLIP_PIXEL_MEAN,
                           dtype=torch.float32, device=device)
    std = torch.as_tensor(std if std is not None else CLIP_PIXEL_STD,
                          dtype=torch.float32, device=device)
    return mean, std


def normalize_only(images, mean=None, std=None):
    """uint8 (B, S, S, 3) -> normalized float32 on the images' device."""
    mean, std = _stats(mean, std, images.device)
    return ((images.to(torch.float32) / 255.0) - mean) / std


def sample_crop_boxes(n, height, width, scale, generator, ratio=(3 / 4, 4 / 3), tries=10):
    """(n, 4) float32 boxes (i, j, h, w) on ``generator``'s device:
    RandomResizedCrop sampling, vectorized over images and tries
    (parity: _sample_crop_box, preprocess.py:31-78)."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    target_area = (height * width) * uniform((n, tries), scale[0], scale[1])
    aspect = torch.exp(uniform((n, tries), math.log(ratio[0]), math.log(ratio[1])))
    w = torch.round(torch.sqrt(target_area * aspect))
    h = torch.round(torch.sqrt(target_area / aspect))
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    idx = valid.int().argmax(dim=1, keepdim=True)  # first valid try
    any_valid = valid.any(dim=1)
    w_sel = w.gather(1, idx)[:, 0]
    h_sel = h.gather(1, idx)[:, 0]
    u = torch.rand((n, 2), generator=generator, device=dev)
    i_sel = torch.floor(u[:, 0] * (height - h_sel + 1))
    j_sel = torch.floor(u[:, 1] * (width - w_sel + 1))

    # fallback: center crop with the aspect clamped to the ratio range
    in_ratio = width / height
    if in_ratio < ratio[0]:
        fb_w, fb_h = width, round(width / ratio[0])
    elif in_ratio > ratio[1]:
        fb_w, fb_h = round(height * ratio[1]), height
    else:
        fb_w, fb_h = width, height
    fallback = (round((height - fb_h) / 2.0), round((width - fb_w) / 2.0), fb_h, fb_w)
    # Python scalars, not a host tensor: a host-to-device copy would sync
    return torch.stack([torch.where(any_valid, sel, float(fb))
                        for sel, fb in zip((i_sel, j_sel, h_sel, w_sel), fallback)], dim=1)


def sample_flips(n, generator):
    """(n,) bool: each image flipped with probability 1/2."""
    return torch.rand((n,), generator=generator, device=generator.device) < 0.5


def crop_resize_flip_normalize(images, boxes, flips, out_size, mean=None, std=None):
    """images (B, H, W, 3) uint8, boxes (B, 4) float32 (i, j, h, w), flips
    (B,) bool -> (B, out, out, 3) float32 normalized: a bilinear sample of
    each box, mirrored where flipped (parity: _bilinear_crop_resize,
    preprocess.py:81-101, and the normalize of :116-119)."""
    B, H, W, _ = images.shape
    i, j, h, w = (boxes[:, c:c + 1] for c in range(4))
    grid = torch.arange(out_size, dtype=torch.float32, device=images.device) + 0.5
    ys = i + grid * h / out_size - 0.5
    xs = j + grid * w / out_size - 0.5
    xs = torch.where(flips[:, None], j + w - 1 - (xs - j), xs)

    y0 = ys.floor().clamp(0, H - 1)
    x0 = xs.floor().clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    wy = (ys - y0).clamp(0.0, 1.0)[:, :, None, None]
    wx = (xs - x0).clamp(0.0, 1.0)[:, None, :, None]
    y0, y1, x0, x1 = (t.long() for t in (y0, y1, x0, x1))

    b = torch.arange(B, device=images.device)[:, None, None]

    def pix(ry, rx):  # (B, out, out, 3) float32
        return images[b, ry[:, :, None], rx[:, None, :]].float()

    top = pix(y0, x0) * (1 - wx) + pix(y0, x1) * wx
    bot = pix(y1, x0) * (1 - wx) + pix(y1, x1) * wx
    x = top * (1 - wy) + bot * wy
    mean, std = _stats(mean, std, images.device)
    return ((x / 255.0) - mean) / std


def random_resized_crop_flip_normalize(images, generator, out_size=224, scale=(0.08, 1.0),
                                       mean=None, std=None):
    """images (B, P, P, 3) uint8 -> (B, out, out, 3) float32 normalized, with
    boxes and flips drawn from ``generator``."""
    B, H, W, _ = images.shape
    boxes = sample_crop_boxes(B, H, W, scale, generator)
    flips = sample_flips(B, generator)
    return crop_resize_flip_normalize(images, boxes, flips, out_size, mean, std)
