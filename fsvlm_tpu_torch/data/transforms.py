"""Host image transforms (counterpart of fsvlm_tpu.data.transforms), no
Pillow.

- ``TrainTransform``: the config-driven stochastic train pipeline
  (transforms.py:80-188), all 18 ``AVAI_CHOICES`` in the JAX package's
  order and with its draws from a ``random.Random``, so that one seed gives
  the same choices.  It runs in two stages.  ``pixels(img, rng)`` is the
  pixel stage on the uint8 (H, W, 3) array (translation, the crops, flip,
  the AutoAugment policies and RandAugment variants, colour jitter,
  grayscale, blur), byte-equal to the JAX package's Pillow pipeline
  through ``imageops``.  ``finish(x, rng)`` is the float stage (x / 255,
  cutout, normalize, gaussian_noise from a numpy RandomState seeded from
  the rng, instance_norm) in the same numpy operations and order.
  ``__call__`` runs both and returns what the JAX package's returns:
  float32 (H, W, 3).  Where ``uint8_suffices`` (no float-stage op but
  normalize), the loader ships the pixel stage's uint8 and the trainer
  normalizes on the device (``SimpleTrainer.eval_images``).
- ``TestTransform``: resize the shorter edge to max(INPUT.SIZE) with
  INPUT.INTERPOLATION, then centre-crop INPUT.SIZE (transforms.py:178-225).
  It returns the uint8 view; the trainer normalizes on the device
  (``ops.preprocess.normalize_only``, or x/255 when "normalize" is not in
  INPUT.TRANSFORMS), where the JAX package normalizes on the host.
- ``build_transform``: the eval view for ``is_train=False`` and under
  INPUT.NO_TRANSFORM; for training, None under DATALOADER.DEVICE_AUG (the
  augmentation runs in the train step on the device), else TrainTransform.
"""

import math
import random

import numpy as np

from ..ops.preprocess import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD  # noqa: F401  (re-exported)
from . import autoaugment, imageops

AVAI_CHOICES = [
    "random_flip",
    "random_resized_crop",
    "normalize",
    "instance_norm",
    "random_crop",
    "random_translation",
    "center_crop",
    "cutout",
    "imagenet_policy",
    "cifar10_policy",
    "svhn_policy",
    "randaugment",
    "randaugment_fixmatch",
    "randaugment2",
    "gaussian_noise",
    "colorjitter",
    "randomgrayscale",
    "gaussian_blur",
]
POLICIES = ("imagenet_policy", "cifar10_policy", "svhn_policy")
FLOAT_STAGE = ("cutout", "gaussian_noise", "instance_norm")  # ops past x / 255 but normalize


def _check_interp(interp):
    if interp not in ("nearest", *imageops.FILTERS):
        raise ValueError(f"Unknown INPUT.INTERPOLATION: {interp}")
    return interp


def random_resized_crop_params(rng, width, height, scale, ratio=(3 / 4, 4 / 3)):
    """Sample crop box (i, j, h, w) with torchvision semantics."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h)
            j = rng.randint(0, width - w)
            return i, j, h, w
    # fallback: center crop of clamped aspect
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    i = (height - h) // 2
    j = (width - w) // 2
    return i, j, h, w


class TrainTransform:
    """Config-driven stochastic train pipeline producing float32 HWC arrays
    (or, ``pixels`` alone, the uint8 view before the float stage)."""

    def __init__(self, cfg, rng=None):
        self.size = tuple(cfg.INPUT.SIZE)
        self.interp = _check_interp(cfg.INPUT.INTERPOLATION)
        self.choices = list(cfg.INPUT.TRANSFORMS)
        self.scale = tuple(cfg.INPUT.RRCROP_SCALE)
        self.mean = np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32)
        self.std = np.asarray(cfg.INPUT.PIXEL_STD, np.float32)
        self.normalize = "normalize" in self.choices
        self.gb_p = cfg.INPUT.GB_P
        self.cj = (cfg.INPUT.COLORJITTER_B, cfg.INPUT.COLORJITTER_C, cfg.INPUT.COLORJITTER_S,
                   cfg.INPUT.COLORJITTER_H)
        self.ra_n = cfg.INPUT.RANDAUGMENT_N
        self.ra_m = cfg.INPUT.RANDAUGMENT_M
        self.rgs_p = cfg.INPUT.RGS_P
        self.crop_padding = cfg.INPUT.CROP_PADDING
        self.cutout_n = cfg.INPUT.CUTOUT_N
        self.cutout_len = cfg.INPUT.CUTOUT_LEN
        self.gn_mean = cfg.INPUT.GN_MEAN
        self.gn_std = cfg.INPUT.GN_STD
        self.rng = rng or random.Random()

        unknown = [c for c in self.choices if c not in AVAI_CHOICES]
        if unknown:
            raise ValueError(f"Unknown INPUT.TRANSFORMS entries: {unknown}")

    def uint8_suffices(self, cfg):
        """Whether the pixel stage's uint8, normalized as the trainer
        normalizes a uint8 batch under ``cfg`` (``eval_images``), is this
        transform's output: no float-stage op, and the same normalize rule,
        mean and std."""
        same = self.normalize == ("normalize" in cfg.INPUT.TRANSFORMS)
        if self.normalize:
            same = same and np.array_equal(self.mean, np.float32(cfg.INPUT.PIXEL_MEAN)) \
                and np.array_equal(self.std, np.float32(cfg.INPUT.PIXEL_STD))
        return same and not any(c in self.choices for c in FLOAT_STAGE)

    def __call__(self, img, rng=None):
        # per-call rng (when given) keeps the augmentation stream independent
        # of loader thread interleaving (DatasetWrapper)
        rng = rng or self.rng
        return self.finish(self.pixels(img, rng), rng)

    def pixels(self, img, rng=None):
        """The pixel stage: uint8 (H, W, 3) -> uint8 INPUT.SIZE view."""
        rng = rng or self.rng
        img = np.asarray(img)
        out_h, out_w = self.size

        # translation runs BEFORE the crops and gives a target-size image itself
        translated = False
        if "random_translation" in self.choices:
            img = _random_translation(img, out_h, out_w, rng)
            translated = True

        h, w = img.shape[:2]
        if "random_resized_crop" in self.choices:
            i, j, ch, cw = random_resized_crop_params(rng, w, h, self.scale)
            img = imageops.resize(img, (out_w, out_h), self.interp, box=(j, i, j + cw, i + ch))
        elif "random_crop" in self.choices:
            img = _pad_and_random_crop(img, (out_h, out_w), self.crop_padding, rng)
        elif not translated and ("center_crop" in self.choices or (w, h) != (out_w, out_h)):
            img = imageops.resize_center_crop(img, (out_h, out_w), self.interp)

        if "random_flip" in self.choices and rng.random() < 0.5:
            img = imageops.flip_lr(img)

        policy = next((p for p in POLICIES if p in self.choices), None)
        if policy is not None:
            img = autoaugment.auto_augment(img, policy, rng)
        if "randaugment" in self.choices:
            img = autoaugment.rand_augment(img, self.ra_n, self.ra_m, rng)
        if "randaugment2" in self.choices:
            img = autoaugment.rand_augment2(img, self.ra_n, rng)
        if "randaugment_fixmatch" in self.choices:
            img = autoaugment.rand_augment_fixmatch(img, self.ra_n, rng)

        if "colorjitter" in self.choices:
            img = _color_jitter(img, self.cj, rng)

        if "randomgrayscale" in self.choices and rng.random() < self.rgs_p:
            img = imageops.grayscale(img)

        if "gaussian_blur" in self.choices and rng.random() < self.gb_p:
            sigma = rng.uniform(0.1, 2.0)
            img = imageops.gaussian_blur(img, sigma)
        return img

    def finish(self, img, rng=None):
        """The float stage: uint8 view -> float32, as the JAX package's."""
        rng = rng or self.rng
        x = np.asarray(img, np.float32) / 255.0

        if "cutout" in self.choices:
            x = _cutout(x, self.cutout_n, self.cutout_len, rng)

        if self.normalize:
            x = (x - self.mean) / self.std

        if "gaussian_noise" in self.choices:
            # from the per-call rng, never the process-wide np.random, which
            # loader threads would share
            noise_rng = np.random.RandomState(rng.randrange(2**31))
            x = x + noise_rng.normal(self.gn_mean, self.gn_std, x.shape).astype(np.float32)

        if "instance_norm" in self.choices:
            x = (x - x.mean((0, 1))) / (x.std((0, 1)) + 1e-8)

        return x.astype(np.float32)


class TestTransform:
    """The deterministic eval view: uint8 (H, W, 3) -> uint8 INPUT.SIZE."""

    def __init__(self, cfg):
        self.size = tuple(cfg.INPUT.SIZE)
        self.interp = _check_interp(cfg.INPUT.INTERPOLATION)
        self.normalize = "normalize" in cfg.INPUT.TRANSFORMS

    def __call__(self, img):
        return imageops.resize_center_crop(np.asarray(img), self.size, self.interp)


def _random_translation(img, th, tw, rng, p=0.5):
    """Random2DTranslation: with prob p, resize to 1.125x target then
    random-crop to target; else plain resize.  Always BILINEAR, as the
    reference (the cfg interpolation is not passed through)."""
    if rng.random() > p:
        return imageops.resize(img, (tw, th), "bilinear")
    nw = int(round(tw * 1.125))
    nh = int(round(th * 1.125))
    img = imageops.resize(img, (nw, nh), "bilinear")
    x1 = int(round(rng.uniform(0, nw - tw)))
    y1 = int(round(rng.uniform(0, nh - th)))
    return imageops.crop(img, x1, y1, tw, th)


def _pad_and_random_crop(img, size, padding, rng):
    th, tw = size
    arr = imageops.pad(img, padding)
    h, w = arr.shape[:2]
    i = rng.randint(0, h - th)
    j = rng.randint(0, w - tw)
    return np.ascontiguousarray(arr[i:i + th, j:j + tw])


def _color_jitter(img, cj, rng):
    """The JAX package's ColorJitter: brightness, contrast and saturation in
    a shuffled order, hue last as an integer shift of Pillow's HSV."""
    b, c, s, h = cj
    ops = []
    if b > 0:
        ops.append(lambda im: imageops.brightness(im, rng.uniform(max(0, 1 - b), 1 + b)))
    if c > 0:
        ops.append(lambda im: imageops.contrast(im, rng.uniform(max(0, 1 - c), 1 + c)))
    if s > 0:
        ops.append(lambda im: imageops.color(im, rng.uniform(max(0, 1 - s), 1 + s)))
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    if h > 0:
        hsv = imageops.to_hsv(img)
        shift = int(rng.uniform(-h, h) * 255)
        hsv[..., 0] = (hsv[..., 0].astype(int) + shift) % 256
        img = imageops.from_hsv(hsv)
    return img


def _cutout(x, n_holes, length, rng):
    h, w = x.shape[:2]
    for _ in range(n_holes):
        y = rng.randint(0, h - 1)
        xx = rng.randint(0, w - 1)
        y1, y2 = max(0, y - length // 2), min(h, y + length // 2)
        x1, x2 = max(0, xx - length // 2), min(w, xx + length // 2)
        x[y1:y2, x1:x2] = 0.0
    return x


def build_transform(cfg, is_train=True):
    """The counterpart of the JAX package's build_transform: TestTransform
    under INPUT.NO_TRANSFORM and for eval; for training TrainTransform, or
    None under DATALOADER.DEVICE_AUG (the train step augments on the
    device)."""
    if cfg.INPUT.NO_TRANSFORM or not is_train:
        return TestTransform(cfg)
    if cfg.DATALOADER.DEVICE_AUG:
        return None
    return TrainTransform(cfg)
