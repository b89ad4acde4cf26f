"""AutoAugment policies and RandAugment variants (counterpart of
fsvlm_tpu.data.autoaugment) on uint8 (H, W, 3) arrays, without Pillow.

The 16 ops of ``_OPS`` with their magnitude maps (magnitude 0-10 mapped
linearly), ``_SIGNED``, the three published AutoAugment policies,
``auto_augment``, ``rand_augment``, ``rand_augment2`` and
``rand_augment_fixmatch``, each op byte-equal to the JAX package's PIL op
through ``imageops``.  Every draw comes from the caller's ``random.Random``
in the JAX package's order, so that one seed gives the same choices.
"""

import random

from . import imageops

_FILL = (128, 128, 128)


def _shear_x(img, v):
    return imageops.affine(img, (1, v, 0, 0, 1, 0), _FILL)


def _shear_y(img, v):
    return imageops.affine(img, (1, 0, 0, v, 1, 0), _FILL)


def _translate_x(img, v):
    return imageops.affine(img, (1, 0, v * img.shape[1], 0, 1, 0), _FILL)


def _translate_y(img, v):
    return imageops.affine(img, (1, 0, 0, 0, 1, v * img.shape[0]), _FILL)


def _rotate(img, v):
    return imageops.rotate(img, v, _FILL)


def _auto_contrast(img, _):
    return imageops.autocontrast(img)


def _invert(img, _):
    return imageops.invert(img)


def _equalize(img, _):
    return imageops.equalize(img)


def _solarize(img, v):
    return imageops.solarize(img, int(v))


def _posterize(img, v):
    return imageops.posterize(img, max(1, int(v)))


def _contrast(img, v):
    return imageops.contrast(img, v)


def _color(img, v):
    return imageops.color(img, v)


def _brightness(img, v):
    return imageops.brightness(img, v)


def _sharpness(img, v):
    return imageops.sharpness(img, v)


def _identity(img, _):
    return img


def _cutout_abs(img, v, rng=random):
    if v <= 0:
        return img
    h, w = img.shape[:2]
    x = rng.uniform(0, w)
    y = rng.uniform(0, h)
    x0, y0 = int(max(0, x - v / 2)), int(max(0, y - v / 2))
    x1, y1 = int(min(w, x0 + v)), int(min(h, y0 + v))
    return imageops.paste_fill(img, (x0, y0, x1, y1), _FILL)


# op -> (fn, min_magnitude, max_magnitude); magnitude in [0, 10] maps linearly
_OPS = {
    "ShearX": (_shear_x, 0.0, 0.3),
    "ShearY": (_shear_y, 0.0, 0.3),
    "TranslateX": (_translate_x, 0.0, 0.45),
    "TranslateY": (_translate_y, 0.0, 0.45),
    "Rotate": (_rotate, 0.0, 30.0),
    "AutoContrast": (_auto_contrast, 0, 1),
    "Invert": (_invert, 0, 1),
    "Equalize": (_equalize, 0, 1),
    "Solarize": (_solarize, 256.0, 0.0),  # decreasing threshold
    "Posterize": (_posterize, 8.0, 4.0),
    "Contrast": (_contrast, 1.0, 1.9),
    "Color": (_color, 1.0, 1.9),
    "Brightness": (_brightness, 1.0, 1.9),
    "Sharpness": (_sharpness, 1.0, 1.9),
    "Identity": (_identity, 0, 1),
    "Cutout": (_cutout_abs, 0, 40),
}

_SIGNED = {"ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"}


def _apply(img, name, magnitude, rng):
    fn, lo, hi = _OPS[name]
    v = lo + (hi - lo) * magnitude / 10.0
    if name in _SIGNED and rng.random() < 0.5:
        v = -v
    if name == "Cutout":  # the one op with its own randomness (patch center)
        return fn(img, v, rng)
    return fn(img, v)


# (op, probability, magnitude) pairs — the published AutoAugment policies
IMAGENET_POLICY = [
    [("Posterize", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("Posterize", 0.6, 7), ("Posterize", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("Posterize", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("Posterize", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]

CIFAR10_POLICY = [
    [("Invert", 0.1, 7), ("Contrast", 0.2, 6)],
    [("Rotate", 0.7, 2), ("TranslateX", 0.3, 9)],
    [("Sharpness", 0.8, 1), ("Sharpness", 0.9, 3)],
    [("ShearY", 0.5, 8), ("TranslateY", 0.7, 9)],
    [("AutoContrast", 0.5, 8), ("Equalize", 0.9, 2)],
    [("ShearY", 0.2, 7), ("Posterize", 0.3, 7)],
    [("Color", 0.4, 3), ("Brightness", 0.6, 7)],
    [("Sharpness", 0.3, 9), ("Brightness", 0.7, 9)],
    [("Equalize", 0.6, 5), ("Equalize", 0.5, 1)],
    [("Contrast", 0.6, 7), ("Sharpness", 0.6, 5)],
    [("Color", 0.7, 7), ("TranslateX", 0.5, 8)],
    [("Equalize", 0.3, 7), ("AutoContrast", 0.4, 8)],
    [("TranslateY", 0.4, 3), ("Sharpness", 0.2, 6)],
    [("Brightness", 0.9, 6), ("Color", 0.2, 8)],
    [("Solarize", 0.5, 2), ("Invert", 0.0, 3)],
    [("Equalize", 0.2, 0), ("AutoContrast", 0.6, 0)],
    [("Equalize", 0.2, 8), ("Equalize", 0.6, 4)],
    [("Color", 0.9, 9), ("Equalize", 0.6, 6)],
    [("AutoContrast", 0.8, 4), ("Solarize", 0.2, 8)],
    [("Brightness", 0.1, 3), ("Color", 0.7, 0)],
    [("Solarize", 0.4, 5), ("AutoContrast", 0.9, 3)],
    [("TranslateY", 0.9, 9), ("TranslateY", 0.7, 9)],
    [("AutoContrast", 0.9, 2), ("Solarize", 0.8, 3)],
    [("Equalize", 0.8, 8), ("Invert", 0.1, 3)],
    [("TranslateY", 0.7, 9), ("AutoContrast", 0.9, 1)],
]

SVHN_POLICY = [
    [("ShearX", 0.9, 4), ("Invert", 0.2, 3)],
    [("ShearY", 0.9, 8), ("Invert", 0.7, 5)],
    [("Equalize", 0.6, 5), ("Solarize", 0.6, 6)],
    [("Invert", 0.9, 3), ("Equalize", 0.6, 3)],
    [("Equalize", 0.6, 1), ("Rotate", 0.9, 3)],
    [("ShearX", 0.9, 4), ("AutoContrast", 0.8, 3)],
    [("ShearY", 0.9, 8), ("Invert", 0.4, 5)],
    [("ShearY", 0.9, 5), ("Solarize", 0.2, 6)],
    [("Invert", 0.9, 6), ("AutoContrast", 0.8, 1)],
    [("Equalize", 0.6, 3), ("Rotate", 0.9, 3)],
    [("ShearX", 0.9, 4), ("Solarize", 0.3, 3)],
    [("ShearY", 0.8, 8), ("Invert", 0.7, 4)],
    [("Equalize", 0.9, 5), ("TranslateY", 0.6, 6)],
    [("Invert", 0.9, 4), ("Equalize", 0.6, 7)],
    [("Contrast", 0.3, 3), ("Rotate", 0.8, 4)],
    [("Invert", 0.8, 5), ("TranslateY", 0.0, 2)],
    [("ShearY", 0.7, 6), ("Solarize", 0.4, 8)],
    [("Invert", 0.6, 4), ("Rotate", 0.8, 4)],
    [("ShearY", 0.3, 7), ("TranslateX", 0.9, 3)],
    [("ShearX", 0.1, 6), ("Invert", 0.6, 5)],
    [("Solarize", 0.7, 2), ("TranslateY", 0.6, 7)],
    [("ShearY", 0.8, 4), ("Invert", 0.8, 8)],
    [("ShearX", 0.7, 9), ("TranslateY", 0.8, 3)],
    [("ShearY", 0.8, 5), ("AutoContrast", 0.7, 3)],
    [("ShearX", 0.7, 2), ("Invert", 0.1, 5)],
]

_POLICIES = {
    "imagenet_policy": IMAGENET_POLICY,
    "cifar10_policy": CIFAR10_POLICY,
    "svhn_policy": SVHN_POLICY,
}


def auto_augment(img, policy_name, rng=None):
    """Apply one randomly chosen (op, p, magnitude) sub-policy pair."""
    rng = rng or random
    pair = rng.choice(_POLICIES[policy_name])
    for name, p, magnitude in pair:
        if rng.random() < p:
            img = _apply(img, name, magnitude, rng)
    return img


_RAND_OPS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "Color", "Contrast", "Brightness", "Sharpness", "ShearX", "ShearY",
    "TranslateX", "TranslateY",
]


def rand_augment(img, n=2, m=10, rng=None):
    """RandAugment: n ops at fixed magnitude m."""
    rng = rng or random
    for _ in range(n):
        img = _apply(img, rng.choice(_RAND_OPS), m, rng)
    return img


def rand_augment2(img, n=2, rng=None):
    """RandAugment2: n ops at random magnitudes."""
    rng = rng or random
    for _ in range(n):
        img = _apply(img, rng.choice(_RAND_OPS), rng.uniform(0, 10), rng)
    return img


def rand_augment_fixmatch(img, n=2, rng=None):
    """FixMatch-style strong augmentation: random magnitude + cutout."""
    rng = rng or random
    for _ in range(n):
        img = _apply(img, rng.choice(_RAND_OPS), rng.uniform(0, 10), rng)
    return _apply(img, "Cutout", 10, rng)
