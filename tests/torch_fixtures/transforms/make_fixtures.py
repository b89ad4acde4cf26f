"""Write the expected outputs of the host train transforms on the committed
JPEG fixtures.

    python tests/torch_fixtures/transforms/make_fixtures.py

For every pipeline of ``PIPELINES`` and every JPEG of
tests/torch_fixtures/jpeg/, the JAX package's ``TrainTransform`` (or, under
INPUT.NO_TRANSFORM, its ``build_transform``'s eval view) runs on Pillow's
``Image.open(path).convert("RGB")`` with ``random.Random(seed + i)``, ``i``
the fixture's place in sorted order.  ``expected.json`` holds the pipelines
(their config overrides and seeds) and, per pipeline and fixture, the
float32 output's shape, sha256 and float64 sum (and, where inexact, every
``SAMPLE_STRIDE``-th value).  ``exact`` pipelines are compared by the
sha256; gaussian_noise and instance_norm (float reductions and normal
draws that may differ in the last ulp between machines) by the samples and
the sum, within 1e-6.

``tests/test_torch_transforms.py`` and ``chip_smoke.py`` (phase 13) hold
the port's ``TrainTransform`` to these digests.
"""

import hashlib
import json
import os
import random
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "jpeg")
sys.path.insert(0, ROOT)

SAMPLE_STRIDE = 4099
RECIPE = ["random_resized_crop", "random_flip", "normalize"]
# name: (INPUT.TRANSFORMS, INPUT.INTERPOLATION, INPUT.SIZE, seed)
PIPELINES = {
    "recipe_bicubic": (RECIPE, "bicubic", (224, 224), 1000),
    "recipe_bilinear": (RECIPE, "bilinear", (224, 224), 2000),
    "simclr": (["random_resized_crop", "random_flip", "colorjitter", "randomgrayscale",
                "gaussian_blur", "normalize"], "bicubic", (224, 224), 3000),
    "colorjitter": (["random_resized_crop", "colorjitter", "normalize"], "bicubic", (224, 224),
                    4000),
    "imagenet_policy": (["random_resized_crop", "random_flip", "imagenet_policy", "normalize"],
                        "bicubic", (224, 224), 5000),
    "cifar10_policy": (["random_resized_crop", "random_flip", "cifar10_policy", "normalize"],
                       "bicubic", (224, 224), 6000),
    "svhn_policy": (["random_resized_crop", "svhn_policy", "normalize"], "bicubic", (224, 224),
                    7000),
    "randaugment": (["random_resized_crop", "random_flip", "randaugment", "cutout", "normalize"],
                    "bicubic", (224, 224), 8000),
    "randaugment2": (["random_resized_crop", "randaugment2", "cutout", "normalize"], "bicubic",
                     (224, 224), 9000),
    "randaugment_fixmatch": (["random_resized_crop", "random_flip", "randaugment_fixmatch",
                              "cutout", "normalize"], "bicubic", (224, 224), 10000),
    "random_translation": (["random_translation", "random_flip", "normalize"], "bicubic",
                           (224, 224), 11000),
    "random_crop": (["random_crop", "random_flip", "normalize"], "bicubic", (64, 64), 12000),
    "center_crop": (["center_crop", "normalize"], "bilinear", (224, 224), 13000),
    "no_transform": (RECIPE, "bicubic", (224, 224), 14000),  # under INPUT.NO_TRANSFORM
    "gaussian_noise": (["random_resized_crop", "gaussian_noise", "normalize"], "bicubic",
                       (224, 224), 15000),
    "instance_norm": (["random_resized_crop", "random_flip", "instance_norm"], "bicubic",
                      (224, 224), 16000),
}
INEXACT = ("gaussian_noise", "instance_norm")


def digest(x, exact):
    x = np.ascontiguousarray(x, np.float32)
    out = {"shape": list(x.shape), "sha256": hashlib.sha256(x.tobytes()).hexdigest(),
           "sum": float(x.sum(dtype=np.float64))}
    if not exact:
        out["sample"] = [float(v) for v in x.ravel()[::SAMPLE_STRIDE]]
    return out


def fixtures():
    return sorted(f for f in os.listdir(JPEG_DIR) if f.endswith(".jpg"))


def main():
    from fsvlm_tpu.config import get_cfg_default
    from fsvlm_tpu.data import transforms

    out = {"sample_stride": SAMPLE_STRIDE, "pipelines": {}, "digests": {}}
    for name, (tfms, interp, size, seed) in PIPELINES.items():
        cfg = get_cfg_default()
        cfg.INPUT.TRANSFORMS = tuple(tfms)
        cfg.INPUT.INTERPOLATION = interp
        cfg.INPUT.SIZE = tuple(size)
        cfg.INPUT.PIXEL_MEAN = list(transforms.CLIP_PIXEL_MEAN)
        cfg.INPUT.PIXEL_STD = list(transforms.CLIP_PIXEL_STD)
        cfg.INPUT.NO_TRANSFORM = name == "no_transform"
        tfm = transforms.build_transform(cfg, is_train=True)
        out["pipelines"][name] = {"transforms": list(tfms), "interpolation": interp,
                                  "size": list(size), "no_transform": cfg.INPUT.NO_TRANSFORM,
                                  "seed": seed, "exact": name not in INEXACT}
        digests = out["digests"][name] = {}
        for i, f in enumerate(fixtures()):
            img = Image.open(os.path.join(JPEG_DIR, f)).convert("RGB")
            if cfg.INPUT.NO_TRANSFORM:
                x = tfm(img)
            else:
                x = tfm(img, rng=random.Random(seed + i))
            digests[f] = digest(x, name not in INEXACT)
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    n = sum(len(d) for d in out["digests"].values())
    print(f"wrote {n} digests ({len(PIPELINES)} pipelines x {len(fixtures())} fixtures)")


if __name__ == "__main__":
    main()
