"""Host image transforms (counterpart of fsvlm_tpu.data.transforms), uint8
out, no Pillow.

- ``TestTransform``: resize the shorter edge to max(INPUT.SIZE) with
  INPUT.INTERPOLATION, then centre-crop INPUT.SIZE (transforms.py:178-225),
  as ``imageops`` reproduces Pillow.  It returns the uint8 view; the trainer
  normalizes on the device (``ops.preprocess.normalize_only``, or x/255
  when "normalize" is not in INPUT.TRANSFORMS), where the JAX package
  normalizes on the host.
- The train transforms run on the device under DATALOADER.DEVICE_AUG
  (``ops.preprocess``); the host train pipeline (``TrainTransform``,
  ``autoaugment.py``) is not ported (ROADMAP A12).
"""

import numpy as np

from . import imageops


class TestTransform:
    """The deterministic eval view: uint8 (H, W, 3) -> uint8 INPUT.SIZE."""

    def __init__(self, cfg):
        self.size = tuple(cfg.INPUT.SIZE)
        self.interp = cfg.INPUT.INTERPOLATION
        if self.interp not in ("nearest", *imageops.FILTERS):
            raise ValueError(f"Unknown INPUT.INTERPOLATION: {self.interp}")
        self.normalize = "normalize" in cfg.INPUT.TRANSFORMS

    def __call__(self, img):
        return imageops.resize_center_crop(np.asarray(img), self.size, self.interp)


def build_transform(cfg, is_train=True):
    """The eval view for ``is_train=False``; for training, None under
    DATALOADER.DEVICE_AUG (the augmentation runs in the train step on the
    device), else NotImplementedError."""
    if not is_train:
        return TestTransform(cfg)
    if cfg.DATALOADER.DEVICE_AUG:
        return None
    raise NotImplementedError(
        "the host train transforms (DATALOADER.DEVICE_AUG False: TrainTransform, "
        "autoaugment.py, INPUT.NO_TRANSFORM) are not ported yet (ROADMAP A12); "
        "set DATALOADER.DEVICE_AUG True")
