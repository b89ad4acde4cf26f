"""The in-memory synthetic dataset (counterpart of
fsvlm_tpu.data.datasets.synthetic.Synthetic): random uint8 images with a
per-class colour bias, drawn from one numpy RandomState in the JAX
package's order, so that one SEED gives the same images in both packages.
The images are stored as uint8 arrays (the JAX package stores PIL images
of the same pixels)."""

import numpy as np

from ..base_dataset import DatasetBase, Datum, subsample_classes
from ..data_manager import DATASET_REGISTRY
from ..loader import register_synthetic_image


@DATASET_REGISTRY.register()
class Synthetic(DatasetBase):
    """cfg knobs reused: DATASET.NUM_SHOTS (train images per class),
    PER_CLASS_SHOTS (imbalanced per-class counts), SUBSAMPLE_CLASSES."""

    NUM_CLASSES = 8
    IMG_SIZE = 64
    TEST_PER_CLASS = 4

    def __init__(self, cfg):
        rng = np.random.RandomState(max(cfg.SEED, 0))
        n_cls = self.NUM_CLASSES
        shots = cfg.DATASET.NUM_SHOTS if cfg.DATASET.NUM_SHOTS > 0 else 4
        per_class = list(cfg.DATASET.PER_CLASS_SHOTS) or [shots] * n_cls

        classnames = [f"synthetic class {i}" for i in range(n_cls)]
        base_colors = rng.randint(40, 216, size=(n_cls, 3))

        def make_split(split, counts):
            items = []
            for label in range(n_cls):
                for j in range(counts[label]):
                    key = f"{split}-{label}-{j}"
                    noise = rng.randint(-40, 41, (self.IMG_SIZE, self.IMG_SIZE, 3))
                    img = np.clip(base_colors[label] + noise, 0, 255).astype(np.uint8)
                    register_synthetic_image(key, img)
                    items.append(Datum(impath=f"synthetic://{key}", label=label,
                                       classname=classnames[label]))
            return items

        train = make_split("train", per_class)
        val = make_split("val", [min(s, 4) for s in per_class])
        test = make_split("test", [self.TEST_PER_CLASS] * n_cls)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
        super().__init__(train_x=train, val=val, test=test)
