"""The in-memory synthetic datasets (counterpart of
fsvlm_tpu.data.datasets.synthetic): random uint8 images with a per-class
colour bias, drawn from one numpy RandomState in the JAX package's order,
so that one SEED gives the same images in both packages.  Synthetic is the
few-shot set; SyntheticSSL (a labeled split and an unlabeled pool) and
SyntheticDA (three domains with a colour shift each) are the fixtures of
the semi-supervised and domain adaptation / generalization trainers.  The
images are stored as uint8 arrays (the JAX package stores PIL images of the
same pixels)."""

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


@DATASET_REGISTRY.register()
class SyntheticSSL(DatasetBase):
    """SSL fixture: a small labeled split (DATASET.NUM_LABELED images total,
    balanced) plus a larger unlabeled pool in train_u — the synthetic analog
    of the reference SSL datasets (Dassl dassl/data/datasets/ssl/cifar.py:
    labeled/unlabeled partition of one pool; ALL_AS_UNLABELED adds the
    labeled images to the unlabeled pool too)."""

    NUM_CLASSES = 4
    IMG_SIZE = 32
    UNLABELED_PER_CLASS = 8
    TEST_PER_CLASS = 4

    def __init__(self, cfg):
        rng = np.random.RandomState(max(cfg.SEED, 0))
        n_cls = self.NUM_CLASSES
        num_labeled = cfg.DATASET.NUM_LABELED if cfg.DATASET.NUM_LABELED > 0 else 2 * n_cls
        per_class_x = max(num_labeled // n_cls, 1)
        classnames = [f"synthetic class {i}" for i in range(n_cls)]
        base_colors = rng.randint(40, 216, size=(n_cls, 3))

        def make_split(split, counts):
            items = []
            for label in range(n_cls):
                for j in range(counts[label]):
                    key = f"ssl-{split}-{label}-{j}"
                    noise = rng.randint(-40, 41, (self.IMG_SIZE, self.IMG_SIZE, 3))
                    img = np.clip(base_colors[label] + noise, 0, 255).astype(np.uint8)
                    register_synthetic_image(key, img)
                    items.append(Datum(impath=f"synthetic://{key}", label=label,
                                       classname=classnames[label]))
            return items

        train_x = make_split("x", [per_class_x] * n_cls)
        train_u = make_split("u", [self.UNLABELED_PER_CLASS] * n_cls)
        if cfg.DATASET.ALL_AS_UNLABELED:
            train_u = train_u + train_x
        val = make_split("val", [2] * n_cls)
        test = make_split("test", [self.TEST_PER_CLASS] * n_cls)
        super().__init__(train_x=train_x, train_u=train_u, val=val, test=test)


@DATASET_REGISTRY.register()
class SyntheticDA(DatasetBase):
    """DA/DG fixture: three named domains ("d0","d1","d2") sharing classes
    but with a per-domain color shift.  SOURCE_DOMAINS select train_x
    (domain = index into the source list, per the reference convention,
    Dassl base_dataset.py Datum.domain); TARGET_DOMAINS provide train_u
    (unlabeled) and test.  With no TARGET_DOMAINS (DG), test covers the
    sources."""

    NUM_CLASSES = 4
    IMG_SIZE = 32
    TRAIN_PER_CLASS = 6
    TEST_PER_CLASS = 4
    domains = ["d0", "d1", "d2"]

    def __init__(self, cfg):
        rng = np.random.RandomState(max(cfg.SEED, 0))
        n_cls = self.NUM_CLASSES
        classnames = [f"synthetic class {i}" for i in range(n_cls)]
        base_colors = rng.randint(40, 216, size=(n_cls, 3))
        domain_shift = {d: rng.randint(-60, 61, size=3) for d in self.domains}

        def make_split(split, dnames, counts, dlabels=None):
            items = []
            for di, dname in enumerate(dnames):
                for label in range(n_cls):
                    for j in range(counts):
                        key = f"da-{split}-{dname}-{label}-{j}"
                        noise = rng.randint(-30, 31, (self.IMG_SIZE, self.IMG_SIZE, 3))
                        img = np.clip(
                            base_colors[label] + domain_shift[dname] + noise, 0, 255
                        ).astype(np.uint8)
                        register_synthetic_image(key, img)
                        items.append(Datum(
                            impath=f"synthetic://{key}", label=label,
                            domain=dlabels[di] if dlabels else di,
                            classname=classnames[label]))
            return items

        sources = list(cfg.DATASET.SOURCE_DOMAINS) or ["d0", "d1"]
        targets = list(cfg.DATASET.TARGET_DOMAINS)
        self.is_input_domain_valid(sources + targets)
        train_x = make_split("train", sources, self.TRAIN_PER_CLASS)
        train_u = make_split("u", targets, self.TRAIN_PER_CLASS) if targets else None
        eval_domains = targets or sources
        val = make_split("val", eval_domains, 2)
        test = make_split("test", eval_domains, self.TEST_PER_CLASS)
        super().__init__(train_x=train_x, train_u=train_u, val=val, test=test)
