"""Dataset primitives: Datum, DatasetBase, few-shot machinery (counterpart of
fsvlm_tpu.data.base_dataset, kept line for line so that one seed gives the
same splits and few-shot subsets in both packages).

Behavior parity targets:
- Datum / DatasetBase: Dassl.pytorch dassl/data/datasets/base_dataset.py:12-237
- uniform + per-class few-shot with pickle cache, base/new subsampling:
  PromptSRC/datasets/oxford_pets.py:37-268 (the same skeleton is repeated in
  every reference plugin; here it lives once in FewShotPipeline)

Divergences (documented):
- randomness uses a local random.Random(cfg.SEED) instead of reseeding the
  global RNG (reference seeds `random` module-wide at plugin init).
- the per-class few-shot cache is written AND keyed by the shot list hash;
  the reference's cache is write-only and collides across shot settings
  (SURVEY.md §5.4 quirk, deliberately not replicated).
"""

import hashlib
import math
import os
import pickle
import random
from collections import defaultdict
from dataclasses import dataclass

from ..utils import mkdir_if_missing, read_json, write_json


@dataclass(frozen=True)
class Datum:
    """One example: image path + label + domain + human-readable class name."""

    impath: str = ""
    label: int = 0
    domain: int = 0
    classname: str = ""


class DatasetBase:
    """Container for train_x/train_u/val/test split lists of Datum."""

    dataset_dir = ""
    domains = []

    def __init__(self, train_x=None, train_u=None, val=None, test=None):
        self._train_x = train_x
        self._train_u = train_u
        self._val = val
        self._test = test
        self._num_classes = self.get_num_classes(train_x)
        self._lab2cname, self._classnames = self.get_lab2cname(train_x)

    train_x = property(lambda self: self._train_x)
    train_u = property(lambda self: self._train_u)
    val = property(lambda self: self._val)
    test = property(lambda self: self._test)
    lab2cname = property(lambda self: self._lab2cname)
    classnames = property(lambda self: self._classnames)
    num_classes = property(lambda self: self._num_classes)

    @staticmethod
    def get_num_classes(data_source):
        if not data_source:
            return 0
        return max(item.label for item in data_source) + 1

    @staticmethod
    def get_lab2cname(data_source):
        if not data_source:
            return {}, []
        mapping = {item.label: item.classname for item in data_source}
        labels = sorted(mapping)
        return mapping, [mapping[l] for l in labels]

    def check_input_domains(self, source_domains, target_domains):
        """Validate SOURCE/TARGET_DOMAINS against self.domains (parity:
        dassl base_dataset.py:122-134)."""
        assert len(source_domains) > 0, "source_domains (list) is empty"
        assert len(target_domains) > 0, "target_domains (list) is empty"
        self.is_input_domain_valid(source_domains)
        self.is_input_domain_valid(target_domains)

    def is_input_domain_valid(self, input_domains):
        for domain in input_domains:
            if domain not in self.domains:
                raise ValueError(
                    f"Input domain must belong to {self.domains}, "
                    f"but got [{domain}]"
                )

    @staticmethod
    def split_dataset_by_label(data_source):
        out = defaultdict(list)
        for item in data_source:
            out[item.label].append(item)
        return out

    @staticmethod
    def split_dataset_by_domain(data_source):
        out = defaultdict(list)
        for item in data_source:
            out[item.domain].append(item)
        return out


# ---------------------------------------------------------------------------
# split (de)serialization — the split_zhou_<Name>.json format
# ---------------------------------------------------------------------------

def read_split(filepath, path_prefix):
    """Read a split_zhou_*.json into (train, val, test) Datum lists
    (format per oxford_pets.py:179-195)."""

    def convert(items):
        return [
            Datum(impath=os.path.join(path_prefix, imp), label=int(lab), classname=cname)
            for imp, lab, cname in items
        ]

    print(f"Reading split from {filepath}")
    split = read_json(filepath)
    return convert(split["train"]), convert(split["val"]), convert(split["test"])


def save_split(train, val, test, filepath, path_prefix):
    """Write the split_zhou_*.json format (oxford_pets.py:155-177)."""

    def extract(items):
        out = []
        for item in items:
            impath = item.impath.replace(path_prefix, "")
            if impath.startswith("/"):
                impath = impath[1:]
            out.append((impath, item.label, item.classname))
        return out

    write_json(
        {"train": extract(train), "val": extract(val), "test": extract(test)}, filepath
    )
    print(f"Saved split to {filepath}")


def read_and_split_data(image_dir, p_trn=0.5, p_val=0.2, ignored=(), new_cnames=None,
                        rng=None):
    """Split a class-per-folder image tree into 50/20/30 train/val/test
    (dtd.py:86-124)."""
    from ..utils import listdir_nohidden

    rng = rng or random
    categories = [c for c in listdir_nohidden(image_dir) if c not in ignored]
    categories.sort()
    p_tst = 1 - p_trn - p_val
    print(f"Splitting into {p_trn:.0%} train, {p_val:.0%} val, {p_tst:.0%} test")

    train, val, test = [], [], []
    for label, category in enumerate(categories):
        category_dir = os.path.join(image_dir, category)
        images = [os.path.join(category_dir, im) for im in listdir_nohidden(category_dir)]
        rng.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        assert n_train > 0 and n_val > 0 and n_total - n_train - n_val > 0

        cname = category
        if new_cnames and category in new_cnames:
            cname = new_cnames[category]

        def collate(ims):
            return [Datum(impath=im, label=label, classname=cname) for im in ims]

        train.extend(collate(images[:n_train]))
        val.extend(collate(images[n_train : n_train + n_val]))
        test.extend(collate(images[n_train + n_val :]))
    return train, val, test


class _FewshotUnpickler(pickle.Unpickler):
    """Reads a few-shot cache (or ImageNet's ``preprocessed.pkl``) written by
    either package: a ``Datum`` of the JAX package's is read as this
    module's (importing nothing of it)."""

    def find_class(self, module, name):
        if name == "Datum" and module.endswith("data.base_dataset"):
            return Datum
        return super().find_class(module, name)


# ---------------------------------------------------------------------------
# few-shot sampling + base/new subsampling
# ---------------------------------------------------------------------------

def generate_fewshot(dataset, num_shots, rng):
    """Uniform K-shot subsample per class (oxford_pets.py:255-268)."""
    if num_shots < 1:
        return dataset
    tracker = DatasetBase.split_dataset_by_label(dataset)
    out = []
    for label, items in tracker.items():
        idxs = list(range(len(items)))
        rng.shuffle(idxs)
        out.extend(items[i] for i in idxs[:num_shots])
    return out


def generate_per_class_fewshot(dataset, shots_per_class, rng):
    """Per-class shot-list subsample — the imbalanced few-shot protocol
    (oxford_pets.py:239-253).  shots_per_class[label] = #shots for label."""
    tracker = DatasetBase.split_dataset_by_label(dataset)
    out = []
    for label, items in tracker.items():
        idxs = list(range(len(items)))
        rng.shuffle(idxs)
        out.extend(items[i] for i in idxs[: shots_per_class[label]])
    return out


def subsample_classes(*splits, subsample="all"):
    """Keep the first (base) or second (new) half of the sorted label set and
    relabel contiguously (oxford_pets.py:197-237)."""
    assert subsample in ("all", "base", "new")
    if subsample == "all":
        return list(splits)

    labels = sorted({item.label for item in splits[0]})
    m = math.ceil(len(labels) / 2)
    selected = labels[:m] if subsample == "base" else labels[m:]
    relabeler = {y: i for i, y in enumerate(selected)}
    print(f"SUBSAMPLE {subsample.upper()} CLASSES!")

    out = []
    for split in splits:
        out.append(
            [
                Datum(
                    impath=item.impath,
                    label=relabeler[item.label],
                    domain=item.domain,
                    classname=item.classname,
                )
                for item in split
                if item.label in selected
            ]
        )
    return out


def apply_fewshot_pipeline(cfg, dataset_dir, train, val, *, val_key="val"):
    """The shared few-shot + cache + subsample pipeline every plugin runs
    (oxford_pets.py:37-112).

    Returns (train, val).  NUM_SHOTS > 0 → uniform K-shot (val capped at
    min(K, 4)); NUM_SHOTS < 0 with a non-empty PER_CLASS_SHOTS list → the
    imbalanced per-class protocol; NUM_SHOTS == 0 → untouched.
    """
    num_shots = cfg.DATASET.NUM_SHOTS
    per_class_shots = list(cfg.DATASET.PER_CLASS_SHOTS)
    seed = cfg.SEED
    rng = random.Random(seed)

    split_fewshot_dir = os.path.join(dataset_dir, "split_fewshot")
    mkdir_if_missing(split_fewshot_dir)

    if num_shots > 0:
        cache = os.path.join(split_fewshot_dir, f"shot_{num_shots}-seed_{seed}.pkl")
        if os.path.exists(cache):
            print(f"Loading few-shot data from {cache}")
            with open(cache, "rb") as f:
                data = _FewshotUnpickler(f).load()
            return data["train"], data[val_key]
        train = generate_fewshot(train, num_shots, rng)
        val = generate_fewshot(val, min(num_shots, 4), rng)
        print(f"Saving few-shot data to {cache}")
        with open(cache, "wb") as f:
            pickle.dump({"train": train, val_key: val}, f, protocol=pickle.HIGHEST_PROTOCOL)
        return train, val

    if num_shots < 0 and per_class_shots:
        # divergence: cache keyed by the shot list so different imbalance
        # settings don't collide (reference cache is write-only, §5.4)
        digest = hashlib.sha1(str(per_class_shots).encode()).hexdigest()[:10]
        cache = os.path.join(
            split_fewshot_dir, f"per_class_shots-{digest}-seed_{seed}.pkl"
        )
        if os.path.exists(cache):
            print(f"Loading per-class few-shot data from {cache}")
            with open(cache, "rb") as f:
                data = _FewshotUnpickler(f).load()
            return data["train"], data[val_key]
        val_shots = [min(s, 4) for s in per_class_shots]
        train = generate_per_class_fewshot(train, per_class_shots, rng)
        val = generate_per_class_fewshot(val, val_shots, rng)
        print(f"Saving per-class few-shot data to {cache}")
        with open(cache, "wb") as f:
            pickle.dump({"train": train, val_key: val}, f, protocol=pickle.HIGHEST_PROTOCOL)
        return train, val

    return train, val
