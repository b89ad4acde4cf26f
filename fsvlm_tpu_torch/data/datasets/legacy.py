"""The Dassl DA/DG/SSL datasets (counterpart of
fsvlm_tpu.data.datasets.legacy, kept line for line so that one tree and
one seed give the same splits in both packages).

Each plugin turns an on-disk layout of Dassl.pytorch's
dassl/data/datasets/{da,dg,ssl} loaders into Datum lists: folder names,
label derivation, sampling caps, error-path skips.  The common layouts are
three helpers (class folders, flat ``<name>_<label>`` image lists, text
split files).  What decides the result where it could differ:

- Digit5 samples through the global ``random`` (``set_random_seed`` seeds
  it), as the JAX package does;
- SSL CIFAR sorts each class's file names before the seeded
  ``random.Random(SEED)`` shuffle; STL10 parses its folds at full width;
- PACS takes 1-based labels and skips its known-corrupt sketch image;
- VLCS reads only ``*.jpg``; DigitsDG and OfficeHomeDG read every file,
  class names lower-cased from the path;
- ``listdir_nohidden`` is left unsorted where the JAX package leaves it so:
  both read the same directory, in the same order.

The images are JPEG or PNG files (PACS's sketch domain, the digit and SSL
layouts are PNG), read by the port's decoders.  The WILDS sets raise unless
the ``wilds`` package is installed, as in the JAX package.
"""

import glob
import math
import os.path as osp
import random

import numpy as np

from ...utils import listdir_nohidden
from ..base_dataset import DatasetBase, Datum
from ..data_manager import DATASET_REGISTRY


def _read_class_dirs(domain_dir, domain=0, lower=False, label_from_name=False):
    """<domain_dir>/<class_name>/<img> with labels from sorted class names
    (office31.py / office_home.py) or parsed from 'label_name' folders
    (cifarstl.py: '0_airplane')."""
    items = []
    class_names = listdir_nohidden(domain_dir)
    class_names.sort()
    for label, class_name in enumerate(class_names):
        if label_from_name:
            label = int(class_name.split("_")[0])
        class_path = osp.join(domain_dir, class_name)
        for imname in listdir_nohidden(class_path):
            items.append(Datum(
                impath=osp.join(class_path, imname), label=label,
                domain=domain,
                classname=class_name.lower() if lower else class_name))
    return items


def _read_image_list(im_dir, n_max=None, n_repeat=None, shuffle_sample=False,
                     rng=None):
    """<im_dir>/<name>_<label>.<ext> flat image lists (digit5.py,
    digit_single.py).  digit5 samples n_max randomly; digit_single takes
    the first n_max (Volpi et al. protocol, digit_single.py:26-28)."""
    items = []
    for imname in listdir_nohidden(im_dir):
        label = int(osp.splitext(imname)[0].split("_")[1])
        items.append((osp.join(im_dir, imname), label))
    if n_max is not None:
        if shuffle_sample:
            items = (rng or random).sample(items, min(n_max, len(items)))
        else:
            items = items[:n_max]
    if n_repeat is not None:
        items = items * n_repeat
    return items


def _read_split_txt(split_file, image_root, label_offset=0, skip=(),
                    classname_index=-2):
    """'<relpath> <label>' text split files (domainnet.py, pacs.py)."""
    items = []
    with open(split_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            impath, label = line.split(" ")
            if impath in skip:
                continue
            classname = impath.split("/")[classname_index]
            items.append((osp.join(image_root, impath),
                          int(label) + label_offset, classname))
    return items


# --------------------------------------------------------------------- DA

class _DomainFolderDA(DatasetBase):
    """Shared skeleton: train_x = sources, train_u = test = targets, each
    domain a folder of class folders (office31.py, office_home.py)."""

    lower_classnames = False

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train_x = self._read_data(cfg.DATASET.SOURCE_DOMAINS)
        train_u = self._read_data(cfg.DATASET.TARGET_DOMAINS)
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS)
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    def _read_data(self, input_domains):
        items = []
        for domain, dname in enumerate(input_domains):
            items += _read_class_dirs(
                osp.join(self.dataset_dir, dname), domain,
                lower=self.lower_classnames)
        return items


@DATASET_REGISTRY.register()
class Office31(_DomainFolderDA):
    """Office-31: amazon/webcam/dslr, 31 classes (da/office31.py)."""

    dataset_dir = "office31"
    domains = ["amazon", "webcam", "dslr"]


@DATASET_REGISTRY.register()
class OfficeHome(_DomainFolderDA):
    """Office-Home: art/clipart/product/real_world, 65 classes
    (da/office_home.py; classnames lowercased)."""

    dataset_dir = "office_home"
    domains = ["art", "clipart", "product", "real_world"]
    lower_classnames = True


@DATASET_REGISTRY.register()
class Digit5(DatasetBase):
    """Five digit domains; 25k/9k random samples per domain (USPS train
    repeated 3x) (da/digit5.py)."""

    dataset_dir = "digit5"
    domains = ["mnist", "mnist_m", "svhn", "syn", "usps"]

    TRAIN_MAX, TEST_MAX = 25000, 9000

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train_x = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        train_u = self._read_data(cfg.DATASET.TARGET_DOMAINS, "train")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            im_dir = osp.join(self.dataset_dir, dname,
                              "train_images" if split == "train" else "test_images")
            if dname == "usps":
                pairs = _read_image_list(
                    im_dir, n_repeat=3 if split == "train" else None)
            else:
                n_max = self.TRAIN_MAX if split == "train" else self.TEST_MAX
                pairs = _read_image_list(im_dir, n_max=n_max,
                                         shuffle_sample=True)
            items += [Datum(impath=p, label=l, domain=domain, classname=str(l))
                      for p, l in pairs]
        return items


@DATASET_REGISTRY.register()
class VisDA17(DatasetBase):
    """Simulation-to-real; image_list.txt per split (da/visda17.py)."""

    dataset_dir = "visda17"
    domains = ["synthetic", "real"]

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train_x = self._read_data("synthetic")
        train_u = self._read_data("real")
        test = self._read_data("real")
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    def _read_data(self, dname):
        filedir = "train" if dname == "synthetic" else "validation"
        image_list = osp.join(self.dataset_dir, filedir, "image_list.txt")
        items = []
        with open(image_list) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                impath, label = line.split(" ")
                items.append(Datum(
                    impath=osp.join(self.dataset_dir, filedir, impath),
                    label=int(label), domain=0,
                    classname=impath.split("/")[0]))
        return items


class _SplitTxtDA(DatasetBase):
    """'<domain>_<split>.txt' split files under split_dir
    (da/domainnet.py, da/mini_domainnet.py)."""

    split_dirname = "splits"
    has_val = False

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.split_dir = osp.join(self.dataset_dir, self.split_dirname)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train_x = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        train_u = self._read_data(cfg.DATASET.TARGET_DOMAINS, "train")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        kw = {}
        if self.has_val:
            kw["val"] = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "test")
        super().__init__(train_x=train_x, train_u=train_u, test=test, **kw)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            split_file = osp.join(self.split_dir, f"{dname}_{split}.txt")
            for impath, label, classname in _read_split_txt(
                    split_file, self.dataset_dir, classname_index=1):
                items.append(Datum(impath=impath, label=label, domain=domain,
                                   classname=classname))
        return items


@DATASET_REGISTRY.register()
class DomainNet(_SplitTxtDA):
    """DomainNet: 6 domains, 345 classes, txt splits (da/domainnet.py;
    source-test as val)."""

    dataset_dir = "domainnet"
    domains = ["clipart", "infograph", "painting", "quickdraw", "real",
               "sketch"]
    has_val = True


@DATASET_REGISTRY.register()
class miniDomainNet(_SplitTxtDA):
    """miniDomainNet: 4 domains, 126 classes, 96x96 (da/mini_domainnet.py)."""

    dataset_dir = "domainnet"
    domains = ["clipart", "painting", "real", "sketch"]
    split_dirname = "splits_mini"


@DATASET_REGISTRY.register()
class CIFARSTL(DatasetBase):
    """CIFAR-10 <-> STL-10 overlap domains; '<label>_<name>' class folders
    (da/cifarstl.py)."""

    dataset_dir = "cifar_stl"
    domains = ["cifar", "stl"]

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train_x = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        train_u = self._read_data(cfg.DATASET.TARGET_DOMAINS, "train")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            items += _read_class_dirs(
                osp.join(self.dataset_dir, dname, split), domain,
                label_from_name=True)
        return items


# --------------------------------------------------------------------- DG

@DATASET_REGISTRY.register()
class PACS(DatasetBase):
    """PACS: kfold txt splits, labels are 1-based in the files, one known
    corrupt sketch image skipped (dg/pacs.py)."""

    dataset_dir = "pacs"
    domains = ["art_painting", "cartoon", "photo", "sketch"]
    _error_paths = ["sketch/dog/n02103406_4068-1.png"]

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.image_dir = osp.join(self.dataset_dir, "images")
        self.split_dir = osp.join(self.dataset_dir, "splits")
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        val = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "crossval")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "all")
        super().__init__(train_x=train, val=val, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            if split == "all":
                files = [osp.join(self.split_dir, f"{dname}_train_kfold.txt"),
                         osp.join(self.split_dir, f"{dname}_crossval_kfold.txt")]
            else:
                files = [osp.join(self.split_dir, f"{dname}_{split}_kfold.txt")]
            for file in files:
                for impath, label, classname in _read_split_txt(
                        file, self.image_dir, label_offset=-1,
                        skip=self._error_paths):
                    items.append(Datum(impath=impath, label=label,
                                       domain=domain, classname=classname))
        return items


@DATASET_REGISTRY.register()
class VLCS(DatasetBase):
    """VLCS: UPPERCASED domain dirs with train/crossval/test class folders
    (dg/vlcs.py)."""

    dataset_dir = "VLCS"
    domains = ["caltech", "labelme", "pascal", "sun"]

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        val = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "crossval")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        super().__init__(train_x=train, val=val, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            path = osp.join(self.dataset_dir, dname.upper(), split)
            folders = listdir_nohidden(path)
            folders.sort()
            for label, folder in enumerate(folders):
                for impath in glob.glob(osp.join(path, folder, "*.jpg")):
                    items.append(Datum(impath=impath, label=label,
                                       domain=domain, classname=folder))
        return items


class _FolderSplitDG(DatasetBase):
    """<domain>/{train,val}/<class>/<img> folder layout; test = target
    train+val ("all") (dg/digits_dg.py read_data)."""

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train = self.read_data(self.dataset_dir,
                               cfg.DATASET.SOURCE_DOMAINS, "train")
        val = self.read_data(self.dataset_dir,
                             cfg.DATASET.SOURCE_DOMAINS, "val")
        test = self.read_data(self.dataset_dir,
                              cfg.DATASET.TARGET_DOMAINS, "all")
        super().__init__(train_x=train, val=val, test=test)

    @staticmethod
    def read_data(dataset_dir, input_domains, split):
        def load_dir(directory):
            pairs = []
            folders = listdir_nohidden(directory)
            folders.sort()
            for label, folder in enumerate(folders):
                for impath in glob.glob(osp.join(directory, folder, "*")):
                    pairs.append((impath, label))
            return pairs

        items = []
        for domain, dname in enumerate(input_domains):
            if split == "all":
                pairs = load_dir(osp.join(dataset_dir, dname, "train"))
                pairs += load_dir(osp.join(dataset_dir, dname, "val"))
            else:
                pairs = load_dir(osp.join(dataset_dir, dname, split))
            for impath, label in pairs:
                items.append(Datum(
                    impath=impath, label=label, domain=domain,
                    classname=impath.split("/")[-2].lower()))
        return items


@DATASET_REGISTRY.register()
class DigitsDG(_FolderSplitDG):
    """Digits-DG: mnist/mnist_m/svhn/syn (dg/digits_dg.py)."""

    dataset_dir = "digits_dg"
    domains = ["mnist", "mnist_m", "svhn", "syn"]


@DATASET_REGISTRY.register()
class OfficeHomeDG(_FolderSplitDG):
    """Office-Home DG split layout (dg/office_home_dg.py)."""

    dataset_dir = "office_home_dg"
    domains = ["art", "clipart", "product", "real_world"]


@DATASET_REGISTRY.register()
class DigitSingle(DatasetBase):
    """Single-source digit generalization (dg/digit_single.py): first 10k
    source train images (deterministic, Volpi et al.), source test as val,
    target tests as test."""

    dataset_dir = "digit5"
    domains = ["mnist", "mnist_m", "svhn", "syn", "usps"]
    TRAIN_MAX = 10000

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        train = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "train")
        val = self._read_data(cfg.DATASET.SOURCE_DOMAINS, "test")
        test = self._read_data(cfg.DATASET.TARGET_DOMAINS, "test")
        super().__init__(train_x=train, val=val, test=test)

    def _read_data(self, input_domains, split):
        items = []
        for domain, dname in enumerate(input_domains):
            im_dir = osp.join(self.dataset_dir, dname,
                              "train_images" if split == "train" else "test_images")
            n_max = self.TRAIN_MAX if (split == "train" and dname != "usps") else None
            pairs = _read_image_list(im_dir, n_max=n_max)
            items += [Datum(impath=p, label=l, domain=domain, classname=str(l))
                      for p, l in pairs]
        return items


@DATASET_REGISTRY.register()
class CIFAR10C(DatasetBase):
    """CIFAR-10 -> CIFAR-10-C corruption robustness (dg/cifar_c.py):
    train on clean train/, test on <c_type>/<c_level>/ class folders."""

    dataset_dir = ""
    domains = ["cifar10", "cifar10_c"]
    AVAI_C_TYPES = [
        "brightness", "contrast", "defocus_blur", "elastic_transform", "fog",
        "frost", "gaussian_blur", "gaussian_noise", "glass_blur",
        "impulse_noise", "jpeg_compression", "motion_blur", "pixelate",
        "saturate", "shot_noise", "snow", "spatter", "speckle_noise",
        "zoom_blur",
    ]

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = root
        self.check_input_domains(
            cfg.DATASET.SOURCE_DOMAINS, cfg.DATASET.TARGET_DOMAINS)
        source_domain = cfg.DATASET.SOURCE_DOMAINS[0]
        target_domain = cfg.DATASET.TARGET_DOMAINS[0]
        assert source_domain == self.domains[0]
        assert target_domain == self.domains[1]
        c_type = cfg.DATASET.CIFAR_C_TYPE
        c_level = cfg.DATASET.CIFAR_C_LEVEL
        if not c_type:
            raise ValueError("Please specify DATASET.CIFAR_C_TYPE in the config file")
        assert c_type in self.AVAI_C_TYPES, (
            f'C_TYPE is expected to belong to {self.AVAI_C_TYPES}, '
            f'but got "{c_type}"')
        assert 1 <= int(c_level) <= 5
        train_dir = osp.join(self.dataset_dir, source_domain, "train")
        test_dir = osp.join(self.dataset_dir, target_domain, c_type,
                            str(c_level))
        if not osp.exists(test_dir):
            raise ValueError(f"Test directory not found: {test_dir}")
        train = _read_class_dirs(train_dir)
        test = _read_class_dirs(test_dir)
        super().__init__(train_x=train, test=test)


@DATASET_REGISTRY.register()
class CIFAR100C(CIFAR10C):
    """CIFAR-100 -> CIFAR-100-C (dg/cifar_c.py)."""

    domains = ["cifar100", "cifar100_c"]


# --------------------------------------------------------------------- SSL

@DATASET_REGISTRY.register()
class CIFAR10(DatasetBase):
    """SSL CIFAR-10 (ssl/cifar.py): class folders; first VAL_PERCENT of
    each class's (sorted) images are val, the rest shuffled and split into
    NUM_LABELED/num_classes labeled + remainder unlabeled."""

    dataset_dir = "cifar10"

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        train_dir = osp.join(self.dataset_dir, "train")
        test_dir = osp.join(self.dataset_dir, "test")
        assert cfg.DATASET.NUM_LABELED > 0
        seed = cfg.SEED if cfg.SEED >= 0 else None
        train_x, train_u, val = self._read_data_train(
            train_dir, cfg.DATASET.NUM_LABELED, cfg.DATASET.VAL_PERCENT,
            random.Random(seed))
        test = self._read_data_test(test_dir)
        if cfg.DATASET.ALL_AS_UNLABELED:
            train_u = train_u + train_x
        super().__init__(train_x=train_x, train_u=train_u,
                         val=val or None, test=test)

    @staticmethod
    def _read_data_train(data_dir, num_labeled, val_percent, rng):
        class_names = listdir_nohidden(data_dir)
        class_names.sort()
        num_labeled_per_class = num_labeled / len(class_names)
        items_x, items_u, items_v = [], [], []
        for label, class_name in enumerate(class_names):
            class_dir = osp.join(data_dir, class_name)
            # sorted before the split: the reference takes os.listdir order
            # (ssl/cifar.py:51), making the val/labeled partition depend on
            # filesystem enumeration — sorting keeps the same-seed split
            # byte-identical across machines
            imnames = listdir_nohidden(class_dir, sort=True)
            num_val = math.floor(len(imnames) * val_percent)
            imnames_train = imnames[num_val:]
            imnames_val = imnames[:num_val]
            rng.shuffle(imnames_train)
            for i, imname in enumerate(imnames_train):
                item = Datum(impath=osp.join(class_dir, imname), label=label,
                             classname=class_name)
                if (i + 1) <= num_labeled_per_class:
                    items_x.append(item)
                else:
                    items_u.append(item)
            for imname in imnames_val:
                items_v.append(Datum(impath=osp.join(class_dir, imname),
                                     label=label, classname=class_name))
        return items_x, items_u, items_v

    @staticmethod
    def _read_data_test(data_dir):
        class_names = listdir_nohidden(data_dir)
        class_names.sort()
        items = []
        for label, class_name in enumerate(class_names):
            class_dir = osp.join(data_dir, class_name)
            for imname in listdir_nohidden(class_dir):
                items.append(Datum(impath=osp.join(class_dir, imname),
                                   label=label, classname=class_name))
        return items


@DATASET_REGISTRY.register()
class CIFAR100(CIFAR10):
    """SSL CIFAR-100 (ssl/cifar.py)."""

    dataset_dir = "cifar100"


@DATASET_REGISTRY.register()
class SVHN(CIFAR10):
    """SSL SVHN (ssl/svhn.py — same layout as SSL CIFAR)."""

    dataset_dir = "svhn"


@DATASET_REGISTRY.register()
class STL10(DatasetBase):
    """SSL STL-10 (ssl/stl10.py): '<name>_<label>' flat images, labeled
    folds from stl10_binary/fold_indices.txt, a 100k unlabeled pool
    (label -1)."""

    dataset_dir = "stl10"

    def __init__(self, cfg):
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, self.dataset_dir)
        train_dir = osp.join(self.dataset_dir, "train")
        test_dir = osp.join(self.dataset_dir, "test")
        unlabeled_dir = osp.join(self.dataset_dir, "unlabeled")
        fold_file = osp.join(self.dataset_dir, "stl10_binary",
                             "fold_indices.txt")
        assert -1 <= cfg.DATASET.STL10_FOLD <= 4
        train_x = self._read_data_train(train_dir, cfg.DATASET.STL10_FOLD,
                                        fold_file)
        train_u = self._read_data_all(unlabeled_dir)
        test = self._read_data_all(test_dir)
        if cfg.DATASET.ALL_AS_UNLABELED:
            train_u = train_u + train_x
        super().__init__(train_x=train_x, train_u=train_u, test=test)

    @staticmethod
    def _read_data_train(data_dir, fold, fold_file):
        imnames = listdir_nohidden(data_dir)
        imnames.sort()
        list_idx = list(range(len(imnames)))
        if fold >= 0:
            with open(fold_file) as f:
                str_idx = f.read().splitlines()[fold]
                # documented divergence: the reference parses with
                # np.fromstring(dtype=np.uint8) (ssl/stl10.py:61), silently
                # wrapping every fold index > 255 mod 256 — the folds index
                # the 5000-image train split, so that corrupts the labeled
                # set; parse at full width instead
                list_idx = np.asarray(str_idx.split(), dtype=np.int64)
        items = []
        for i in list_idx:
            imname = imnames[int(i)]
            label = int(osp.splitext(imname)[0].split("_")[1])
            items.append(Datum(impath=osp.join(data_dir, imname), label=label,
                               classname=str(label)))
        return items

    @staticmethod
    def _read_data_all(data_dir):
        items = []
        for imname in listdir_nohidden(data_dir):
            label = osp.splitext(imname)[0].split("_")[1]
            label = -1 if label == "none" else int(label)
            items.append(Datum(impath=osp.join(data_dir, imname), label=label,
                               classname=str(label)))
        return items


# ------------------------------------------------------------------- WILDS

def _wilds_unavailable(name):
    raise RuntimeError(
        f"The {name} dataset needs the optional 'wilds' package "
        "(https://wilds.stanford.edu), which is not installed in this "
        "environment; install it and re-run, or use another dataset."
    )


@DATASET_REGISTRY.register()
class Camelyon17(DatasetBase):
    """WILDS camelyon17 (dg/wilds/): gated on the optional wilds package."""

    def __init__(self, cfg):
        _wilds_unavailable("Camelyon17")


@DATASET_REGISTRY.register()
class FMoW(DatasetBase):
    """WILDS fmow (dg/wilds/): gated on the optional wilds package."""

    def __init__(self, cfg):
        _wilds_unavailable("FMoW")


@DATASET_REGISTRY.register()
class IWildCam(DatasetBase):
    """WILDS iwildcam (dg/wilds/): gated on the optional wilds package."""

    def __init__(self, cfg):
        _wilds_unavailable("IWildCam")
