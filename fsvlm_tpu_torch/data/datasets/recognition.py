"""The 11 recognition datasets and the 4 ImageNet shifts (counterpart of
fsvlm_tpu.data.datasets.recognition, kept line for line so that one seed and
one tree give the same splits, few-shot subsets and base/new subsets in
both packages).

Directory layouts follow docs/DATASETS.md.  The files a plugin writes
(``split_zhou_<Name>.json``, ``split_fewshot/*.pkl``, ImageNet's
``preprocessed.pkl``) are the JAX package's formats: each package reads the
other's (a pickled ``Datum`` of the JAX package is read as the port's,
importing nothing of it).
"""

import os
import random
from collections import OrderedDict

from ...utils import listdir_nohidden, mkdir_if_missing
from ..base_dataset import (
    DatasetBase,
    Datum,
    _FewshotUnpickler,
    apply_fewshot_pipeline,
    read_and_split_data,
    read_split,
    save_split,
    subsample_classes,
)
from ..data_manager import DATASET_REGISTRY


class _StandardDataset(DatasetBase):
    """Common skeleton: load split -> few-shot pipeline -> base/new subsample."""

    dataset_dir = ""

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        train, val, test = self.load_splits(cfg)
        train, val = apply_fewshot_pipeline(cfg, self.dataset_dir, train, val)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test)

    # -- override points -----------------------------------------------------
    def load_splits(self, cfg):
        raise NotImplementedError


def _json_split_or(build_fallback, split_path, image_dir):
    if os.path.exists(split_path):
        return read_split(split_path, image_dir)
    train, val, test = build_fallback()
    save_split(train, val, test, split_path, image_dir)
    return train, val, test


@DATASET_REGISTRY.register()
class OxfordPets(_StandardDataset):
    dataset_dir = "oxford_pets"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.anno_dir = os.path.join(self.dataset_dir, "annotations")
        split_path = os.path.join(self.dataset_dir, "split_zhou_OxfordPets.json")

        def fallback():
            trainval = self._read_anno("trainval.txt")
            test = self._read_anno("test.txt")
            return _split_trainval(trainval, rng=random.Random(cfg.SEED)) + (test,)

        return _json_split_or(fallback, split_path, self.image_dir)

    def _read_anno(self, split_file):
        """annotations/<split>.txt: '<imname> <label> <species> <breed_id>'
        (oxford_pets.py:114-133)."""
        items = []
        with open(os.path.join(self.anno_dir, split_file)) as f:
            for line in f:
                imname, label, _species, _ = line.strip().split(" ")
                breed = "_".join(imname.split("_")[:-1]).lower()
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, imname + ".jpg"),
                        label=int(label) - 1,
                        classname=breed,
                    )
                )
        return items


def _split_trainval(trainval, p_val=0.2, rng=None):
    """Per-class stratified train/val split (oxford_pets.py:135-158)."""
    rng = rng or random
    print(f"Splitting trainval into {1-p_val:.0%} train and {p_val:.0%} val")
    tracker = DatasetBase.split_dataset_by_label(trainval)
    train, val = [], []
    for label, items in tracker.items():
        idxs = list(range(len(items)))
        n_val = round(len(idxs) * p_val)
        assert n_val > 0
        rng.shuffle(idxs)
        for i, idx in enumerate(idxs):
            (val if i < n_val else train).append(items[idx])
    return train, val


@DATASET_REGISTRY.register()
class OxfordFlowers(_StandardDataset):
    dataset_dir = "oxford_flowers"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "jpg")
        split_path = os.path.join(self.dataset_dir, "split_zhou_OxfordFlowers.json")

        def fallback():
            return self._read_mat(cfg)

        return _json_split_or(fallback, split_path, self.image_dir)

    def _read_mat(self, cfg):
        """imagelabels.mat + cat_to_name.json (oxford_flowers.py read_data)."""
        from collections import defaultdict

        from scipy.io import loadmat

        from ...utils import read_json

        label_file = os.path.join(self.dataset_dir, "imagelabels.mat")
        lab2cname = read_json(os.path.join(self.dataset_dir, "cat_to_name.json"))
        labels = loadmat(label_file)["labels"][0]
        rng = random.Random(cfg.SEED)

        tracker = defaultdict(list)
        for i, label in enumerate(labels, start=1):
            imname = f"image_{str(i).zfill(5)}.jpg"
            tracker[int(label)].append(os.path.join(self.image_dir, imname))

        train, val, test = [], [], []
        for label, impaths in tracker.items():
            rng.shuffle(impaths)
            n_total = len(impaths)
            n_train = round(n_total * 0.5)
            n_val = round(n_total * 0.2)
            cname = lab2cname[str(label)]
            for i, imp in enumerate(impaths):
                item = Datum(impath=imp, label=label - 1, classname=cname)
                if i < n_train:
                    train.append(item)
                elif i < n_train + n_val:
                    val.append(item)
                else:
                    test.append(item)
        return train, val, test


@DATASET_REGISTRY.register()
class FGVCAircraft(_StandardDataset):
    dataset_dir = "fgvc_aircraft"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "images")
        with open(os.path.join(self.dataset_dir, "variants.txt")) as f:
            classnames = [line.strip() for line in f]
        cname2lab = {c: i for i, c in enumerate(classnames)}
        # full-class-name map consumed by the CLI's base/new report
        # (fork extension, fgvc_aircraft.py:33)
        self.lab2cname_full = dict(enumerate(classnames))
        return (
            self._read(cname2lab, "images_variant_train.txt"),
            self._read(cname2lab, "images_variant_val.txt"),
            self._read(cname2lab, "images_variant_test.txt"),
        )

    def _read(self, cname2lab, split_file):
        items = []
        with open(os.path.join(self.dataset_dir, split_file)) as f:
            for line in f:
                line = line.strip().split(" ")
                imname = line[0] + ".jpg"
                classname = " ".join(line[1:])
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, imname),
                        label=cname2lab[classname],
                        classname=classname,
                    )
                )
        return items


@DATASET_REGISTRY.register()
class DescribableTextures(_StandardDataset):
    dataset_dir = "dtd"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "images")
        split_path = os.path.join(
            self.dataset_dir, "split_zhou_DescribableTextures.json"
        )
        return _json_split_or(
            lambda: read_and_split_data(self.image_dir, rng=random.Random(cfg.SEED)),
            split_path,
            self.image_dir,
        )


EUROSAT_NEW_CNAMES = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}


@DATASET_REGISTRY.register()
class EuroSAT(_StandardDataset):
    dataset_dir = "eurosat"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "2750")
        split_path = os.path.join(self.dataset_dir, "split_zhou_EuroSAT.json")
        return _json_split_or(
            lambda: read_and_split_data(
                self.image_dir, new_cnames=EUROSAT_NEW_CNAMES, rng=random.Random(cfg.SEED)
            ),
            split_path,
            self.image_dir,
        )


@DATASET_REGISTRY.register()
class StanfordCars(_StandardDataset):
    dataset_dir = "stanford_cars"

    def load_splits(self, cfg):
        split_path = os.path.join(self.dataset_dir, "split_zhou_StanfordCars.json")

        def fallback():
            trainval = self._read_mat(
                "cars_train", "devkit/cars_train_annos.mat", "devkit/cars_meta.mat"
            )
            test = self._read_mat(
                "cars_test", "cars_test_annos_withlabels.mat", "devkit/cars_meta.mat"
            )
            train, val = _split_trainval(trainval, rng=random.Random(cfg.SEED))
            return train, val, test

        return _json_split_or(fallback, split_path, self.dataset_dir)

    def _read_mat(self, image_dir, anno_file, meta_file):
        from scipy.io import loadmat

        anno = loadmat(os.path.join(self.dataset_dir, anno_file))["annotations"][0]
        meta = loadmat(os.path.join(self.dataset_dir, meta_file))["class_names"][0]
        items = []
        for entry in anno:
            imname = entry[-1][0]
            label = int(entry[-2][0, 0]) - 1
            names = meta[label][0].split(" ")
            year = names.pop(-1)
            classname = year + " " + " ".join(names)
            items.append(
                Datum(
                    impath=os.path.join(self.dataset_dir, image_dir, imname),
                    label=label,
                    classname=classname,
                )
            )
        return items


@DATASET_REGISTRY.register()
class Food101(_StandardDataset):
    dataset_dir = "food-101"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "images")
        split_path = os.path.join(self.dataset_dir, "split_zhou_Food101.json")
        return _json_split_or(
            lambda: read_and_split_data(self.image_dir, rng=random.Random(cfg.SEED)),
            split_path,
            self.image_dir,
        )


@DATASET_REGISTRY.register()
class SUN397(_StandardDataset):
    dataset_dir = "sun397"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "SUN397")
        split_path = os.path.join(self.dataset_dir, "split_zhou_SUN397.json")

        def fallback():
            # ClassName.txt lives next to the SUN397/ image folder: the
            # documented layout extracts Partitions.zip under sun397/
            # (sun397.py:30, docs/DATASETS.md SUN397 section)
            cname2lab = {}
            with open(os.path.join(self.dataset_dir, "ClassName.txt")) as f:
                for i, line in enumerate(f):
                    cname2lab[line.strip()[1:]] = i  # strip leading "/"
            trainval = self._read(cname2lab, "Training_01.txt")
            test = self._read(cname2lab, "Testing_01.txt")
            train, val = _split_trainval(trainval, rng=random.Random(cfg.SEED))
            return train, val, test

        return _json_split_or(fallback, split_path, self.image_dir)

    def _read(self, cname2lab, text_file):
        items = []
        with open(os.path.join(self.dataset_dir, text_file)) as f:
            for line in f:
                imname = line.strip()[1:]
                classname = os.path.dirname(imname)
                label = cname2lab[classname]
                names = classname.split("/")[1:]  # drop the first-letter bucket
                classname = " ".join(reversed(names))
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items


CALTECH_IGNORED = ["BACKGROUND_Google", "Faces_easy"]
CALTECH_NEW_CNAMES = {
    "airplanes": "airplane",
    "Faces": "face",
    "Leopards": "leopard",
    "Motorbikes": "motorbike",
}


@DATASET_REGISTRY.register()
class Caltech101(_StandardDataset):
    dataset_dir = "caltech-101"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "101_ObjectCategories")
        split_path = os.path.join(self.dataset_dir, "split_zhou_Caltech101.json")
        return _json_split_or(
            lambda: read_and_split_data(
                self.image_dir,
                ignored=CALTECH_IGNORED,
                new_cnames=CALTECH_NEW_CNAMES,
                rng=random.Random(cfg.SEED),
            ),
            split_path,
            self.image_dir,
        )


@DATASET_REGISTRY.register()
class UCF101(_StandardDataset):
    dataset_dir = "ucf101"

    def load_splits(self, cfg):
        self.image_dir = os.path.join(self.dataset_dir, "UCF-101-midframes")
        split_path = os.path.join(self.dataset_dir, "split_zhou_UCF101.json")

        def fallback():
            cname2lab = {}
            with open(
                os.path.join(self.dataset_dir, "ucfTrainTestlist/classInd.txt")
            ) as f:
                for line in f:
                    label, classname = line.strip().split(" ")
                    cname2lab[classname] = int(label) - 1
            trainval = self._read(cname2lab, "ucfTrainTestlist/trainlist01.txt")
            test = self._read(cname2lab, "ucfTrainTestlist/testlist01.txt")
            train, val = _split_trainval(trainval, rng=random.Random(cfg.SEED))
            return train, val, test

        return _json_split_or(fallback, split_path, self.image_dir)

    def _read(self, cname2lab, text_file):
        import re

        items = []
        with open(os.path.join(self.dataset_dir, text_file)) as f:
            for line in f:
                line = line.strip().split(" ")[0]  # trainlist: filename label
                action, filename = line.split("/")
                label = cname2lab[action]
                elements = re.findall("[A-Z][^A-Z]*", action)
                renamed_action = "_".join(elements)
                filename = filename.replace(".avi", ".jpg")
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, renamed_action, filename),
                        label=label,
                        classname=renamed_action,
                    )
                )
        return items


@DATASET_REGISTRY.register()
class ImageNet(DatasetBase):
    """ImageNet-1k; the val directory serves as test (imagenet.py:16-117)."""

    dataset_dir = "imagenet"

    def __init__(self, cfg):
        import pickle

        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        preprocessed = os.path.join(self.dataset_dir, "preprocessed.pkl")

        if os.path.exists(preprocessed):
            with open(preprocessed, "rb") as f:
                data = _FewshotUnpickler(f).load()
            train, test = data["train"], data["test"]
        else:
            classnames = self.read_classnames(
                os.path.join(self.dataset_dir, "classnames.txt")
            )
            train = self.read_data(classnames, "train")
            test = self.read_data(classnames, "val")
            with open(preprocessed, "wb") as f:
                pickle.dump({"train": train, "test": test}, f, protocol=pickle.HIGHEST_PROTOCOL)

        train, test = apply_fewshot_pipeline(
            cfg, self.dataset_dir, train, test, val_key="test"
        )
        train, test = subsample_classes(
            train, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=test, test=test)

    @staticmethod
    def read_classnames(text_file):
        classnames = OrderedDict()
        with open(text_file) as f:
            for line in f:
                parts = line.strip().split(" ")
                classnames[parts[0]] = " ".join(parts[1:])
        return classnames

    def read_data(self, classnames, split_dir):
        split_dir = os.path.join(self.image_dir, split_dir)
        folders = sorted(f.name for f in os.scandir(split_dir) if f.is_dir())
        items = []
        for label, folder in enumerate(folders):
            classname = classnames[folder]
            for imname in listdir_nohidden(os.path.join(split_dir, folder)):
                items.append(
                    Datum(
                        impath=os.path.join(split_dir, folder, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items


class _ImageNetShift(DatasetBase):
    """Eval-only ImageNet distribution shift variants (imagenetv2.py etc)."""

    dataset_dir = ""
    image_subdir = ""
    ignored = ("README.txt",)

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, self.image_subdir)
        classnames = ImageNet.read_classnames(
            os.path.join(self.dataset_dir, "classnames.txt")
        )
        data = self.read_data(classnames)
        super().__init__(train_x=data, test=data)

    def read_data(self, classnames):
        folders = [
            f for f in listdir_nohidden(self.image_dir, sort=True) if f not in self.ignored
        ]
        items = []
        for label, folder in enumerate(folders):
            classname = classnames[folder]
            for imname in listdir_nohidden(os.path.join(self.image_dir, folder)):
                items.append(
                    Datum(
                        impath=os.path.join(self.image_dir, folder, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items


@DATASET_REGISTRY.register()
class ImageNetV2(_ImageNetShift):
    dataset_dir = "imagenetv2"
    image_subdir = "imagenetv2-matched-frequency-format-val"

    def read_data(self, classnames):
        # folders here are the numeric labels 0..999 (imagenetv2.py:22-40)
        folders = list(classnames.keys())
        items = []
        for label in range(1000):
            class_dir = os.path.join(self.image_dir, str(label))
            classname = classnames[folders[label]]
            for imname in listdir_nohidden(class_dir):
                items.append(
                    Datum(
                        impath=os.path.join(class_dir, imname),
                        label=label,
                        classname=classname,
                    )
                )
        return items


@DATASET_REGISTRY.register()
class ImageNetSketch(_ImageNetShift):
    dataset_dir = "imagenet-sketch"
    image_subdir = "images"


@DATASET_REGISTRY.register()
class ImageNetA(_ImageNetShift):
    dataset_dir = "imagenet-adversarial"
    image_subdir = "imagenet-a"


@DATASET_REGISTRY.register()
class ImageNetR(_ImageNetShift):
    dataset_dir = "imagenet-rendition"
    image_subdir = "imagenet-r"
