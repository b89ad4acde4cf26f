"""The port's recognition datasets and loaders against the JAX package's, on
the CPU.

- Each of the 15 plugins (11 recognition datasets, ImageNet's 4 shifts)
  built by both packages on identical fake trees that mirror
  tests/test_dataset_plugins.py's (split_zhou json files, StanfordCars,
  FGVCAircraft, ImageNet and its shifts, SUN397's partition fallback, the
  folder-split fallback, OxfordPets' and UCF101's annotation fallbacks):
  the same (impath, label, classname, domain) lists for train_x, val and
  test under NUM_SHOTS, PER_CLASS_SHOTS and SUBSAMPLE_CLASSES base/new.
  The split json, few-shot pickles and ImageNet's preprocessed.pkl that one
  package writes are read by the other.
- The loaders on a JPEG tree: RawDatasetWrapper's uint8 items byte for
  byte (the CMYK file takes the JAX package's PIL branch), the eval view
  before normalizing, and the DataManager's batches.
"""

import io
import json
import os
import pickle
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image
from scipy.io import savemat

from fsvlm_tpu import native as jax_native
from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.data import build_dataset as jax_build_dataset
from fsvlm_tpu.data import loader as jax_loader
from fsvlm_tpu.data.base_dataset import Datum as JaxDatum
from fsvlm_tpu.data.data_manager import DataManager as JaxDataManager
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.data import build_dataset, loader
from fsvlm_tpu_torch.data.base_dataset import Datum
from fsvlm_tpu_torch.data.data_manager import DataManager

CLASSES = ["alpha", "beta", "gamma", "delta"]
WNIDS = ["n01440764", "n01443537", "n01484850"]
WNID_NAMES = ["tench", "goldfish", "great white shark"]


def _jpeg_bytes(seed=0, size=(12, 10), mode="RGB", **opts):
    rng = np.random.RandomState(seed)
    c = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    arr = rng.randint(0, 256, (size[1], size[0], c)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(buf, "JPEG", **opts)
    return buf.getvalue()


BLOB = _jpeg_bytes()


def _img(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(BLOB)


# -------------------------------------------------------------------- trees
def _split_json(ds_dir, name, image_dir, per_split=(5, 3, 2)):
    split = {"train": [], "val": [], "test": []}
    for label, cname in enumerate(CLASSES):
        for split_name, count in zip(("train", "val", "test"), per_split):
            for j in range(count):
                rel = f"{cname}/{split_name}_{j}.jpg"
                _img(os.path.join(ds_dir, image_dir, rel))
                split[split_name].append([rel, label, cname])
    with open(os.path.join(ds_dir, f"split_zhou_{name}.json"), "w") as f:
        json.dump(split, f)


JSON_PLUGINS = {
    "OxfordPets": ("oxford_pets", "images"),
    "OxfordFlowers": ("oxford_flowers", "jpg"),
    "DescribableTextures": ("dtd", "images"),
    "EuroSAT": ("eurosat", "2750"),
    "Food101": ("food-101", "images"),
    "SUN397": ("sun397", "SUN397"),
    "Caltech101": ("caltech-101", "101_ObjectCategories"),
    "UCF101": ("ucf101", "UCF-101-midframes"),
    "StanfordCars": ("stanford_cars", ""),  # paths relative to the dataset dir
}


def _fgvc(root):
    d = os.path.join(root, "fgvc_aircraft")
    os.makedirs(os.path.join(d, "images"))
    variants = ["707-320", "A340-300", "DR-400", "Falcon 2000"]
    with open(os.path.join(d, "variants.txt"), "w") as f:
        f.write("\n".join(variants) + "\n")
    for split, count in (("train", 4), ("val", 2), ("test", 3)):
        lines = []
        for label, v in enumerate(variants):
            for j in range(count):
                imid = f"{split}{label}{j}"
                _img(os.path.join(d, "images", f"{imid}.jpg"))
                lines.append(f"{imid} {v}")
        with open(os.path.join(d, f"images_variant_{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _classnames(d, wnids=WNIDS, names=WNID_NAMES):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "classnames.txt"), "w") as f:
        for w, c in zip(wnids, names):
            f.write(f"{w} {c}\n")


def _imagenet(root):
    d = os.path.join(root, "imagenet")
    _classnames(d)
    for split, n in (("train", 5), ("val", 3)):
        for w in WNIDS:
            for j in range(n):
                _img(os.path.join(d, "images", split, w, f"{w}_{j}.JPEG"))


def _shift(folder, subdir):
    def make(root):
        d = os.path.join(root, folder)
        _classnames(d)
        for w in WNIDS:
            for j in range(2):
                _img(os.path.join(d, subdir, w, f"img{j}.jpg"))
        with open(os.path.join(d, subdir, "README.txt"), "w") as f:
            f.write("ignored\n")
    return make


def _imagenetv2(root):
    d = os.path.join(root, "imagenetv2")
    wnids = [f"n{i:08d}" for i in range(1000)]
    _classnames(d, wnids, [f"class {i}" for i in range(1000)])
    first = None
    for label in range(1000):
        path = os.path.join(d, "imagenetv2-matched-frequency-format-val", str(label), "a.jpeg")
        os.makedirs(os.path.dirname(path))
        if first is None:
            _img(path)
            first = path
        else:
            os.link(first, path)


def _sun397_partitions(root):
    d = os.path.join(root, "sun397")
    classes = ["/a/abbey", "/b/bar", "/b/bedroom", "/c/castle", "/c/church/outdoor"]
    os.makedirs(os.path.join(d, "SUN397"))
    with open(os.path.join(d, "ClassName.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")
    train, test = [], []
    for cname in classes:
        for j in range(10):
            rel = f"{cname}/sun_{j:06d}.jpg"
            _img(os.path.join(d, "SUN397", rel[1:]))
            (train if j < 5 else test).append(rel)
    for name, lines in (("Training_01.txt", train), ("Testing_01.txt", test)):
        with open(os.path.join(d, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def _folder_split(folder, image_dir, classes):
    def make(root):
        for cname in classes:
            for j in range(10):
                _img(os.path.join(root, folder, image_dir, cname, f"{j}.jpg"))
    return make


def _pets_annotations(root):
    d = os.path.join(root, "oxford_pets")
    breeds = ["Abyssinian", "american_bulldog", "basset_hound"]
    for split, n in (("trainval", 8), ("test", 3)):
        lines = []
        for label, breed in enumerate(breeds, start=1):
            for j in range(n):
                imname = f"{breed}_{split}{j}"
                _img(os.path.join(d, "images", imname + ".jpg"))
                lines.append(f"{imname} {label} 1 {j}")
        os.makedirs(os.path.join(d, "annotations"), exist_ok=True)
        with open(os.path.join(d, "annotations", f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _ucf_lists(root):
    d = os.path.join(root, "ucf101")
    actions = ["ApplyEyeMakeup", "BandMarching", "JumpRope"]
    lists = os.path.join(d, "ucfTrainTestlist")
    os.makedirs(lists)
    with open(os.path.join(lists, "classInd.txt"), "w") as f:
        f.write("".join(f"{i + 1} {a}\n" for i, a in enumerate(actions)))
    for name, n in (("trainlist01.txt", 6), ("testlist01.txt", 3)):
        lines = []
        for i, a in enumerate(actions):
            renamed = "_".join(re.findall("[A-Z][^A-Z]*", a))
            for j in range(n):
                fname = f"v_{a}_{name[:4]}{j}.avi"
                _img(os.path.join(d, "UCF-101-midframes", renamed, fname.replace(".avi", ".jpg")))
                lines.append(f"{a}/{fname} {i + 1}" if name.startswith("train") else f"{a}/{fname}")
        with open(os.path.join(lists, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def _flowers_mat(root):
    d = os.path.join(root, "oxford_flowers")
    labels = np.repeat(np.arange(1, 4), 10)
    os.makedirs(d)
    savemat(os.path.join(d, "imagelabels.mat"), {"labels": labels[None, :]})
    with open(os.path.join(d, "cat_to_name.json"), "w") as f:
        json.dump({"1": "pink primrose", "2": "globe thistle", "3": "blanket flower"}, f)
    for i in range(1, len(labels) + 1):
        _img(os.path.join(d, "jpg", f"image_{i:05d}.jpg"))


TREES = {name: (lambda folder, image_dir, n=name: lambda root: _split_json(
    os.path.join(root, folder), n, image_dir))(*spec) for name, spec in JSON_PLUGINS.items()}
TREES.update({
    "FGVCAircraft": _fgvc,
    "ImageNet": _imagenet,
    "ImageNetSketch": _shift("imagenet-sketch", "images"),
    "ImageNetA": _shift("imagenet-adversarial", "imagenet-a"),
    "ImageNetR": _shift("imagenet-rendition", "imagenet-r"),
    "ImageNetV2": _imagenetv2,
    "SUN397/partitions": _sun397_partitions,
    "DescribableTextures/folders": _folder_split("dtd", "images", CLASSES),
    "Caltech101/folders": _folder_split(
        "caltech-101", "101_ObjectCategories",
        ["BACKGROUND_Google", "Faces", "Faces_easy", "airplanes", "ant", "Leopards"]),
    "EuroSAT/folders": _folder_split("eurosat", "2750", ["AnnualCrop", "Forest", "River"]),
    "OxfordPets/annotations": _pets_annotations,
    "UCF101/lists": _ucf_lists,
    "OxfordFlowers/mat": _flowers_mat,
})
SHIFTS = ("ImageNetSketch", "ImageNetA", "ImageNetR", "ImageNetV2")
SETTINGS = {
    "all": {},
    "shots2": {"NUM_SHOTS": 2},
    "per_class": {"NUM_SHOTS": -1, "PER_CLASS_SHOTS": [3, 1, 2, 1, 2]},
    "base": {"NUM_SHOTS": 1, "SUBSAMPLE_CLASSES": "base"},
    "new": {"SUBSAMPLE_CLASSES": "new"},
}


def _cfgs(root, name, seed=1, **dataset):
    out = []
    for cfg in (jax_get_cfg_default(), get_cfg_base()):
        cfg.SEED = seed
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.NAME = name
        for k, v in dataset.items():
            setattr(cfg.DATASET, k, v)
        out.append(cfg)
    return out


def _lists(ds, root):
    def rows(split):
        return [(os.path.relpath(d.impath, root), d.label, d.classname, d.domain)
                for d in (split or [])]
    return {"train_x": rows(ds.train_x), "val": rows(ds.val), "test": rows(ds.test),
            "lab2cname": ds.lab2cname, "num_classes": ds.num_classes}


def _written(root, before=()):
    """The split, few-shot and preprocessed files under ``root`` that are not
    in ``before``: {relpath: bytes}."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), root)
            if f.endswith((".json", ".pkl")) and rel not in before:
                with open(os.path.join(d, f), "rb") as fh:
                    out[rel] = fh.read()
    return out


def _swap(root, remove, restore=None):
    for rel in remove:
        os.remove(os.path.join(root, rel))
    for rel, data in (restore or {}).items():
        with open(os.path.join(root, rel), "wb") as f:
            f.write(data)


# the ImageNet shifts are eval-only (no few-shot or subsampling step): "all"
PLUGIN_CASES = [(tree, setting) for tree in sorted(TREES) for setting in sorted(SETTINGS)
                if tree not in SHIFTS or setting == "all"]


@pytest.mark.parametrize("tree,setting", PLUGIN_CASES)
def test_plugin_matches_jax(tmp_path, tree, setting):
    """Both packages on one tree (a directory lists in one order, and the
    folder-split fallbacks shuffle that order), each from no written file:
    the same lists and the same files (the split json byte for byte); then
    each package reads the files the other wrote."""
    name = tree.split("/")[0]
    TREES[tree](str(tmp_path))
    tree_files = _written(tmp_path)
    jcfg, pcfg = _cfgs(tmp_path, name, **SETTINGS[setting])
    want = _lists(jax_build_dataset(jcfg), tmp_path)
    jax_files = _written(tmp_path, tree_files)
    _swap(tmp_path, jax_files)
    got = _lists(build_dataset(pcfg), tmp_path)
    port_files = _written(tmp_path, tree_files)
    assert got == want
    assert want["train_x"] and want["test"]
    assert sorted(port_files) == sorted(jax_files)
    assert {k: v for k, v in port_files.items() if k.endswith(".json")} == {
        k: v for k, v in jax_files.items() if k.endswith(".json")}
    _swap(tmp_path, port_files, jax_files)
    cross = build_dataset(pcfg)
    assert _lists(cross, tmp_path) == want
    assert all(type(d) is Datum for d in cross.train_x + cross.test)
    _swap(tmp_path, jax_files, port_files)
    assert _lists(jax_build_dataset(jcfg), tmp_path) == want


def test_fgvc_aircraft_keeps_its_full_class_names(tmp_path):
    _fgvc(str(tmp_path))
    jcfg, pcfg = _cfgs(tmp_path, "FGVCAircraft", SUBSAMPLE_CLASSES="new")
    assert build_dataset(pcfg).lab2cname_full == jax_build_dataset(jcfg).lab2cname_full


def test_imagenet_preprocessed_pickles_cross_read(tmp_path):
    """A preprocessed.pkl written by the JAX package is read by the port (as
    the port's Datum, importing nothing of it) and the port's by the JAX
    package."""
    _imagenet(str(tmp_path))
    jcfg, pcfg = _cfgs(tmp_path, "ImageNet")
    want = _lists(jax_build_dataset(jcfg), tmp_path)
    pkl = tmp_path / "imagenet" / "preprocessed.pkl"
    with open(pkl, "rb") as f:
        assert type(pickle.load(f)["train"][0]) is JaxDatum
    got = build_dataset(pcfg)
    assert _lists(got, tmp_path) == want and type(got.train_x[0]) is Datum
    os.remove(pkl)
    build_dataset(pcfg)  # the port writes it
    with open(pkl, "rb") as f:
        assert type(pickle.load(f)["train"][0]) is Datum
    assert _lists(jax_build_dataset(jcfg), tmp_path) == want


def test_unported_legacy_sets_name_a13(tmp_path):
    """No legacy set is left unported: all 21 are registered, and an
    unknown name's KeyError lists them without naming ROADMAP A13."""
    from fsvlm_tpu.data.data_manager import DATASET_REGISTRY as JAX_REGISTRY
    from fsvlm_tpu_torch.data.data_manager import DATASET_REGISTRY

    legacy = {n for n in JAX_REGISTRY.registered_names()
              if JAX_REGISTRY.get(n).__module__.endswith(".legacy")}
    assert len(legacy) == 21 and legacy <= set(DATASET_REGISTRY.registered_names())
    _, pcfg = _cfgs(tmp_path, "PACS2")
    with pytest.raises(KeyError, match="not registered") as err:
        build_dataset(pcfg)
    assert "A13" not in str(err.value) and all(n in str(err.value) for n in legacy)


# ----------------------------------------------------------- JPEG loaders
JPEG_KINDS = [  # (mode, save options, size)
    ("RGB", dict(quality=90, subsampling=2), (61, 47)),
    ("RGB", dict(quality=85, subsampling=0, progressive=True), (40, 52)),
    ("L", dict(quality=80), (50, 33)),
    ("RGB", dict(quality=75, subsampling=1, restart_marker_blocks=1), (77, 59)),
    ("CMYK", dict(quality=85), (45, 38)),
]


def _jpeg_tree(root, n_classes=6, per_class=10):
    """A Caltech101-layout tree of real JPEGs (every kind in each class)."""
    image_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    for c in range(n_classes):
        for j in range(per_class):
            mode, opts, size = JPEG_KINDS[(c + j) % len(JPEG_KINDS)]
            path = os.path.join(image_dir, f"class_{c:02d}", f"image_{j:04d}.jpg")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(_jpeg_bytes(seed=c * 100 + j, size=size, mode=mode, **opts))


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    # the JAX package loads its native decoder on first use without a lock
    # (fsvlm_tpu/native.py:_load sets _TRIED before _LIB), so threads that
    # race the first load take its PIL branch: load it before any pool runs
    jax_native.native_available()
    root = tmp_path_factory.mktemp("caltech")
    _jpeg_tree(str(root))
    return root


@pytest.mark.parametrize("pre_size", [32, 64])
def test_raw_wrapper_items_match_jax(jpeg_root, pre_size):
    items = sorted(str(p) for p in jpeg_root.rglob("*.jpg"))
    want = jax_loader.RawDatasetWrapper([JaxDatum(impath=p) for p in items],
                                        pre_size=pre_size).materialize(num_threads=4)
    got = loader.RawDatasetWrapper([Datum(impath=p) for p in items],
                                   pre_size=pre_size).materialize(num_threads=4)
    assert got.shape == (len(items), pre_size, pre_size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _dm_cfgs(root, **kw):
    jcfg, pcfg = _cfgs(root, "Caltech101", NUM_SHOTS=-1, PER_CLASS_SHOTS=[5, 5, 4, 3, 2, 1])
    for cfg in (jcfg, pcfg):
        cfg.VERBOSE = True
        cfg.DATALOADER.DEVICE_AUG = True
        cfg.DATALOADER.NUM_WORKERS = 2
        cfg.DATALOADER.TRAIN_X.SAMPLER = "WeightedClassSampler"
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
        cfg.DATALOADER.TEST.BATCH_SIZE = 7
        cfg.DATALOADER.PRE_SIZE = 48
        cfg.INPUT.SIZE = (32, 32)
        cfg.INPUT.INTERPOLATION = "bicubic"
        cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
        cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
        cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
        for k, v in kw.items():
            setattr(cfg.DATALOADER, k, v)
    return jcfg, pcfg


def test_data_manager_on_a_jpeg_tree_matches_jax(tmp_path, jpeg_root, capsys):
    """The Caltech101 plugin on real JPEGs (the folder-split fallback, each
    package from no written file): the summary, the train loader's index
    batches and its device-aug cache, the val and test loaders' eval views
    (uint8 here, JAX's normalized floats there: equal once normalized) batch
    for batch."""
    root = tmp_path / "tree"
    shutil.copytree(jpeg_root, root)
    jcfg, pcfg = _dm_cfgs(root)
    capsys.readouterr()
    jdm = JaxDataManager(jcfg)
    jax_out = capsys.readouterr().out
    _swap(root, _written(root))
    pdm = DataManager(pcfg)
    port_out = capsys.readouterr().out
    assert port_out == jax_out
    assert "# train_x" in jax_out and pdm.lab2cname == jdm.lab2cname
    for _ in range(2):
        for pb, jb in zip(pdm.train_loader_x.iter_index_batches(),
                          jdm.train_loader_x.iter_index_batches(), strict=True):
            for k in ("index", "label", "domain", "valid"):
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    np.testing.assert_array_equal(pdm.train_loader_x.wrapper.materialize(num_threads=2),
                                  jdm.train_loader_x.wrapper.materialize(num_threads=2))
    mean = np.float32(pcfg.INPUT.PIXEL_MEAN)
    std = np.float32(pcfg.INPUT.PIXEL_STD)
    for pl, jl in ((pdm.val_loader, jdm.val_loader), (pdm.test_loader, jdm.test_loader)):
        n = 0
        for pb, jb in zip(pl, jl, strict=True):
            for k in ("index", "label", "valid"):
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
            assert pb["img"].dtype == np.uint8 and pb["img"].shape == (7, 32, 32, 3)
            norm = (pb["img"] / np.float32(255) - mean) / std
            np.testing.assert_array_equal(norm.astype(np.float32), jb["img"])
            n += int(pb["valid"].sum())
        assert n == len(pl.wrapper)


def test_eval_cache_past_its_budget_stops_caching_and_gives_the_same_items(jpeg_root, capsys,
                                                                          monkeypatch):
    """FSVLM_EVAL_CACHE_MB as the JAX package's: a set past the budget drops
    its cache (with JAX's message) and transforms each item again."""
    from fsvlm_tpu_torch.data.transforms import TestTransform

    _, pcfg = _dm_cfgs(jpeg_root)
    items = [Datum(impath=str(p), label=0) for p in sorted(jpeg_root.rglob("*.jpg"))[:20]]
    tfm = TestTransform(pcfg)
    cached = loader.DatasetWrapper(items, tfm)
    want = [cached[i]["img"] for i in range(len(items))]
    assert cached.cached_bytes == sum(x.nbytes for x in want) and len(cached._cache) == 20
    assert loader.DatasetWrapper(items, tfm)._budget == 4096 << 20
    assert loader.RawDatasetWrapper(items, 32)._budget is None  # the item cap only, as JAX's
    monkeypatch.setenv("FSVLM_EVAL_CACHE_MB", "0")
    tiny = loader.DatasetWrapper(items, tfm)  # 0 MB: the first item crosses it
    capsys.readouterr()
    for _ in range(2):
        for i in range(len(items)):
            np.testing.assert_array_equal(tiny[i]["img"], want[i])
    assert tiny._cache is None and tiny.cached_bytes == 0
    assert capsys.readouterr().out == ("* transformed-tensor cache disabled: exceeds 0 MB "
                                       "(FSVLM_EVAL_CACHE_MB)\n")


def test_eval_cache_budget_holds_under_many_threads(jpeg_root):
    """The budget's byte count is shared by the loader's threads: 32 threads
    on one wrapper, the interpreter switching every microsecond, leave
    cached_bytes equal to the bytes the cache holds, within the budget or
    with the cache dropped, and every item as the serial transform gives it."""
    from fsvlm_tpu_torch.data.transforms import TestTransform

    _, pcfg = _dm_cfgs(jpeg_root)
    items = [Datum(impath=str(p), label=0) for p in sorted(jpeg_root.rglob("*.jpg"))]
    tfm = TestTransform(pcfg)
    want = [tfm(loader.decode(d.impath)) for d in items]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for crossed, n_items in ((True, 40), (False, len(items))):
            w = loader.DatasetWrapper(items[:n_items], tfm)
            if crossed:
                w._budget = 20 * want[0].nbytes  # past 20 of the 40 items
            with ThreadPoolExecutor(max_workers=32) as pool:
                got = list(pool.map(lambda i: w[i % n_items]["img"], range(4 * n_items)))
            for i, x in enumerate(got):
                np.testing.assert_array_equal(x, want[i % n_items])
            held = sum(x.nbytes for x in (w._cache or {}).values())
            assert w.cached_bytes == held <= w._budget
            assert (w._cache is None) == crossed
    finally:
        sys.setswitchinterval(interval)
