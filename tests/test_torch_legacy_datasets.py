"""The port's Dassl DA/DG/SSL datasets (fsvlm_tpu_torch/data/datasets/legacy.py),
its SyntheticSSL and SyntheticDA, and the DataManager's train_u loader,
against the JAX package's, on the CPU.

- Each layout of tests/test_legacy_datasets.py is built once, and both
  packages read the same tree: train_x, train_u, val and test equal item
  for item (path, label, domain, class name), and ``num_classes`` and
  ``lab2cname``; one parametrised test over the 21 registered names (the
  three WILDS sets raise in both), Digit5 and SSL CIFAR under the same seed
  (Digit5 samples through the global ``random``, seeded identically before
  each build); then the error cases.
- SyntheticSSL and SyntheticDA pixel for pixel.
- Both DataManagers on a small SSL tree and a small DA tree (PNG files):
  the train_u batches (index, label, domain, uint8 images under DEVICE_AUG,
  the host transform's views without it) and ``num_source_domains``.
- The slice as a whole: on a small PACS-layout tree (JPEG source domains,
  the PNG sketch domain as target, the corrupt sketch file listed and
  skipped), PromptSRC at test-tiny from the same seed in both packages:
  the eval batches byte-equal and ``test()``'s logits within rtol 1e-4 /
  atol 1e-5, the tolerance of tests/test_torch_checkpoint.py's test() on
  a JAX checkpoint; the same predictions.
"""

import importlib.util
import os
import random
import shutil

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import fsvlm_tpu.trainers  # noqa: F401  (registers the JAX trainers)
from fsvlm_tpu import native as jax_native
from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.data import loader as jax_loader
from fsvlm_tpu.data.data_manager import DATASET_REGISTRY as JAX_REGISTRY
from fsvlm_tpu.data.data_manager import DataManager as JaxDataManager
from fsvlm_tpu.engine import build_trainer as jax_build_trainer
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.data import loader
from fsvlm_tpu_torch.data.data_manager import DATASET_REGISTRY, DataManager
from fsvlm_tpu_torch.engine.trainer import TRAINER_REGISTRY, build_trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNGS = os.path.join(ROOT, "tests", "torch_fixtures", "png")
JPEGS = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
_spec = importlib.util.spec_from_file_location("png_fixtures",
                                               os.path.join(PNGS, "make_fixtures.py"))
png = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(png)
TINY_PNG = png.encode_png(np.full((8, 8, 3), 128), 2, 8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_native.native_available()  # the JAX decoder loads once, before any pool
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _img(path, data=TINY_PNG):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _lines(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


# ------------------------------------------------------------------ trees
# each: (the function that writes the tree, the DATASET keys); the layouts of
# test_legacy_datasets.py
def _office31(d):
    for dom in ("amazon", "webcam"):
        for cls in ("bike", "mug", "pen"):
            for i in range(3):
                _img(f"{d}/office31/{dom}/{cls}/{i}.jpg")


def _office_home(d):
    for dom in ("art", "product", "clipart"):
        for cls in ("Chair", "Desk"):
            for i in range(2):
                _img(f"{d}/office_home/{dom}/{cls}/{i}.jpg")


def _digit5(d):
    for dom in ("mnist", "usps", "svhn"):
        for split in ("train_images", "test_images"):
            for i in range(7):
                _img(f"{d}/digit5/{dom}/{split}/img{i}_{i % 3}.png")


def _visda17(d):
    for filedir, n in (("train", 5), ("validation", 4)):
        lines = []
        for i in range(n):
            rel = f"cls{i % 2}/im{i}.jpg"
            _img(f"{d}/visda17/{filedir}/{rel}")
            lines.append(f"{rel} {i % 2}")
        _lines(f"{d}/visda17/{filedir}/image_list.txt", lines + [""])


def _domainnet(d):
    for split_dir in ("splits", "splits_mini"):
        for dom in ("clipart", "real", "sketch"):
            for split in ("train", "test"):
                lines = []
                for i in range(3):
                    rel = f"{dom}/{('dog', 'cat')[i % 2]}/{split}{i}.jpg"
                    _img(f"{d}/domainnet/{rel}")
                    lines.append(f"{rel} {i % 2}")
                _lines(f"{d}/domainnet/{split_dir}/{dom}_{split}.txt", lines)


def _cifarstl(d):
    for dom in ("cifar", "stl"):
        for split in ("train", "test"):
            for cls in ("0_airplane", "1_bird", "2_car"):
                for i in range(2):
                    _img(f"{d}/cifar_stl/{dom}/{split}/{cls}/{i}.png")


def _pacs(d):
    err = "sketch/dog/n02103406_4068-1.png"
    for dom in ("photo", "sketch", "cartoon"):
        for split in ("train", "crossval"):
            lines = []
            for i, cls in enumerate(("dog", "horse", "dog")):
                rel = f"{dom}/{cls}/im{split}{i}.{'png' if dom == 'sketch' else 'jpg'}"
                _img(f"{d}/pacs/images/{rel}")
                lines.append(f"{rel} {1 + (cls == 'horse')}")  # 1-based labels
            if dom == "sketch" and split == "train":
                _img(f"{d}/pacs/images/{err}")
                lines.append(f"{err} 1")
            _lines(f"{d}/pacs/splits/{dom}_{split}_kfold.txt", lines)


def _vlcs(d):
    for dom in ("CALTECH", "SUN", "PASCAL"):
        for split in ("train", "crossval", "test"):
            for cls in ("bird", "car"):
                _img(f"{d}/VLCS/{dom}/{split}/{cls}/x.jpg")
                _img(f"{d}/VLCS/{dom}/{split}/{cls}/y.png")  # VLCS reads *.jpg only


def _folder_dg(name, domains, classes):
    def build(d):
        for dom in domains:
            for split in ("train", "val"):
                for cls in classes:
                    for i in range(2):
                        _img(f"{d}/{name}/{dom}/{split}/{cls}/x{i}.png")
    return build


def _digit_single(d):
    for dom in ("mnist", "svhn", "usps"):
        for split in ("train_images", "test_images"):
            for i in range(5):
                _img(f"{d}/digit5/{dom}/{split}/im{i}_{i % 2}.png")


def _cifar_c(src, tgt):
    def build(d):
        for cls in ("cat", "dog"):
            for i in range(2):
                _img(f"{d}/{src}/train/{cls}/x{i}.png")
                _img(f"{d}/{tgt}/fog/3/{cls}/x{i}.png")
    return build


def _ssl(name):
    def build(d):
        for cls in ("cat", "dog", "ship"):
            for i in range(10):
                _img(f"{d}/{name}/train/{cls}/{i:02d}.png")
            for i in range(4):
                _img(f"{d}/{name}/test/{cls}/{i}.png")
    return build


def _stl10(d):
    for i in range(6):
        _img(f"{d}/stl10/train/im{i:02d}_{i % 2}.png")
        _img(f"{d}/stl10/test/im{i}_{i % 2}.png")
    for i in range(4):
        _img(f"{d}/stl10/unlabeled/u{i}_none.png")
    _lines(f"{d}/stl10/stl10_binary/fold_indices.txt", ["0 2 4", "1 3 5", ""])


def _nothing(d):
    pass


CASES = {
    "Office31": (_office31, dict(SOURCE_DOMAINS=("amazon",), TARGET_DOMAINS=("webcam",))),
    "OfficeHome": (_office_home, dict(SOURCE_DOMAINS=("art", "clipart"),
                                      TARGET_DOMAINS=("product",))),
    "Digit5": (_digit5, dict(SOURCE_DOMAINS=("usps", "svhn"), TARGET_DOMAINS=("mnist",))),
    "VisDA17": (_visda17, dict(SOURCE_DOMAINS=("synthetic",), TARGET_DOMAINS=("real",))),
    "DomainNet": (_domainnet, dict(SOURCE_DOMAINS=("clipart", "sketch"),
                                   TARGET_DOMAINS=("real",))),
    "miniDomainNet": (_domainnet, dict(SOURCE_DOMAINS=("clipart",), TARGET_DOMAINS=("real",))),
    "CIFARSTL": (_cifarstl, dict(SOURCE_DOMAINS=("cifar",), TARGET_DOMAINS=("stl",))),
    "PACS": (_pacs, dict(SOURCE_DOMAINS=("photo", "cartoon"), TARGET_DOMAINS=("sketch",))),
    "VLCS": (_vlcs, dict(SOURCE_DOMAINS=("caltech", "pascal"), TARGET_DOMAINS=("sun",))),
    "DigitsDG": (_folder_dg("digits_dg", ("mnist", "syn", "svhn"), ("0", "1")),
                 dict(SOURCE_DOMAINS=("mnist", "svhn"), TARGET_DOMAINS=("syn",))),
    "OfficeHomeDG": (_folder_dg("office_home_dg", ("art", "product"), ("Chair", "Desk")),
                     dict(SOURCE_DOMAINS=("art",), TARGET_DOMAINS=("product",))),
    "DigitSingle": (_digit_single, dict(SOURCE_DOMAINS=("mnist",),
                                        TARGET_DOMAINS=("svhn", "usps"))),
    "CIFAR10C": (_cifar_c("cifar10", "cifar10_c"),
                 dict(SOURCE_DOMAINS=("cifar10",), TARGET_DOMAINS=("cifar10_c",),
                      CIFAR_C_TYPE="fog", CIFAR_C_LEVEL=3)),
    "CIFAR100C": (_cifar_c("cifar100", "cifar100_c"),
                  dict(SOURCE_DOMAINS=("cifar100",), TARGET_DOMAINS=("cifar100_c",),
                       CIFAR_C_TYPE="fog", CIFAR_C_LEVEL=3)),
    "CIFAR10": (_ssl("cifar10"), dict(NUM_LABELED=6, VAL_PERCENT=0.2)),
    "CIFAR100": (_ssl("cifar100"), dict(NUM_LABELED=3, VAL_PERCENT=0.1, ALL_AS_UNLABELED=True)),
    "SVHN": (_ssl("svhn"), dict(NUM_LABELED=9, VAL_PERCENT=0.0)),
    "STL10": (_stl10, dict(STL10_FOLD=1, ALL_AS_UNLABELED=True)),
    "Camelyon17": (_nothing, {}),
    "FMoW": (_nothing, {}),
    "IWildCam": (_nothing, {}),
}


def _cfgs(root, name, seed=1, **dataset):
    out = []
    for cfg in (jax_get_cfg_default(), get_cfg_base()):
        cfg.SEED = seed
        cfg.VERBOSE = False
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.NAME = name
        for k, v in dataset.items():
            setattr(cfg.DATASET, k, v)
        out.append(cfg)
    return out


def _rows(ds, root):
    def rows(split):
        if split is None:
            return None
        return [(os.path.relpath(d.impath, root), d.label, d.domain, d.classname) for d in split]
    return {"train_x": rows(ds.train_x), "train_u": rows(ds.train_u), "val": rows(ds.val),
            "test": rows(ds.test), "num_classes": ds.num_classes, "lab2cname": ds.lab2cname}


def _build_both(root, name, **dataset):
    """Both packages' datasets on one tree, the global ``random`` seeded the
    same before each (Digit5 draws its samples from it)."""
    jcfg, pcfg = _cfgs(root, name, **dataset)
    random.seed(5)
    ref = JAX_REGISTRY.get(name)(jcfg)
    random.seed(5)
    got = DATASET_REGISTRY.get(name)(pcfg)
    return ref, got


def test_every_legacy_name_is_a_case():
    legacy = {n for n in JAX_REGISTRY.registered_names()
              if JAX_REGISTRY.get(n).__module__.endswith(".legacy")}
    assert legacy == set(CASES) and len(CASES) == 21


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_dataset_matches_jax(tmp_path, name):
    build, dataset = CASES[name]
    build(str(tmp_path))
    if name in ("Camelyon17", "FMoW", "IWildCam"):
        for registry, cfg in zip((JAX_REGISTRY, DATASET_REGISTRY), _cfgs(tmp_path, name)):
            with pytest.raises(RuntimeError, match="optional 'wilds' package"):
                registry.get(name)(cfg)
        return
    ref, got = _build_both(tmp_path, name, **dataset)
    want = _rows(ref, tmp_path)
    assert _rows(got, tmp_path) == want
    assert want["train_x"] and want["test"]
    if name == "Digit5":  # the same global draws: a 3-class pool sampled in a seeded order
        assert [r[0] for r in want["train_u"]] != sorted(r[0] for r in want["train_u"])
    if name == "PACS":
        assert not any("n02103406_4068-1" in r[0] for r in want["test"])
        assert {r[1] for r in want["train_x"]} == {0, 1}


@pytest.mark.parametrize("seed", [1, 2])
def test_ssl_partition_follows_the_seed_in_both(tmp_path, seed):
    _ssl("cifar10")(str(tmp_path))
    jcfg, pcfg = _cfgs(tmp_path, "CIFAR10", seed=seed, NUM_LABELED=6, VAL_PERCENT=0.2)
    ref = _rows(JAX_REGISTRY.get("CIFAR10")(jcfg), tmp_path)
    assert _rows(DATASET_REGISTRY.get("CIFAR10")(pcfg), tmp_path) == ref
    assert (len(ref["train_x"]), len(ref["train_u"]), len(ref["val"])) == (6, 18, 6)


@pytest.mark.parametrize("case", ["cifar_c_type", "cifar_c_level", "unknown_domain",
                                  "no_source", "unknown_target"])
def test_legacy_errors_match_jax(tmp_path, case):
    if case.startswith("cifar_c"):
        _cifar_c("cifar10", "cifar10_c")(str(tmp_path))
        name, kw = "CIFAR10C", dict(SOURCE_DOMAINS=("cifar10",), TARGET_DOMAINS=("cifar10_c",))
        if case == "cifar_c_level":
            kw.update(CIFAR_C_TYPE="fog", CIFAR_C_LEVEL=7)
        error, match = ((ValueError, "CIFAR_C_TYPE") if case == "cifar_c_type" else
                        (AssertionError, None))
    else:
        _pacs(str(tmp_path))
        name = "PACS"
        kw = {"unknown_domain": dict(SOURCE_DOMAINS=("clipart",), TARGET_DOMAINS=("sketch",)),
              "no_source": dict(TARGET_DOMAINS=("sketch",)),
              "unknown_target": dict(SOURCE_DOMAINS=("photo",), TARGET_DOMAINS=("real",))}[case]
        error, match = ((AssertionError, "source_domains") if case == "no_source" else
                        (ValueError, "Input domain must belong to"))
    for registry, cfg in zip((JAX_REGISTRY, DATASET_REGISTRY), _cfgs(tmp_path, name, **kw)):
        with pytest.raises(error, match=match):
            registry.get(name)(cfg)


# -------------------------------------------------------------- synthetic
@pytest.mark.parametrize("name,dataset", [
    ("SyntheticSSL", {}),
    ("SyntheticSSL", dict(NUM_LABELED=12, ALL_AS_UNLABELED=True)),
    ("SyntheticDA", dict(SOURCE_DOMAINS=("d0", "d2"), TARGET_DOMAINS=("d1",))),
    ("SyntheticDA", {}),
], ids=["ssl", "ssl_all_as_unlabeled", "da", "dg"])
def test_synthetic_fixtures_match_jax_pixel_for_pixel(name, dataset):
    jcfg, pcfg = _cfgs("", name, seed=3, **dataset)
    ref = JAX_REGISTRY.get(name)(jcfg)
    got = DATASET_REGISTRY.get(name)(pcfg)
    assert _rows(got, "") == _rows(ref, "")
    for split in ("train_x", "train_u", "val", "test"):
        for a, b in zip(getattr(got, split) or [], getattr(ref, split) or [], strict=True):
            np.testing.assert_array_equal(loader.decode(a.impath),
                                          np.asarray(jax_loader._decode(b.impath)))


def test_synthetic_da_rejects_an_unknown_domain():
    for registry, cfg in zip((JAX_REGISTRY, DATASET_REGISTRY),
                             _cfgs("", "SyntheticDA", SOURCE_DOMAINS=("d9",))):
        with pytest.raises(ValueError, match="Input domain must belong to"):
            registry.get("SyntheticDA")(cfg)


# ------------------------------------------------------------ train_u
def _png_tree(root, layout):
    """Small trees of real images: SSL CIFAR-10 (32x32 PNGs) or Office31
    (two domains of 227x227 sketch PNGs and 32x32 ones)."""
    rng = np.random.RandomState(4)
    if layout == "ssl":
        for c, cls in enumerate(("cat", "dog", "ship")):
            for i in range(10):
                _img(f"{root}/cifar10/train/{cls}/{i:02d}.png",
                     png.encode_png(rng.randint(0, 256, (32, 32, 3)), 2, 8))
            for i in range(3):
                _img(f"{root}/cifar10/test/{cls}/{i}.png",
                     png.encode_png(rng.randint(0, 256, (32, 32, 3)), 2, 8))
        return
    sketches = sorted(f for f in os.listdir(PNGS) if f.startswith("sketch_"))
    for d, dom in enumerate(("amazon", "webcam")):
        for c, cls in enumerate(("bike", "mug")):
            for i in range(5):
                dst = f"{root}/office31/{dom}/{cls}/{i}.png"
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy(os.path.join(PNGS, sketches[(d + c + i) % len(sketches)]), dst)


def _as_jax(x, cfg):
    """A port batch's images as the JAX package ships them: uint8 normalized
    as the trainer's ``eval_images`` (where the transforms normalize)."""
    if x.dtype != np.uint8:
        return x
    x = x.astype(np.float32) / 255.0
    if "normalize" in cfg.INPUT.TRANSFORMS:
        x = (x - np.float32(cfg.INPUT.PIXEL_MEAN)) / np.float32(cfg.INPUT.PIXEL_STD)
    return x.astype(np.float32)


@pytest.mark.parametrize("device_aug", [True, False], ids=["device_aug", "host"])
@pytest.mark.parametrize("layout,same_as_x", [("ssl", True), ("ssl", False), ("da", True)])
def test_train_u_loader_matches_jax(tmp_path, layout, same_as_x, device_aug):
    _png_tree(str(tmp_path), layout)
    name, kw = (("CIFAR10", dict(NUM_LABELED=6, VAL_PERCENT=0.1)) if layout == "ssl" else
                ("Office31", dict(SOURCE_DOMAINS=("amazon",), TARGET_DOMAINS=("webcam",))))
    jcfg, pcfg = _cfgs(tmp_path, name, **kw)
    for cfg in (jcfg, pcfg):
        cfg.DATALOADER.DEVICE_AUG = device_aug
        cfg.DATALOADER.PRE_SIZE = 40
        cfg.DATALOADER.NUM_WORKERS = 1
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
        cfg.DATALOADER.TRAIN_U.SAME_AS_X = same_as_x
        cfg.DATALOADER.TRAIN_U.BATCH_SIZE = 7
        cfg.INPUT.SIZE = (32, 32)
        cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
        cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    assert pdm.num_source_domains == jdm.num_source_domains == 1
    ju, pu = jdm.train_loader_u, pdm.train_loader_u
    assert len(pu) == len(ju) and pu.batch_size == ju.batch_size == (4 if same_as_x else 7)
    n = 0
    for _ in range(2):
        for pb, jb in zip(pu, ju, strict=True):
            for k in ("index", "label", "domain", "valid"):
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
            items = [pdm.dataset.train_u[i] for i in pb["index"]]
            np.testing.assert_array_equal(pb["label"], [it.label for it in items])
            if device_aug:
                assert pb["img"].dtype == jb["img"].dtype == np.uint8
                np.testing.assert_array_equal(pb["img"], jb["img"])
            else:
                np.testing.assert_allclose(_as_jax(pb["img"], pcfg), jb["img"], rtol=0,
                                           atol=1e-6)
            n += 1
    assert n == 2 * len(pu) > 0


def test_num_source_domains_without_source_domains():
    """No SOURCE_DOMAINS: the largest train_x domain + 1, in both."""
    jcfg, pcfg = _cfgs("", "SyntheticDA", seed=0)
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    assert pdm.num_source_domains == jdm.num_source_domains == 2
    assert pdm.train_loader_u is None and jdm.train_loader_u is None


# ------------------------------------------------------- the slice: PACS
def _pacs_tree(root):
    """PACS's layout with 7 classes: three JPEG source domains (the
    committed JPEG fixtures), the sketch domain of the PNG fixtures, and
    the corrupt sketch file listed in a split file."""
    jpegs = sorted(f for f in os.listdir(JPEGS) if f.endswith(".jpg") and "cmyk" not in f)
    sketches = sorted(f for f in os.listdir(PNGS) if f.startswith("sketch_"))
    classes = ("dog", "elephant", "giraffe", "guitar", "horse", "house", "person")
    k = 0
    for dom, files in (("art_painting", jpegs), ("photo", jpegs), ("sketch", sketches)):
        ext = ".png" if dom == "sketch" else ".jpg"
        for split, n in (("train", 2), ("crossval", 1)):
            lines = []
            for c, cls in enumerate(classes):
                for i in range(n):
                    rel = f"{dom}/{cls}/{split}_{i}{ext}"
                    dst = f"{root}/pacs/images/{rel}"
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copy(os.path.join(JPEGS if ext == ".jpg" else PNGS,
                                             files[k % len(files)]), dst)
                    lines.append(f"{rel} {c + 1}")
                    k += 1
            if dom == "sketch" and split == "train":
                err = "sketch/dog/n02103406_4068-1.png"
                shutil.copy(os.path.join(PNGS, "truncated_n02103406_4068-1.png"),
                            f"{root}/pacs/images/{err}")
                lines.append(f"{err} 1")
            _lines(f"{root}/pacs/splits/{dom}_{split}_kfold.txt", lines)


def test_promptsrc_test_on_a_pacs_tree_matches_jax(tmp_path, monkeypatch):
    _pacs_tree(str(tmp_path))
    jcfg, pcfg = jax_get_cfg_default(), get_cfg_base()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(os.path.join(ROOT, "configs/datasets/zoo/pacs.yaml"))
        cfg.merge_from_file(os.path.join(ROOT, "configs/trainers/tests/synthetic_tiny.yaml"))
        cfg.merge_from_list([
            "TRAINER.NAME", "PromptSRC", "SEED", 1, "VERBOSE", False,
            "DATASET.ROOT", str(tmp_path), "DATASET.SOURCE_DOMAINS", ["art_painting", "photo"],
            "DATASET.TARGET_DOMAINS", ["sketch"], "DATALOADER.NUM_WORKERS", 2,
            "DATALOADER.TEST.BATCH_SIZE", 8, "TRAINER.PROMPTSRC.PREC", "fp32",
            "OUTPUT_DIR", str(tmp_path / "out")])
    jt = jax_build_trainer(jcfg)
    pt = build_trainer(pcfg, device="cpu")
    ds = pt.dm.dataset
    assert (len(ds.train_x), len(ds.val), len(ds.test)) == (28, 14, 21)  # the corrupt file skipped
    assert pt.num_classes == 7 and pt.dm.num_source_domains == 2

    ref_logits, ref_imgs = [], []
    for batch in jt.test_loader:
        imgs = batch["img"]
        ref_imgs.append(np.asarray(imgs)[batch["valid"]])
        txf = jt._text_step(jt.params, jt.frozen)
        ref_logits.append(np.asarray(jt._eval_with_txf(jt.params, jt.frozen, imgs, txf))[
            batch["valid"]])
    got_imgs = [_as_jax(b["img"], pcfg)[b["valid"]] for b in pt.test_loader]
    for a, b in zip(got_imgs, ref_imgs, strict=True):
        np.testing.assert_array_equal(a, b)  # the eval views, byte for byte
    ref_true, ref_pred = jt.test(return_pred=True)

    logits = []
    target = TRAINER_REGISTRY.get("PromptSRC")
    inner = target.image_logits_fn
    monkeypatch.setattr(target, "image_logits_fn",
                        lambda self, *a: logits.append(inner(self, *a)) or logits[-1])
    y_true, y_pred = pt.test(return_pred=True)
    got = np.concatenate([lg.numpy()[:len(r)] for lg, r in zip(logits, ref_logits, strict=True)])
    np.testing.assert_allclose(got, np.concatenate(ref_logits), rtol=1e-4, atol=1e-5)
    assert list(y_true) == list(ref_true) and list(y_pred) == list(ref_pred)
