"""The port's data layer against the JAX package's, on the CPU.

- ``data.imageops.resize`` against Pillow, byte for byte (bilinear, bicubic
  and nearest, up and down by integer and non-integer factors, Synthetic's
  64 -> 256 pre-size and 64 -> 224 eval view);
- the eval view (``TestTransform``) and the device-aug cache
  (``RawDatasetWrapper.materialize``) against the JAX package's PIL arrays
  before normalization, byte for byte;
- ``Synthetic``'s splits, images and lab2cname under PER_CLASS_SHOTS and
  SUBSAMPLE_CLASSES; each sampler's first epochs, the train loader's index
  batches and the eval loaders' padded batches; ``apply_fewshot_pipeline``
  and its cache files; the DataManager's summary.  All identical.
"""

import os

import numpy as np
import pytest
from PIL import Image

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.data import base_dataset as jax_base
from fsvlm_tpu.data import loader as jax_loader
from fsvlm_tpu.data import samplers as jax_samplers
from fsvlm_tpu.data import transforms as jax_transforms
from fsvlm_tpu.data.data_manager import DataManager as JaxDataManager
from fsvlm_tpu.data.datasets.synthetic import Synthetic as JaxSynthetic
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.data import base_dataset, imageops, loader, samplers, transforms
from fsvlm_tpu_torch.data.data_manager import DataManager
from fsvlm_tpu_torch.data.datasets.synthetic import Synthetic

PER_CLASS = [16, 16, 16, 8, 8, 4, 2, 1]


def _set(cfg, **kw):
    """cfg.A.B = v for each A__B=v (the yacs tree and the dataclasses)."""
    for path, value in kw.items():
        *parents, leaf = path.split("__")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    return cfg


def _cfgs(**kw):
    base = dict(SEED=1, VERBOSE=False, DATASET__NAME="Synthetic", DATALOADER__DEVICE_AUG=True,
                DATALOADER__NUM_WORKERS=2, INPUT__INTERPOLATION="bicubic", INPUT__SIZE=(32, 32),
                INPUT__TRANSFORMS=("random_resized_crop", "random_flip", "normalize"),
                INPUT__PIXEL_MEAN=[0.48145466, 0.4578275, 0.40821073],
                INPUT__PIXEL_STD=[0.26862954, 0.26130258, 0.27577711])
    base.update(kw)
    return _set(jax_get_cfg_default(), **base), _set(get_cfg_base(), **base)


# ----------------------------------------------------------------- imageops
RESIZE_CASES = [  # (h, w) -> (out_h, out_w)
    ((64, 64), (256, 256)), ((64, 64), (224, 224)), ((256, 256), (224, 224)),
    ((200, 300), (80, 120)), ((131, 97), (303, 224)), ((500, 375), (224, 168)),
    ((17, 5), (40, 3)),
]


@pytest.mark.parametrize("case", RESIZE_CASES, ids=lambda c: f"{c[0]}to{c[1]}")
@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
def test_resize_matches_pillow_bytes(interp, case):
    (h, w), (oh, ow) = case
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((ow, oh), jax_transforms._PIL_INTERP[interp]))
    got = imageops.resize(img, (ow, oh), interp)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_resize_to_the_same_size_is_a_copy_and_bad_input_raises():
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    out = imageops.resize(img, (4, 4), "bicubic")
    assert out is not img and np.array_equal(out, img)
    with pytest.raises(ValueError, match="uint8"):
        imageops.resize(img.astype(np.float32), (2, 2))
    with pytest.raises(ValueError, match="interpolation"):
        imageops.resize(img, (2, 2), "lanczos")
    with pytest.raises(ValueError, match="leaves"):
        imageops.crop(img, 1, 1, 4, 4)


@pytest.mark.parametrize("shape", [(64, 64), (97, 131), (131, 97), (300, 200)])
@pytest.mark.parametrize("size,interp", [((32, 32), "bicubic"), ((224, 224), "bicubic"),
                                         ((224, 224), "bilinear"), ((40, 24), "bicubic")])
def test_eval_view_matches_jax_before_normalize(shape, size, interp):
    jcfg, pcfg = _cfgs(INPUT__SIZE=size, INPUT__INTERPOLATION=interp)
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape + (3,)).astype(np.uint8)
    ref = np.asarray(jax_transforms._resize_center_crop(
        Image.fromarray(img), size, jax_transforms._PIL_INTERP[interp]))
    got = transforms.TestTransform(pcfg)(img)
    np.testing.assert_array_equal(got, ref)
    # and JAX's normalized eval view is this one normalized
    norm = (got.astype(np.float32) / 255.0 - np.asarray(pcfg.INPUT.PIXEL_MEAN, np.float32)) / (
        np.asarray(pcfg.INPUT.PIXEL_STD, np.float32))
    np.testing.assert_array_equal(jax_transforms.TestTransform(jcfg)(Image.fromarray(img)),
                                  norm.astype(np.float32))


def test_build_transform_needs_device_aug_for_training():
    """Training takes the host TrainTransform unless DEVICE_AUG (then None:
    the step augments on the device); NO_TRANSFORM and eval take the eval
    view, as the JAX package's build_transform."""
    jcfg, pcfg = _cfgs(DATALOADER__DEVICE_AUG=False)
    assert isinstance(transforms.build_transform(pcfg, is_train=True), transforms.TrainTransform)
    assert isinstance(transforms.build_transform(pcfg, is_train=False), transforms.TestTransform)
    _, pcfg = _cfgs(DATALOADER__DEVICE_AUG=True)
    assert transforms.build_transform(pcfg, is_train=True) is None
    jcfg, pcfg = _cfgs(DATALOADER__DEVICE_AUG=False, INPUT__NO_TRANSFORM=True)
    assert isinstance(transforms.build_transform(pcfg, is_train=True), transforms.TestTransform)
    assert isinstance(jax_transforms.build_transform(jcfg, is_train=True),
                      jax_transforms.TestTransform)


# ---------------------------------------------------------------- datasets
DATASET_CASES = {
    "uniform": dict(DATASET__NUM_SHOTS=4),
    "per_class": dict(DATASET__NUM_SHOTS=-1, DATASET__PER_CLASS_SHOTS=PER_CLASS),
    "per_class_base": dict(DATASET__NUM_SHOTS=-1, DATASET__PER_CLASS_SHOTS=PER_CLASS,
                           DATASET__SUBSAMPLE_CLASSES="base"),
    "per_class_new": dict(DATASET__NUM_SHOTS=-1, DATASET__PER_CLASS_SHOTS=PER_CLASS,
                          DATASET__SUBSAMPLE_CLASSES="new", SEED=7),
}


def _items(split):
    return [(d.impath, d.label, d.domain, d.classname) for d in split]


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_synthetic_splits_images_and_names_match_jax(case):
    jcfg, pcfg = _cfgs(**DATASET_CASES[case])
    jds, pds = JaxSynthetic(jcfg), Synthetic(pcfg)
    for split in ("train_x", "val", "test"):
        j, p = getattr(jds, split), getattr(pds, split)
        assert _items(p) == _items(j), split
        for d in p:
            np.testing.assert_array_equal(loader.decode(d.impath),
                                          np.asarray(jax_loader._decode(d.impath)))
    assert pds.lab2cname == jds.lab2cname and pds.classnames == jds.classnames
    assert pds.num_classes == jds.num_classes
    if case == "per_class":
        assert [sum(d.label == c for d in pds.train_x) for c in range(8)] == PER_CLASS


@pytest.mark.parametrize("pre_size", [256, 224, 48])
def test_device_aug_cache_matches_jax_bytes(pre_size):
    jcfg, pcfg = _cfgs(DATASET__NUM_SHOTS=-1, DATASET__PER_CLASS_SHOTS=PER_CLASS)
    jds, pds = JaxSynthetic(jcfg), Synthetic(pcfg)
    ref = jax_loader.RawDatasetWrapper(jds.train_x, pre_size=pre_size).materialize(num_threads=2)
    got = loader.RawDatasetWrapper(pds.train_x, pre_size=pre_size).materialize(num_threads=2)
    assert got.shape == (sum(PER_CLASS), pre_size, pre_size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_a_file_path_raises_instead_of_falling_back(tmp_path):
    """A file of a kind the port does not read yet (an LZMA TIFF) raises
    naming ROADMAP A16 on both views, whatever its extension; a missing file
    raises IOError.  Nothing falls back to another decoder."""
    tiff = tmp_path / "img.jpg"  # an LZMA TIFF under a JPEG name
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures",
                           "formats", "tiff_lzma_refused_64x48.tif"), "rb") as f:
        tiff.write_bytes(f.read())
    item = base_dataset.Datum(impath=str(tiff), label=0)
    with pytest.raises(NotImplementedError, match="LZMA.*ROADMAP A16"):
        loader.RawDatasetWrapper([item]).materialize(num_threads=1)
    with pytest.raises(NotImplementedError, match="LZMA.*ROADMAP A16"):
        loader.DatasetWrapper([item], lambda img: img)[0]
    missing = base_dataset.Datum(impath=str(tmp_path / "none.jpg"), label=0)
    with pytest.raises(IOError, match="No file exists"):
        loader.RawDatasetWrapper([missing]).materialize(num_threads=1)


# ---------------------------------------------------------------- samplers
def _domain_items(module):
    rng = np.random.RandomState(3)
    return [module.Datum(impath=f"x{i}", label=int(rng.randint(0, 5)), domain=i % 3)
            for i in range(60)]


SAMPLER_CASES = {
    "RandomSampler": dict(),
    "SequentialSampler": dict(),
    "WeightedClassSampler": dict(),
    "RandomClassSampler": dict(batch_size=8, n_ins=2),
    "RandomDomainSampler": dict(batch_size=6, n_domain=3),
    "SeqDomainSampler": dict(batch_size=6),
}


@pytest.mark.parametrize("name", sorted(SAMPLER_CASES))
def test_sampler_epochs_match_jax(name):
    for seed in (0, 5):
        j = jax_samplers.build_sampler(name, _domain_items(jax_base), seed=seed,
                                       **SAMPLER_CASES[name])
        p = samplers.build_sampler(name, _domain_items(base_dataset), seed=seed,
                                   **SAMPLER_CASES[name])
        assert len(p) == len(j)
        for _ in range(3):
            order = list(p)
            assert order == list(j)
            assert all(isinstance(i, int) for i in order)


def test_weighted_class_sampler_balances_the_imbalanced_split():
    _, pcfg = _cfgs(DATASET__NUM_SHOTS=-1, DATASET__PER_CLASS_SHOTS=PER_CLASS)
    data = Synthetic(pcfg).train_x
    s = samplers.WeightedClassSampler(data, seed=0, num_samples=8000)
    counts = np.bincount([data[i].label for i in s], minlength=8)
    assert counts.min() > 800 and counts.max() < 1200, counts  # 1000 each in expectation


# ------------------------------------------------------------ DataManager
@pytest.mark.parametrize("sampler", ["WeightedClassSampler", "RandomSampler",
                                     "RandomClassSampler"])
def test_data_manager_loaders_match_jax(sampler, capsys):
    kw = dict(DATASET__NUM_SHOTS=-1, DATASET__PER_CLASS_SHOTS=PER_CLASS, VERBOSE=True,
              DATALOADER__TRAIN_X__SAMPLER=sampler, DATALOADER__TRAIN_X__BATCH_SIZE=8,
              DATALOADER__TRAIN_X__N_INS=2, DATALOADER__TEST__BATCH_SIZE=10)
    jcfg, pcfg = _cfgs(**kw)
    capsys.readouterr()
    jdm = JaxDataManager(jcfg)
    jax_out = capsys.readouterr().out
    pdm = DataManager(pcfg)
    assert capsys.readouterr().out == jax_out and "# train_x" in jax_out
    assert pdm.lab2cname == jdm.lab2cname and pdm.num_classes == jdm.num_classes == 8
    assert len(pdm.train_loader_x) == len(jdm.train_loader_x)
    for _ in range(2):  # epochs
        for pb, jb in zip(pdm.train_loader_x.iter_index_batches(),
                          jdm.train_loader_x.iter_index_batches(), strict=True):
            for k in ("index", "label", "domain", "valid"):
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    for pl, jl in ((pdm.val_loader, jdm.val_loader), (pdm.test_loader, jdm.test_loader)):
        for pb, jb in zip(pl, jl, strict=True):
            for k in ("index", "label", "valid"):
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
            assert pb["img"].dtype == np.uint8 and pb["img"].shape == (10, 32, 32, 3)
            norm = (pb["img"] / np.float32(255) - np.float32(pcfg.INPUT.PIXEL_MEAN)) / (
                np.float32(pcfg.INPUT.PIXEL_STD))
            np.testing.assert_array_equal(norm.astype(np.float32), jb["img"])


def test_train_loader_batches_carry_the_cache_images():
    _, pcfg = _cfgs(DATASET__NUM_SHOTS=-1, DATASET__PER_CLASS_SHOTS=PER_CLASS,
                    DATALOADER__TRAIN_X__BATCH_SIZE=16, DATALOADER__PRE_SIZE=40)
    dm = DataManager(pcfg)
    cache = dm.train_loader_x.wrapper.materialize(num_threads=2)
    batches = list(dm.train_loader_x)
    assert len(batches) == len(dm.train_loader_x) == sum(PER_CLASS) // 16  # drop last
    for b in batches:
        np.testing.assert_array_equal(b["img"], cache[b["index"]])
        assert b["valid"].all()


def test_unported_dataset_names_the_roadmap_item():
    """An unknown name raises KeyError listing the registry, which holds the
    Dassl sets since they were ported: no ROADMAP item is left to name."""
    _, pcfg = _cfgs(DATASET__NAME="Office32")
    with pytest.raises(KeyError, match="not registered; registered: .*'Office31'") as err:
        DataManager(pcfg)
    assert "ROADMAP" not in str(err.value)


# ------------------------------------------------------------- few-shot
def _fake_items(module, n_cls=5, per=9):
    return [module.Datum(impath=f"img/{c}/{i}.jpg", label=c, classname=f"c{c}")
            for c in range(n_cls) for i in range(per)]


@pytest.mark.parametrize("shots", [dict(NUM_SHOTS=3), dict(NUM_SHOTS=-1,
                                                            PER_CLASS_SHOTS=[5, 1, 3, 8, 2]),
                                   dict(NUM_SHOTS=0)], ids=["uniform", "per_class", "all"])
def test_apply_fewshot_pipeline_matches_jax(tmp_path, shots):
    kw = {f"DATASET__{k}": v for k, v in shots.items()}
    jcfg, pcfg = _cfgs(SEED=4, **kw)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    out = {}
    for name, module, cfg, d in (("jax", jax_base, jcfg, jdir), ("port", base_dataset, pcfg, pdir)):
        train, val = _fake_items(module), _fake_items(module, per=6)
        first = module.apply_fewshot_pipeline(cfg, str(d), train, val)
        again = module.apply_fewshot_pipeline(cfg, str(d), train, val)  # from the cache file
        assert [_items(s) for s in first] == [_items(s) for s in again]
        out[name] = [_items(s) for s in first]
    assert out["port"] == out["jax"]
    assert sorted(os.listdir(pdir / "split_fewshot")) == sorted(os.listdir(jdir / "split_fewshot"))
    if shots["NUM_SHOTS"] != 0:
        assert len(os.listdir(pdir / "split_fewshot")) == 1
        # the port reads the JAX package's cache file too, importing nothing of it
        train, val = base_dataset.apply_fewshot_pipeline(pcfg, str(jdir), [], [])
        assert [_items(train), _items(val)] == out["jax"]
        assert all(type(d) is base_dataset.Datum for d in train + val)
    if shots["NUM_SHOTS"] == -1:
        assert [sum(d[1] == c for d in out["port"][0]) for c in range(5)] == [5, 1, 3, 8, 2]


def test_subsample_classes_matches_jax():
    for mode in ("all", "base", "new"):
        j = jax_base.subsample_classes(_fake_items(jax_base), _fake_items(jax_base, per=2),
                                       subsample=mode)
        p = base_dataset.subsample_classes(_fake_items(base_dataset),
                                           _fake_items(base_dataset, per=2), subsample=mode)
        assert [_items(s) for s in p] == [_items(s) for s in j]
