"""The port's host train loader and the SimCLR two-view loader against the
JAX package's, on the CPU.

- ``DataManager``'s train loader without DEVICE_AUG (the scripts' default)
  on Synthetic and on a small JPEG tree (the committed fixtures in a
  Caltech101 layout), with DATALOADER.NUM_WORKERS 1 and 4: the same index,
  label and valid arrays and the same images batch for batch over two
  epochs (the port's uint8 batches normalized as the trainer normalizes
  them, within 1e-6 of JAX's floats; float batches where a float-stage op
  runs on the host), under the recipe's list and under a list with
  colour jitter, grayscale, blur and cutout;
- the per-(item, visit) rngs (the same seeds in the same visit order), a
  duplicate index in one batch giving two draws, K_TRANSFORMS 2 and
  RETURN_IMG0, INPUT.NO_TRANSFORM;
- ``make_simclr_loader`` batch for batch against JAX's at one thread; at
  four threads (JAX's shared rng then follows the threads' order) the
  shapes and that the two views differ.
"""

import os
import random
import shutil

import numpy as np
import pytest

from fsvlm_tpu import native as jax_native
from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.data.data_manager import DataManager as JaxDataManager
from fsvlm_tpu.trainers import simclr_utils as jax_simclr
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.data.data_manager import DataManager
from fsvlm_tpu_torch.data.loader import DatasetWrapper
from fsvlm_tpu_torch.trainers import simclr_utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
RECIPE = ("random_resized_crop", "random_flip", "normalize")
HEAVY = ("random_resized_crop", "random_flip", "colorjitter", "randomgrayscale", "gaussian_blur",
         "cutout", "normalize")


def _jpeg_tree(root, n_classes=4, per_class=4):
    """A Caltech101-layout tree of the committed JPEG fixtures (copies)."""
    files = sorted(f for f in os.listdir(JPEGS) if f.endswith(".jpg"))
    image_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    k = 0
    for c in range(n_classes):
        os.makedirs(os.path.join(image_dir, f"class_{c:02d}"))
        for j in range(per_class):
            shutil.copy(os.path.join(JPEGS, files[k % len(files)]),
                        os.path.join(image_dir, f"class_{c:02d}", f"image_{j:04d}.jpg"))
            k += 1


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    jax_native.native_available()  # the JAX package's decoder loads once, before any pool
    root = tmp_path_factory.mktemp("host_tree")
    _jpeg_tree(str(root))
    return root


def _cfgs(data, workers, transforms=RECIPE, root=None, **kw):
    out = []
    for cfg in (jax_get_cfg_default(), get_cfg_base()):
        cfg.SEED = 1
        cfg.VERBOSE = False
        if data == "synthetic":
            cfg.DATASET.NAME = "Synthetic"
            cfg.DATASET.NUM_SHOTS = -1
            cfg.DATASET.PER_CLASS_SHOTS = [6, 6, 4, 4, 2, 2, 1, 1]
        else:
            cfg.DATASET.NAME = "Caltech101"
            cfg.DATASET.ROOT = str(root)
            cfg.DATASET.NUM_SHOTS = 3
        cfg.DATALOADER.DEVICE_AUG = False
        cfg.DATALOADER.NUM_WORKERS = workers
        cfg.DATALOADER.TRAIN_X.SAMPLER = "WeightedClassSampler"
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
        cfg.INPUT.SIZE = (32, 32)
        cfg.INPUT.INTERPOLATION = "bicubic"
        cfg.INPUT.TRANSFORMS = tuple(transforms)
        cfg.INPUT.CUTOUT_LEN = 8
        cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
        cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
        for path, v in kw.items():
            node, key = path.split("__")
            setattr(getattr(cfg, node), key, v)
        out.append(cfg)
    return out


def _as_jax(x, cfg):
    """A port batch's images as the JAX package ships them: uint8 normalized
    as the trainer's ``eval_images``, float as it is."""
    if x.dtype != np.uint8:
        return x
    x = x.astype(np.float32) / 255.0
    if "normalize" in cfg.INPUT.TRANSFORMS:
        x = (x - np.float32(cfg.INPUT.PIXEL_MEAN)) / np.float32(cfg.INPUT.PIXEL_STD)
    return x.astype(np.float32)


def _same_batches(port_loader, jax_loader, pcfg, keys=("img",), epochs=2):
    """Batch for batch within 1e-6.  With more than one JAX loader thread,
    the visits of an index that a batch holds twice are numbered in the
    order the threads take them (the port numbers them in batch order), so
    such places are matched as a set."""
    n = 0
    threads = jax_loader.num_threads
    for _ in range(epochs):
        for pb, jb in zip(port_loader, jax_loader, strict=True):
            for k in ("index", "label", "domain", "valid"):
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
            for k in keys:
                got, want = _as_jax(pb[k], pcfg), jb[k]
                assert got.shape == want.shape, k
                if threads == 1:
                    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
                    continue
                for idx in np.unique(pb["index"][pb["valid"]]):
                    places = np.flatnonzero((pb["index"] == idx) & pb["valid"])
                    free = list(places)
                    for p in places:
                        hit = [q for q in free if np.abs(got[p] - want[q]).max() <= 1e-6]
                        assert hit, (k, int(idx))
                        free.remove(hit[0])
            n += 1
    assert n > 0
    return n


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("transforms", [RECIPE, HEAVY], ids=["recipe", "heavy"])
@pytest.mark.parametrize("data", ["synthetic", "jpeg"])
def test_train_batches_match_jax(data, transforms, workers, jpeg_root, tmp_path):
    root = None
    if data == "jpeg":
        root = tmp_path / "tree"
        shutil.copytree(jpeg_root, root)
    jcfg, pcfg = _cfgs(data, workers, transforms, root=root)
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    wrapper = pdm.train_loader_x.wrapper
    assert wrapper.uint8 == (transforms == RECIPE)  # cutout runs on the host
    _same_batches(pdm.train_loader_x, jdm.train_loader_x, pcfg)
    # the per-(item, visit) counters advanced alike: both saw the same visits
    assert wrapper._visits == jdm.train_loader_x.wrapper._serve_counts


def test_item_rngs_are_the_jax_packages_per_visit_seeds():
    jcfg, pcfg = _cfgs("synthetic", 1, HEAVY)
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    jw, pw = jdm.train_loader_x.wrapper, pdm.train_loader_x.wrapper
    for idx in [0, 3, 3, 7, 0, 3, 12]:
        assert pw._item_rng(idx).getstate() == jw._item_rng(idx).getstate()
    assert pw._visits == {0: 2, 3: 3, 7: 1, 12: 1}


def test_a_duplicate_index_in_one_batch_gives_two_draws():
    _, pcfg = _cfgs("synthetic", 4, HEAVY)
    pdm = DataManager(pcfg)
    loader = pdm.train_loader_x
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        batch = loader._collate(pool, [5, 5, 5, 2])
    imgs = batch["img"]
    assert not np.array_equal(imgs[0], imgs[1]) and not np.array_equal(imgs[1], imgs[2])
    # the short batch is padded with its last item's arrays, not a new draw
    np.testing.assert_array_equal(imgs[4], imgs[3])
    assert loader.wrapper._visits == {5: 3, 2: 1}


def test_visit_counts_hold_under_many_threads():
    """32 threads (more than the cores) drawing visits of 4 items with a
    short switch interval: no visit is lost and no seed given twice."""
    import sys
    import threading

    _, pcfg = _cfgs("synthetic", 1, RECIPE)
    wrapper = DataManager(pcfg).train_loader_x.wrapper
    seeds, lock = [], threading.Lock()

    def visit():
        for i in range(200):
            state = wrapper._item_rng(i % 4).getstate()
            with lock:
                seeds.append(state)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=visit) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper._visits == {i: 1600 for i in range(4)}
    assert len(set(seeds)) == len(seeds) == 6400


def test_a_loader_left_mid_epoch_stops_its_producer():
    import threading

    _, pcfg = _cfgs("synthetic", 2, RECIPE)
    loader = DataManager(pcfg).train_loader_x
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()  # the producer is joined, whatever it had prefetched
    assert threading.active_count() == before


@pytest.mark.parametrize("workers", [1, 4])
def test_k_transforms_and_return_img0_match_jax(workers):
    jcfg, pcfg = _cfgs("synthetic", workers, RECIPE, DATALOADER__K_TRANSFORMS=2,
                       DATALOADER__RETURN_IMG0=True)
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    _same_batches(pdm.train_loader_x, jdm.train_loader_x, pcfg, keys=("img", "img0"), epochs=1)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        batch = pdm.train_loader_x._collate(pool, [0, 1, 2])
    assert batch["img"].shape == (8, 2, 32, 32, 3) and batch["img0"].shape == (8, 32, 32, 3)
    assert not np.array_equal(batch["img"][:, 0], batch["img"][:, 1])


def test_no_transform_trains_on_the_eval_view_as_jax():
    jcfg, pcfg = _cfgs("synthetic", 2, RECIPE, INPUT__NO_TRANSFORM=True)
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    assert type(pdm.tfm_train).__name__ == "TestTransform"
    _same_batches(pdm.train_loader_x, jdm.train_loader_x, pcfg, epochs=1)


def test_the_seedless_wrapper_draws_from_the_shared_rng():
    """SEED < 0: no per-item rng; the transform's own rng is the stream."""
    _, pcfg = _cfgs("synthetic", 1, RECIPE, DATALOADER__NUM_WORKERS=1)
    pcfg.SEED = -1
    pdm = DataManager(pcfg)
    assert pdm.train_loader_x.wrapper.seed is None
    assert pdm.train_loader_x.wrapper._item_rng(0) is None
    assert isinstance(pdm.tfm_train.rng, random.Random)


# ------------------------------------------------------------------ SimCLR
def test_simclr_loader_matches_jax_at_one_thread(jpeg_root, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(jpeg_root, root)
    jcfg, pcfg = _cfgs("jpeg", 1, RECIPE, root=root)
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    jl = jax_simclr.make_simclr_loader(jcfg, jdm.dataset.train_x)
    pl = simclr_utils.make_simclr_loader(pcfg, pdm.dataset.train_x)
    assert len(pl) == len(jl) and pl.extra_keys == ("img2",)
    assert pl.wrapper.uint8  # the recipe normalizes with CLIP's statistics, as SimCLR's list
    _same_batches(pl, jl, pcfg, keys=("img", "img2"))


def test_simclr_loader_ships_float_where_the_recipe_normalizes_otherwise():
    jcfg, pcfg = _cfgs("synthetic", 1, ("random_resized_crop", "random_flip"))
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    jl = jax_simclr.make_simclr_loader(jcfg, jdm.dataset.train_x)
    pl = simclr_utils.make_simclr_loader(pcfg, pdm.dataset.train_x)
    assert not pl.wrapper.uint8
    _same_batches(pl, jl, pcfg, keys=("img", "img2"), epochs=1)


def test_simclr_loader_at_four_threads_gives_two_distinct_views():
    jcfg, pcfg = _cfgs("synthetic", 4, RECIPE)
    jdm, pdm = JaxDataManager(jcfg), DataManager(pcfg)
    jb = next(iter(jax_simclr.make_simclr_loader(jcfg, jdm.dataset.train_x)))
    n = 0
    for pb in simclr_utils.make_simclr_loader(pcfg, pdm.dataset.train_x):
        assert pb["img"].shape == pb["img2"].shape == jb["img"].shape[:1] + (32, 32, 3)
        for a, b in zip(pb["img"], pb["img2"]):
            assert not np.array_equal(a, b)
        n += 1
    assert n == len(pdm.train_loader_x)


def test_simclr_wrapper_is_a_train_wrapper_without_item_rngs():
    _, pcfg = _cfgs("synthetic", 1, RECIPE)
    pl = simclr_utils.make_simclr_loader(pcfg, DataManager(pcfg).dataset.train_x)
    assert isinstance(pl.wrapper, DatasetWrapper) and pl.wrapper.train
    assert pl.wrapper.seed is None  # the shared rng, as the JAX package's
    sim = simclr_utils.simclr_transform_cfg(pcfg)
    assert sim.INPUT.TRANSFORMS == tuple(jax_simclr.simclr_transform_cfg(
        _cfgs("synthetic", 1)[0]).INPUT.TRANSFORMS)
    assert pcfg.INPUT.TRANSFORMS == RECIPE  # the experiment's config is left alone
