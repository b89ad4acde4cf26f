"""The SimCLR two-view loader (counterpart of fsvlm_tpu.trainers.simclr_utils
and of the JAX package's train.py loader override).

``make_simclr_loader(cfg, data_source)`` gives the loader that feeds the
SimCLR objectives (CoOp's LOSS_TYPE simclr, PromptSRC's and IVLP's
SIMCLR_ALPHA): each item is seen through the SimCLR augmentation list
(``simclr_transform_cfg``: random_resized_crop, random_flip, colorjitter,
randomgrayscale, gaussian_blur, normalize with CLIP's mean and std) twice,
as "img" and "img2", both drawn from the transform's one shared
``random.Random(max(SEED, 0))`` as in the JAX package (no per-item rng: with
more than one loader thread the draws follow the threads' order).  The
sampler is a RandomSampler seeded from SEED whatever the recipe's.  The
views ship as uint8 where the trainer's normalization under ``cfg`` is the
SimCLR list's (``TrainTransform.uint8_suffices``), else as float32.
"""

import copy
import random

from ..data.loader import BatchLoader, DatasetWrapper, _item_dict
from ..data.samplers import RandomSampler
from ..data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, TrainTransform


def simclr_transform_cfg(cfg):
    """The experiment's config with the SimCLR augmentation list."""
    sim = copy.deepcopy(cfg)
    sim.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "colorjitter",
                            "randomgrayscale", "gaussian_blur", "normalize")
    sim.INPUT.PIXEL_MEAN = list(CLIP_PIXEL_MEAN)
    sim.INPUT.PIXEL_STD = list(CLIP_PIXEL_STD)
    return sim


class _TwoViewWrapper(DatasetWrapper):
    """Each item's two views: "img" (view 1) and "img2" (view 2)."""

    def __getitem__(self, idx, rng=None):
        img = self.image(idx)
        view = self.transform.pixels if self.uint8 else self.transform
        out = _item_dict(self.data_source[idx], idx, view(img))
        out["img2"] = view(img)
        return out


def make_simclr_loader(cfg, data_source):
    tfm = TrainTransform(simclr_transform_cfg(cfg), rng=random.Random(max(cfg.SEED, 0)))
    wrapper = _TwoViewWrapper(data_source, tfm, train=True, uint8=tfm.uint8_suffices(cfg))
    sampler = RandomSampler(data_source, seed=cfg.SEED if cfg.SEED >= 0 else None)
    batch = cfg.DATALOADER.TRAIN_X.BATCH_SIZE
    # drop_last only when the set fills a batch, else an epoch has no step
    return BatchLoader(wrapper, sampler, batch_size=batch, drop_last=len(data_source) >= batch,
                       num_threads=max(1, cfg.DATALOADER.NUM_WORKERS), extra_keys=("img2",))
