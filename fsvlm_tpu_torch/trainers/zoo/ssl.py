"""The SSL zoo's shared pieces (counterpart of part of
fsvlm_tpu.trainers.zoo.ssl): the weak/strong view wrapper and its loader,
which DAELDG, CDAC and DAEL use.  The five SSL trainers themselves (SupBaseline, EntMin,
MeanTeacher, MixMatch, FixMatch) are not ported yet (ROADMAP A9)."""

import copy
import random

import numpy as np

from ...data.loader import BatchLoader, DatasetWrapper
from ...data.samplers import build_sampler
from ...data.transforms import TrainTransform


class _WeakStrongWrapper(DatasetWrapper):
    """"img": the weak view(s), "img2": the strong view(s) of each train item,
    both drawn from the visit's rng (ssl.py:242-272; with k = 2 each
    pipeline stacks two views, CDAC's layout)."""

    def __init__(self, data_source, tfm_weak, tfm_strong, seed=None, k=1):
        super().__init__(data_source, tfm_weak, train=True, seed=seed)
        self.tfm_strong = tfm_strong
        self.k = k

    def __getitem__(self, idx, rng=None):
        item = self.data_source[idx]
        img = self.image(idx)
        rng = rng or self._item_rng(idx)
        kw = {"rng": rng} if rng is not None else {}
        if self.k > 1:
            weak = np.stack([self.transform(img, **kw) for _ in range(self.k)])
            strong = np.stack([self.tfm_strong(img, **kw) for _ in range(self.k)])
        else:
            weak = self.transform(img, **kw)
            strong = self.tfm_strong(img, **kw)
        return {"img": weak, "img2": strong, "label": item.label, "domain": item.domain,
                "index": idx, "impath": item.impath}


def two_view_loader(cfg, strong_transforms, data_source, sampler_name, batch_size, n_domain=0,
                    k=1):
    """A train loader of each item's weak (INPUT.TRANSFORMS, "img") and
    strong (``strong_transforms``, "img2") views, k of each, the weak and
    strong pipelines drawing from rngs seeded SEED and SEED + 1."""
    strong_cfg = copy.deepcopy(cfg)
    strong_cfg.INPUT.TRANSFORMS = tuple(strong_transforms)
    seed = cfg.SEED if cfg.SEED >= 0 else None
    tfm_weak = TrainTransform(cfg, rng=random.Random(seed or 0))
    tfm_strong = TrainTransform(strong_cfg, rng=random.Random((seed or 0) + 1))
    sampler = build_sampler(sampler_name, data_source, batch_size=batch_size, n_domain=n_domain,
                            seed=seed)
    return BatchLoader(_WeakStrongWrapper(data_source, tfm_weak, tfm_strong, seed=seed, k=k),
                       sampler, batch_size=batch_size,
                       drop_last=len(data_source) >= batch_size,
                       num_threads=max(1, cfg.DATALOADER.NUM_WORKERS), extra_keys=("img2",))
