"""The SSL zoo's shared pieces (counterpart of part of
fsvlm_tpu.trainers.zoo.ssl): the weak/strong view wrapper, which DAELDG
uses.  The SSL trainers themselves are not ported yet (ROADMAP A9)."""

import numpy as np

from ...data.loader import DatasetWrapper


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
