"""Host batch pipeline (counterpart of fsvlm_tpu.data.loader), uint8 only.

- ``DatasetWrapper``: applies the eval transform to Datum items, caching
  the transformed uint8 view (the eval transform is deterministic);
- ``RawDatasetWrapper``: the fixed-size uint8 images of the device-aug
  train path (bilinear resize of the shorter edge to ``pre_size``, centre
  crop), cached; ``materialize`` stacks the whole set in dataset order for
  the device-resident cache;
- ``BatchLoader``: fixed-shape batches in the sampler's order, the decodes
  served by a thread pool; a short last batch is padded with its last item
  and carries ``valid``; ``drop_last`` drops it instead;
  ``iter_index_batches`` gives the same batches without pixels.

Batch dict: {"img": (B, H, W, 3) uint8, "label", "domain", "index": (B,)
int32, "valid": (B,) bool}.  Images come from the in-memory synthetic store
(``synthetic://<key>``) or from JPEG files through the port's decoder
(``fsvlm_tpu_torch.native``); any other file raises (ROADMAP A16), and
nothing falls back to another decoder.  The device-aug cache view follows
the JAX package's rule (fsvlm_tpu/data/loader.py:154-183): a ``.jpg`` or
``.jpeg`` path takes ``decode_file``; where that has no RGB output (CMYK,
YCCK), and for any other path, the full decode is resized as Pillow's
bilinear and cropped, as the JAX package's PIL branch does.
"""

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils import read_image
from .imageops import resize_shorter_center_crop

# in-memory uint8 (H, W, 3) images of the synthetic datasets, process-wide
# as in the JAX package: a later dataset with the same keys replaces them
_SYNTHETIC_STORE = {}
# the wrappers cache at most this many items (a full-size set stays uncached)
MAX_CACHE_ITEMS = 60000


def register_synthetic_image(key, array):
    _SYNTHETIC_STORE[f"synthetic://{key}"] = np.asarray(array, np.uint8)


def decode(impath):
    """The full-resolution uint8 (H, W, 3) image."""
    if impath.startswith("synthetic://"):
        return _SYNTHETIC_STORE[impath]
    return read_image(impath)


def _item_dict(item, idx, img):
    return {"img": img, "label": item.label, "domain": item.domain, "index": idx,
            "impath": item.impath}


class DatasetWrapper:
    """The eval view of each item, cached after first use (sets of at most
    MAX_CACHE_ITEMS items), within a byte budget of FSVLM_EVAL_CACHE_MB
    (default 4096) as the JAX package's: past it the cache is dropped and
    every later item is transformed again."""

    budgeted = True

    def __init__(self, data_source, transform, cache_transformed=True):
        self.data_source = data_source
        self.transform = transform
        cacheable = cache_transformed and len(data_source) <= MAX_CACHE_ITEMS
        self._cache = {} if cacheable else None
        budget_mb = int(os.environ.get("FSVLM_EVAL_CACHE_MB", "4096"))
        self._budget = budget_mb << 20 if self.budgeted else None
        self.cached_bytes = 0
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.data_source)

    def view(self, impath):
        return self.transform(decode(impath))

    def __getitem__(self, idx):
        item = self.data_source[idx]
        cache = self._cache
        x = cache.get(idx) if cache is not None else None
        if x is None:
            x = self.view(item.impath)
            if cache is not None:
                self._store(idx, x)
        return _item_dict(item, idx, x)

    def _store(self, idx, x):
        with self._lock:
            if self._cache is None or idx in self._cache:  # another thread stored it
                return
            self.cached_bytes += x.nbytes
            if self._budget is not None and self.cached_bytes > self._budget:
                print(f"* transformed-tensor cache disabled: exceeds {self._budget >> 20} MB "
                      "(FSVLM_EVAL_CACHE_MB)")
                self._cache = None
                self.cached_bytes = 0
            else:
                self._cache[idx] = x


class RawDatasetWrapper(DatasetWrapper):
    """uint8 ``pre_size`` squares for the device-side augmentation, cached
    with the item-count cap only (as the JAX package's)."""

    budgeted = False

    def __init__(self, data_source, pre_size=256):
        super().__init__(data_source, None)
        self.pre_size = pre_size

    def view(self, impath):
        if impath.lower().endswith((".jpg", ".jpeg")):
            from ..native import decode_file

            x = decode_file(impath, self.pre_size)
            if x is not None:
                return x
        return resize_shorter_center_crop(decode(impath), self.pre_size)

    def materialize(self, num_threads=8):
        """The whole set as one (N, P, P, 3) uint8 array in dataset order, so
        that row i serves index i."""
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            items = list(pool.map(self.__getitem__, range(len(self))))
        return np.stack([it["img"] for it in items])  # every view is uint8 already


class BatchLoader:
    """Fixed-shape numpy batches in the sampler's order."""

    def __init__(self, wrapper, sampler, batch_size, drop_last=False, num_threads=8):
        assert len(wrapper) > 0
        self.wrapper = wrapper
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_threads = num_threads

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idxs = list(iter(self.sampler))
        for start in range(0, len(idxs), self.batch_size):
            chunk = idxs[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def _meta(self, chunk):
        """label, domain, index and valid of a chunk padded to the batch size."""
        n_valid = len(chunk)
        idxs = list(chunk) + [chunk[-1]] * (self.batch_size - n_valid)
        items = [self.wrapper.data_source[i] for i in idxs]
        return {
            "label": np.asarray([it.label for it in items], np.int32),
            "domain": np.asarray([it.domain for it in items], np.int32),
            "index": np.asarray(idxs, np.int32),
            "valid": np.arange(self.batch_size) < n_valid,
        }

    def iter_index_batches(self):
        """The epoch's batches without pixels, for the device-resident path."""
        for chunk in self._index_batches():
            yield self._meta(chunk)

    def __iter__(self):
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            for chunk in self._index_batches():
                batch = self._meta(chunk)
                images = list(pool.map(lambda i: self.wrapper[i]["img"], batch["index"].tolist()))
                batch["img"] = np.stack(images)
                yield batch
