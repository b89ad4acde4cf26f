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
int32, "valid": (B,) bool}.  Images are decoded from the in-memory
synthetic store (``synthetic://<key>``); any file path raises: the JPEG
decode is not ported (ROADMAP A11), and nothing falls back to another
decoder.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .imageops import resize_shorter_center_crop

# in-memory uint8 (H, W, 3) images of the synthetic datasets, process-wide
# as in the JAX package: a later dataset with the same keys replaces them
_SYNTHETIC_STORE = {}
# the wrappers cache at most this many items (a full-size set stays uncached)
MAX_CACHE_ITEMS = 60000


def register_synthetic_image(key, array):
    _SYNTHETIC_STORE[f"synthetic://{key}"] = np.asarray(array, np.uint8)


def decode(impath):
    if impath.startswith("synthetic://"):
        return _SYNTHETIC_STORE[impath]
    raise NotImplementedError(
        f"cannot read {impath!r}: decoding image files (JPEG and the rest) is not ported "
        "yet (ROADMAP A11); the port reads the synthetic datasets only")


def _item_dict(item, idx, img):
    return {"img": img, "label": item.label, "domain": item.domain, "index": idx,
            "impath": item.impath}


class DatasetWrapper:
    """The eval view of each item, cached after first use (sets of at most
    MAX_CACHE_ITEMS items)."""

    def __init__(self, data_source, transform, cache_transformed=True):
        self.data_source = data_source
        self.transform = transform
        cacheable = cache_transformed and len(data_source) <= MAX_CACHE_ITEMS
        self._cache = {} if cacheable else None

    def __len__(self):
        return len(self.data_source)

    def __getitem__(self, idx):
        item = self.data_source[idx]
        x = self._cache.get(idx) if self._cache is not None else None
        if x is None:
            x = self.transform(decode(item.impath))
            if self._cache is not None:
                self._cache[idx] = x
        return _item_dict(item, idx, x)


class RawDatasetWrapper(DatasetWrapper):
    """uint8 ``pre_size`` squares for the device-side augmentation."""

    def __init__(self, data_source, pre_size=256):
        super().__init__(data_source, lambda img: resize_shorter_center_crop(img, pre_size))
        self.pre_size = pre_size

    def materialize(self, num_threads=8):
        """The whole set as one (N, P, P, 3) uint8 array in dataset order, so
        that row i serves index i."""
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            items = list(pool.map(self.__getitem__, range(len(self))))
        return np.stack([it["img"] for it in items]).astype(np.uint8)


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
                batch["img"] = np.stack(images).astype(np.uint8)
                yield batch
