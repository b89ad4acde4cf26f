"""Host batch pipeline (counterpart of fsvlm_tpu.data.loader).

- ``DatasetWrapper``: applies a transform to Datum items: the eval view,
  cached (the eval transform is deterministic), or the train transform at
  every visit, from the decoded-image cache and a per-(item, visit) rng;
- ``RawDatasetWrapper``: the fixed-size uint8 images of the device-aug
  train path (bilinear resize of the shorter edge to ``pre_size``, centre
  crop), cached; ``materialize`` stacks the whole set in dataset order for
  the device-resident cache;
- ``BatchLoader``: fixed-shape batches in the sampler's order, the items
  built by a thread pool and prefetched by a producer thread; a short last
  batch is padded with its last item and carries ``valid``; ``drop_last``
  drops it instead; ``iter_index_batches`` gives the same batches without
  pixels.

Batch dict: {"img": (B, H, W, 3) uint8 (float32 where a train transform's
float stage runs on the host; (B, K, H, W, 3) under K_TRANSFORMS K > 1),
"label", "domain", "index": (B,) int32, "valid": (B,) bool}, with "img0"
under RETURN_IMG0 and the loader's ``extra_keys`` (SimCLR's "img2").
Images come from the in-memory synthetic store (``synthetic://<key>``) or
from JPEG, PNG, BMP, Netpbm, GIF, TIFF and WebP files through the port's
decoders (``fsvlm_tpu_torch.native``; a TIFF compressed with LZMA, ZSTD,
WebP, Thunderscan or SGILog raises, ROADMAP A16), and nothing falls back to
another decoder.  The device-aug
cache view follows the JAX package's rule (fsvlm_tpu/data/loader.py:154-183):
a ``.jpg`` or ``.jpeg`` path takes ``decode_file``; where that has no output
(a CMYK, YCCK or lossless JPEG, another format under a JPEG name), and for
any other path (``.png``, ``.bmp``, ``.ppm``, ``.gif``, ``.tif``,
``.webp``), the full decode is resized as Pillow's bilinear and cropped, as
the JAX package's PIL branch does.
"""

import os
import queue
import random
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
PREFETCH = 2  # batches the loader's producer thread builds ahead of the consumer


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
    """A transform applied to Datum items (counterpart of the JAX package's
    DatasetWrapper, loader.py:42-137).

    - Eval (the default): the eval view of each item, cached after first
      use (sets of at most MAX_CACHE_ITEMS items), within a byte budget of
      FSVLM_EVAL_CACHE_MB (default 4096) as the JAX package's: past it the
      cache is dropped and every later item is transformed again.
    - Train (``train``): the decoded image is cached (sets of at most
      MAX_CACHE_ITEMS items) and the transform runs at every visit.  With
      ``seed`` and a transform that draws from an rng, each visit draws from
      its own ``random.Random((seed * 1000003 + idx) * 7919 + count)``,
      ``count`` the item's visits so far under a lock, so that the views do
      not depend on the loader's threads and a duplicate index in one batch
      gets two draws (``_item_rng``; the BatchLoader draws a batch's rngs
      in batch order before its threads run, so that duplicates keep their
      order too).  ``k_transforms`` past 1 stacks that many views on a new first axis;
      ``return_img0`` adds ``img0``, ``img0_transform``'s view of the image
      (the eval view).  A TrainTransform's output ships as its pixel stage's
      uint8 where ``uint8`` is set (the caller checked
      ``TrainTransform.uint8_suffices``), else as float32.
    """

    budgeted = True

    def __init__(self, data_source, transform, cache_transformed=True, train=False,
                 k_transforms=1, return_img0=False, img0_transform=None, seed=None,
                 uint8=False):
        self.data_source = data_source
        self.transform = transform
        self.train = train
        self.k_transforms = k_transforms
        self.return_img0 = return_img0
        self.img0_transform = img0_transform
        self.seed = seed
        self.uint8 = uint8
        cacheable = len(data_source) <= MAX_CACHE_ITEMS
        self._cache = {} if cache_transformed and cacheable and not train else None
        self._decoded = {} if train and cacheable else None
        budget_mb = int(os.environ.get("FSVLM_EVAL_CACHE_MB", "4096"))
        self._budget = budget_mb << 20 if self.budgeted else None
        self.cached_bytes = 0
        self._lock = threading.Lock()
        self._visits = {}

    def __len__(self):
        return len(self.data_source)

    def view(self, impath):
        return self.transform(decode(impath))

    def image(self, idx):
        """The decoded uint8 image of item ``idx``, through the decoded cache."""
        cache = self._decoded
        img = cache.get(idx) if cache is not None else None
        if img is None:
            img = decode(self.data_source[idx].impath)
            if cache is not None:
                cache[idx] = img
        return img

    def _item_rng(self, idx):
        """This visit's rng (loader.py:71-86), or None without a seed."""
        if self.seed is None:
            return None
        with self._lock:
            count = self._visits.get(idx, 0)
            self._visits[idx] = count + 1
        return random.Random((self.seed * 1_000_003 + idx) * 7919 + count)

    def train_view(self, idx, rng=None):
        img = self.image(idx)
        tfm = self.transform
        if getattr(tfm, "rng", None) is None:  # a deterministic transform (NO_TRANSFORM)
            views = [tfm(img) for _ in range(self.k_transforms)]
        else:
            rng = rng or self._item_rng(idx)
            fn = tfm.pixels if self.uint8 else tfm
            views = [fn(img, rng) for _ in range(self.k_transforms)]
        return np.stack(views) if self.k_transforms > 1 else views[0]

    def __getitem__(self, idx, rng=None):
        """Item ``idx``'s dict; ``rng``: a train visit's rng where the caller
        drew it (else it is drawn here)."""
        item = self.data_source[idx]
        if self.train:
            out = _item_dict(item, idx, self.train_view(idx, rng))
            if self.return_img0:
                img = self.image(idx)
                out["img0"] = (self.img0_transform(img) if self.img0_transform is not None
                               else img)
            return out
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
    """Fixed-shape numpy batches in the sampler's order, the items built by a
    pool of ``num_threads`` threads and PREFETCH batches ahead of the
    consumer by a producer thread (loader.py:186-317)."""

    def __init__(self, wrapper, sampler, batch_size, drop_last=False, num_threads=8,
                 extra_keys=()):
        assert len(wrapper) > 0
        self.wrapper = wrapper
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.extra_keys = tuple(extra_keys)

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

    def _collate(self, pool, chunk):
        """The chunk's items (each built once; a short batch repeats its last
        item's arrays) stacked: "img", "img0" where the wrapper gives it, and
        ``extra_keys``."""
        batch = self._meta(chunk)
        wrapper = self.wrapper
        # a train visit's rng is drawn here, in batch order: a duplicate index
        # gets its visits in the order of its places, whatever thread runs it
        rngs = [wrapper._item_rng(i) if wrapper.train else None for i in chunk]
        items = list(pool.map(wrapper.__getitem__, chunk, rngs))
        items += [items[-1]] * (self.batch_size - len(items))
        for k in ("img", "img0", *self.extra_keys):
            if k in items[0]:
                batch[k] = np.stack([it[k] for it in items])
        return batch

    def __iter__(self):
        q = queue.Queue(maxsize=PREFETCH)
        done = object()
        stop = threading.Event()
        failure = []

        def put(x):
            while not stop.is_set():  # a consumer that stops early sets ``stop``
                try:
                    q.put(x, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    for chunk in self._index_batches():
                        if stop.is_set():
                            return
                        put(self._collate(pool, chunk))
            except BaseException as e:  # raised again in the consumer
                failure.append(e)
            finally:
                put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is done:
                    if failure:
                        raise RuntimeError("the data loader's producer failed") from failure[0]
                    return
                yield batch
        finally:
            stop.set()
            thread.join()
