"""DataManager: the dataset and its loaders (counterpart of
fsvlm_tpu.data.data_manager, :16-153).

Builds the dataset named by DATASET.NAME (Synthetic, SyntheticSSL and
SyntheticDA, the 11 recognition datasets and the 4 ImageNet shifts, the 21
Dassl DA/DG/SSL sets), the train and eval transforms (or
``custom_tfm_train`` / ``custom_tfm_test``; under SEED >= 0 the train
transform's shared rng is ``random.Random(SEED)``), then the loaders.
train_x, and train_u where the dataset has an unlabeled split (the DA
targets, the SSL pool): under DATALOADER.DEVICE_AUG uint8 ``pre_size``
batches for the device-side augmentation; else the host train transform
through ``dataset_wrapper`` (default DatasetWrapper) with SEED's per-(item,
visit) rngs, DATALOADER.K_TRANSFORMS and RETURN_IMG0, shipping uint8 where
the transform's float stage is the trainer's normalization
(``TrainTransform.uint8_suffices``).  Each drops its last short batch when
its set holds at least one batch.  train_u takes DATALOADER.TRAIN_U's
sampler, batch size and N_INS, or under TRAIN_U.SAME_AS_X train_x's, and
TRAIN_U.N_DOMAIN.  val and test: padded uint8 batches of the eval view.
Every sampler is seeded from SEED (unseeded when SEED < 0).
``num_source_domains``: the number of SOURCE_DOMAINS, or else the largest
train_x domain + 1.  Prints the dataset summary table under VERBOSE.
"""

import random

from ..utils.registry import Registry
from .loader import BatchLoader, DatasetWrapper, RawDatasetWrapper
from .samplers import build_sampler
from .transforms import build_transform

DATASET_REGISTRY = Registry("DATASET")


def build_dataset(cfg):
    if cfg.DATASET.NAME not in DATASET_REGISTRY:
        raise KeyError(f"Dataset {cfg.DATASET.NAME!r} is not registered; registered: "
                       f"{DATASET_REGISTRY.registered_names()}")
    return DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg)


class DataManager:
    def __init__(self, cfg, custom_tfm_train=None, custom_tfm_test=None, dataset_wrapper=None):
        self.cfg = cfg
        dataset = build_dataset(cfg)
        self.dataset = dataset
        tfm_train = custom_tfm_train or build_transform(cfg, is_train=True)
        self.tfm_test = custom_tfm_test or build_transform(cfg, is_train=False)
        if cfg.SEED >= 0 and hasattr(tfm_train, "rng"):
            tfm_train.rng = random.Random(cfg.SEED)
        self.tfm_train = tfm_train
        seed = cfg.SEED if cfg.SEED >= 0 else None
        threads = max(1, cfg.DATALOADER.NUM_WORKERS)

        def eval_loader(data_source):
            if not data_source:
                return None
            sampler = build_sampler(cfg.DATALOADER.TEST.SAMPLER, data_source,
                                    batch_size=cfg.DATALOADER.TEST.BATCH_SIZE, n_ins=0, seed=seed)
            return BatchLoader(DatasetWrapper(data_source, self.tfm_test), sampler,
                               cfg.DATALOADER.TEST.BATCH_SIZE, num_threads=threads)

        def train_loader(data_source, sampler_type, batch_size, n_ins, n_domain):
            if not data_source:
                return None
            sampler = build_sampler(sampler_type, data_source, batch_size=batch_size,
                                    n_domain=n_domain, n_ins=n_ins, seed=seed)
            if cfg.DATALOADER.DEVICE_AUG:
                wrapper = RawDatasetWrapper(data_source, pre_size=cfg.DATALOADER.PRE_SIZE)
            else:
                uint8 = getattr(tfm_train, "uint8_suffices", lambda _: True)(cfg)
                wrapper = (dataset_wrapper or DatasetWrapper)(
                    data_source, tfm_train, train=True,
                    k_transforms=cfg.DATALOADER.K_TRANSFORMS,
                    return_img0=cfg.DATALOADER.RETURN_IMG0, img0_transform=self.tfm_test,
                    seed=seed, uint8=uint8)
            return BatchLoader(wrapper, sampler, batch_size,
                               drop_last=len(data_source) >= batch_size, num_threads=threads)

        x, u = cfg.DATALOADER.TRAIN_X, cfg.DATALOADER.TRAIN_U
        self.train_loader_x = train_loader(dataset.train_x, x.SAMPLER, x.BATCH_SIZE, x.N_INS,
                                           x.N_DOMAIN)
        ux = x if u.SAME_AS_X else u
        self.train_loader_u = train_loader(dataset.train_u, ux.SAMPLER, ux.BATCH_SIZE, ux.N_INS,
                                           u.N_DOMAIN)
        self.val_loader = eval_loader(dataset.val)
        self.test_loader = eval_loader(dataset.test)

        self.num_classes = dataset.num_classes
        self.num_source_domains = len(cfg.DATASET.SOURCE_DOMAINS) or (
            max((d.domain for d in dataset.train_x), default=0) + 1)
        self.lab2cname = dataset.lab2cname
        if cfg.VERBOSE:
            self.show_dataset_summary(cfg)

    def show_dataset_summary(self, cfg):
        rows = [
            ("Dataset", cfg.DATASET.NAME),
            ("# classes", f"{self.num_classes:,}"),
            ("# train_x", f"{len(self.dataset.train_x):,}"),
        ]
        if self.dataset.train_u:
            rows.append(("# train_u", f"{len(self.dataset.train_u):,}"))
        if self.dataset.val:
            rows.append(("# val", f"{len(self.dataset.val):,}"))
        rows.append(("# test", f"{len(self.dataset.test):,}"))
        width = max(len(k) for k, _ in rows) + 2
        print("***** Dataset statistics *****")
        for k, v in rows:
            print(f"  {k:<{width}} {v}")
