"""DataManager: the dataset and its loaders (counterpart of
fsvlm_tpu.data.data_manager, :16-153).

Builds the dataset named by DATASET.NAME (Synthetic, the 11 recognition
datasets and the 4 ImageNet shifts; the Dassl DA/DG/SSL sets are ROADMAP
A13), the train and eval transforms (or ``custom_tfm_train`` /
``custom_tfm_test``; under SEED >= 0 the train transform's shared rng is
``random.Random(SEED)``), then the loaders.  train_x: under
DATALOADER.DEVICE_AUG uint8 ``pre_size`` batches for the device-side
augmentation; else the host train transform through ``dataset_wrapper``
(default DatasetWrapper) with SEED's per-(item, visit) rngs,
DATALOADER.K_TRANSFORMS and RETURN_IMG0, shipping uint8 where the
transform's float stage is the trainer's normalization
(``TrainTransform.uint8_suffices``).  It drops the last short batch when
the set holds at least one batch.  val and test: padded uint8 batches of
the eval view.  Every sampler is seeded from SEED (unseeded when SEED <
0).  Prints the dataset summary table under VERBOSE.  No ported dataset
has an unlabeled split, so there is no train_u loader.
"""

import random

from ..utils.registry import Registry
from .loader import BatchLoader, DatasetWrapper, RawDatasetWrapper
from .samplers import build_sampler
from .transforms import build_transform

DATASET_REGISTRY = Registry("DATASET")


def build_dataset(cfg):
    if cfg.DATASET.NAME not in DATASET_REGISTRY:
        raise KeyError(
            f"Dataset {cfg.DATASET.NAME!r} is not ported: the Dassl domain-adaptation, "
            "domain-generalization and semi-supervised sets (data/datasets/legacy.py) are "
            "ROADMAP A13; ported: "
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

        x = cfg.DATALOADER.TRAIN_X
        sampler = build_sampler(x.SAMPLER, dataset.train_x, batch_size=x.BATCH_SIZE,
                                n_domain=x.N_DOMAIN, n_ins=x.N_INS, seed=seed)
        if cfg.DATALOADER.DEVICE_AUG:
            wrapper = RawDatasetWrapper(dataset.train_x, pre_size=cfg.DATALOADER.PRE_SIZE)
        else:
            uint8 = getattr(tfm_train, "uint8_suffices", lambda _: True)(cfg)
            wrapper = (dataset_wrapper or DatasetWrapper)(
                dataset.train_x, tfm_train, train=True,
                k_transforms=cfg.DATALOADER.K_TRANSFORMS,
                return_img0=cfg.DATALOADER.RETURN_IMG0, img0_transform=self.tfm_test,
                seed=seed, uint8=uint8)
        self.train_loader_x = BatchLoader(
            wrapper, sampler, x.BATCH_SIZE, drop_last=len(dataset.train_x) >= x.BATCH_SIZE,
            num_threads=threads)
        self.val_loader = eval_loader(dataset.val)
        self.test_loader = eval_loader(dataset.test)

        self.num_classes = dataset.num_classes
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
