"""The data layer (counterpart of fsvlm_tpu.data): datasets, few-shot
subsets, samplers, the train and eval transforms and the batch loaders,
numpy and the port's C++ (``native``) only."""

from .base_dataset import (
    DatasetBase,
    Datum,
    apply_fewshot_pipeline,
    generate_fewshot,
    generate_per_class_fewshot,
    read_and_split_data,
    read_split,
    save_split,
    subsample_classes,
)
from .data_manager import DATASET_REGISTRY, DataManager, build_dataset
from .loader import BatchLoader, DatasetWrapper, RawDatasetWrapper, register_synthetic_image
from .samplers import build_sampler
from .transforms import TestTransform, TrainTransform, build_transform

from . import datasets  # noqa: E402,F401  (populate DATASET_REGISTRY)
