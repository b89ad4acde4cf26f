"""The config keys that the ported train slices read (counterpart of
fsvlm_tpu.config.defaults, without the yacs tree and without yaml loading).

Defaults are fsvlm_tpu/config/defaults.py's, overlaid with the ViT-B/16
recipes: configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml
(OPTIM, INPUT, MODEL, DATALOADER and TRAINER.PROMPTSRC) and
configs/trainers/IVLP/vit_b16_c2_ep20_batch4_4+4ctx_kd.yaml (TRAINER.IVLP;
its other sections equal the PromptSRC recipe's), so that
``get_cfg_default()`` is either recipe.  The nodes are plain mutable
dataclasses with the yacs names (``cfg.OPTIM.LR``,
``cfg.TRAINER.PROMPTSRC.N_CTX_TEXT``); set fields to override.
"""

import dataclasses
from dataclasses import field
from typing import List, Tuple

from .ops.preprocess import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD


@dataclasses.dataclass
class OptimConfig:
    NAME: str = "sgd"  # yaml (defaults.py: adam)
    LR: float = 0.0025  # yaml
    WEIGHT_DECAY: float = 5e-4
    MOMENTUM: float = 0.9
    SGD_NESTEROV: bool = False
    LR_SCHEDULER: str = "cosine"  # yaml
    STEPSIZE: Tuple[int, ...] = (-1,)
    GAMMA: float = 0.1
    MAX_EPOCH: int = 20  # yaml
    WARMUP_EPOCH: int = 1  # yaml
    WARMUP_TYPE: str = "constant"  # yaml
    WARMUP_CONS_LR: float = 1e-5  # yaml
    WARMUP_MIN_LR: float = 1e-5
    WARMUP_RECOUNT: bool = True


@dataclasses.dataclass
class InputConfig:
    SIZE: Tuple[int, int] = (224, 224)
    RRCROP_SCALE: Tuple[float, float] = (0.08, 1.0)
    PIXEL_MEAN: List[float] = field(default_factory=lambda: list(CLIP_PIXEL_MEAN))  # yaml
    PIXEL_STD: List[float] = field(default_factory=lambda: list(CLIP_PIXEL_STD))  # yaml


@dataclasses.dataclass
class PromptSRCConfig:
    N_CTX_VISION: int = 4
    N_CTX_TEXT: int = 4
    CTX_INIT: str = "a photo of a"
    PREC: str = "bf16"  # yaml (defaults.py: fp16)
    PROMPT_DEPTH_VISION: int = 9
    PROMPT_DEPTH_TEXT: int = 9
    TEXT_LOSS_WEIGHT: float = 25.0
    IMAGE_LOSS_WEIGHT: float = 10.0
    GPA_MEAN: float = 15
    GPA_STD: float = 1
    LOSS_TYPE: str = "ce"
    SIMCLR_ALPHA: float = 0.0
    USE_GPA: bool = True
    LOGITS_LOSS_WEIGHT: float = 1.0


@dataclasses.dataclass
class IVLPConfig:
    N_CTX_VISION: int = 4  # _kd yaml (defaults.py: 2)
    N_CTX_TEXT: int = 4  # _kd yaml (defaults.py: 2)
    CTX_INIT: str = "a photo of a"
    PREC: str = "bf16"  # _kd yaml (defaults.py: fp16)
    PROMPT_DEPTH_VISION: int = 9
    PROMPT_DEPTH_TEXT: int = 9
    USE_FOCAL_LOSS: bool = False
    SIMCLR_ALPHA: float = 0.0
    USE_MIXUP: bool = False  # _kd yaml (defaults.py: True)
    MIXUP_ALPHA: float = 1.0
    USE_KD: bool = True
    KD_TEACHER_MODEL: str = "resnet50"  # read by no trainer: the teacher is zero-shot CLIP
    KD_ALPHA: float = 1.0
    KD_T: float = 4.0
    INT8_TEACHER: bool = False


@dataclasses.dataclass
class TrainerConfig:
    PROMPTSRC: PromptSRCConfig = field(default_factory=PromptSRCConfig)
    IVLP: IVLPConfig = field(default_factory=IVLPConfig)


@dataclasses.dataclass
class BackboneConfig:
    NAME: str = "ViT-B/16"  # yaml
    PRETRAINED: bool = True  # load weights (trainers/backbone.py); False: random from SEED


@dataclasses.dataclass
class ModelConfig:
    BACKBONE: BackboneConfig = field(default_factory=BackboneConfig)
    FROZEN_DTYPE: str = "fp32"
    TEXT_TRUNCATE: bool = True


@dataclasses.dataclass
class TrainXConfig:
    BATCH_SIZE: int = 4  # yaml


@dataclasses.dataclass
class DataLoaderConfig:
    TRAIN_X: TrainXConfig = field(default_factory=TrainXConfig)
    DEVICE_AUG: bool = False


@dataclasses.dataclass
class DatasetConfig:
    NAME: str = ""  # picks the KD teacher's template (trainers/templates.py)
    PER_CLASS_SHOTS: List[int] = field(default_factory=list)


@dataclasses.dataclass
class Config:
    SEED: int = -1
    OPTIM: OptimConfig = field(default_factory=OptimConfig)
    INPUT: InputConfig = field(default_factory=InputConfig)
    TRAINER: TrainerConfig = field(default_factory=TrainerConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    DATALOADER: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)


def get_cfg_default():
    """A fresh config: defaults.py overlaid with the PromptSRC and IVLP
    ViT-B/16 recipes."""
    return Config()
