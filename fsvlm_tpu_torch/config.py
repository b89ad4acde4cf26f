"""The config keys that the ported train slices read (counterpart of
fsvlm_tpu.config.defaults, without the yacs tree and without yaml loading).

Defaults are fsvlm_tpu/config/defaults.py's, overlaid with the ViT-B/16
recipes: configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml
(OPTIM, INPUT, MODEL, DATALOADER and TRAINER.PROMPTSRC) and
configs/trainers/IVLP/vit_b16_c2_ep20_batch4_4+4ctx_kd.yaml (TRAINER.IVLP;
its other sections equal the PromptSRC recipe's), so that
``get_cfg_default()`` is either recipe.  TRAINER.COOP and TRAINER.COCOOP
keep defaults.py's values; their recipes are the override lists in
``RECIPES``, applied with ``cfg.merge_from_list`` (the port reads no yaml).
The nodes are plain mutable dataclasses with the yacs names
(``cfg.OPTIM.LR``, ``cfg.TRAINER.PROMPTSRC.N_CTX_TEXT``); set fields, or
merge a list, to override.
"""

import ast
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
class CoOpConfig:
    N_CTX: int = 16
    CSC: bool = False  # class-specific context
    CTX_INIT: str = ""
    PREC: str = "fp16"  # fp16, fp32, amp, bf16 (fp16 and amp compute in bf16 on the card)
    CLASS_TOKEN_POSITION: str = "end"  # middle / end / front
    USE_FOCAL_LOSS: bool = False
    LOSS_TYPE: str = "ce"  # ce, focal, simclr


@dataclasses.dataclass
class CoCoOpConfig:
    N_CTX: int = 16
    CTX_INIT: str = ""
    PREC: str = "fp16"
    USE_FOCAL_LOSS: bool = False
    # class-chunked text pass: 0 = auto (chunk only past BATCHED_TEXT_LIMIT),
    # > 0 forces that block size
    CLASS_CHUNK: int = 0


@dataclasses.dataclass
class TrainerConfig:
    PROMPTSRC: PromptSRCConfig = field(default_factory=PromptSRCConfig)
    IVLP: IVLPConfig = field(default_factory=IVLPConfig)
    COOP: CoOpConfig = field(default_factory=CoOpConfig)
    COCOOP: CoCoOpConfig = field(default_factory=CoCoOpConfig)


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
class TestLoaderConfig:
    BATCH_SIZE: int = 100  # yaml (defaults.py: 32)


@dataclasses.dataclass
class DataLoaderConfig:
    TRAIN_X: TrainXConfig = field(default_factory=TrainXConfig)
    TEST: TestLoaderConfig = field(default_factory=TestLoaderConfig)
    DEVICE_AUG: bool = False


@dataclasses.dataclass
class TrainConfig:
    # checkpoint each transformer layer in the backward (CoCoOp's text passes)
    REMAT: bool = False


@dataclasses.dataclass
class TestConfig:
    PER_CLASS_RESULT: bool = False
    COMPUTE_CMAT: bool = False  # kept on the evaluator as ``cmat`` (no OUTPUT_DIR here)
    NO_TEST: bool = False
    SPLIT: str = "test"


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
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)

    def merge_from_list(self, opts):
        """yacs' ``merge_from_list`` (fsvlm_tpu/config/cfgnode.py:93-111) on
        the dataclasses: ``opts`` alternates dotted keys and values.  A string
        value is decoded as yacs decodes one (a Python literal if it parses
        as one, YAML's true/false/null, else the string); each value is then
        typed like the field it sets, with yacs' coercions (list <-> tuple,
        int -> float, int <-> bool).  An unknown key raises KeyError, another
        type ValueError."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for full_key, value in zip(opts[0::2], opts[1::2]):
            *parents, leaf = full_key.split(".")
            node = self
            for name in parents + [leaf]:
                if not (dataclasses.is_dataclass(node)
                        and name in {f.name for f in dataclasses.fields(node)}):
                    raise KeyError(f"Non-existent config key: {full_key}")
                if name != leaf:
                    node = getattr(node, name)
            if dataclasses.is_dataclass(getattr(node, leaf)):
                raise KeyError(f"{full_key} is a config node, not a key")
            setattr(node, leaf, _coerce(getattr(node, leaf), _decode(value), full_key))


def _decode(value):
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    if value.lower() in ("null", "~"):
        return None
    return value


def _coerce(old, new, full_key):
    """cfgnode.py's _check_and_coerce."""
    old_t, new_t = type(old), type(new)
    if old is None or new is None or old_t is new_t:
        return new
    if isinstance(old, (tuple, list)) and isinstance(new, (tuple, list)):
        return old_t(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, int) and isinstance(new, float):
        return new
    if isinstance(old, bool) != isinstance(new, bool) and {old_t, new_t} <= {bool, int}:
        return bool(new)
    raise ValueError(f"Type mismatch ({old_t} vs {new_t}) for config key {full_key}: "
                     f"{old} vs {new}")


def get_cfg_default():
    """A fresh config: defaults.py overlaid with the PromptSRC and IVLP
    ViT-B/16 recipes."""
    return Config()


# The CoOp and CoCoOp ViT-B/16 recipes as override lists, key for key the
# yaml files named, less the keys the port does not have
# (DATALOADER.NUM_WORKERS, INPUT.INTERPOLATION, INPUT.TRANSFORMS,
# TRAIN.PRINT_FREQ): ``cfg.merge_from_list(RECIPES[name])``.
_VIT_B16_COMMON = [
    "DATALOADER.TEST.BATCH_SIZE", 100,
    "INPUT.SIZE", (224, 224),
    "INPUT.PIXEL_MEAN", [0.48145466, 0.4578275, 0.40821073],
    "INPUT.PIXEL_STD", [0.26862954, 0.26130258, 0.27577711],
    "OPTIM.NAME", "sgd",
    "OPTIM.LR", 0.002,
    "OPTIM.LR_SCHEDULER", "cosine",
    "OPTIM.WARMUP_EPOCH", 1,
    "OPTIM.WARMUP_TYPE", "constant",
    "OPTIM.WARMUP_CONS_LR", 0.00001,
    "MODEL.BACKBONE.NAME", "ViT-B/16",
]
RECIPES = {
    "configs/trainers/CoOp/vit_b16_ep50.yaml": _VIT_B16_COMMON + [
        "DATALOADER.TRAIN_X.BATCH_SIZE", 32,
        "OPTIM.MAX_EPOCH", 50,
        "TRAINER.COOP.N_CTX", 16,
        "TRAINER.COOP.CSC", False,
        "TRAINER.COOP.CLASS_TOKEN_POSITION", "end",
        "TRAINER.COOP.PREC", "bf16",
    ],
    "configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml": _VIT_B16_COMMON + [
        "DATALOADER.TRAIN_X.BATCH_SIZE", 1,
        "OPTIM.MAX_EPOCH", 10,
        "TRAINER.COCOOP.N_CTX", 4,
        "TRAINER.COCOOP.CTX_INIT", "",
        "TRAINER.COCOOP.PREC", "bf16",
    ],
}
