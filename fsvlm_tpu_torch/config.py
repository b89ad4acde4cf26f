"""The config keys that the ported train slices read (counterpart of
fsvlm_tpu.config.defaults, without the yacs tree and without yaml loading).

Defaults are fsvlm_tpu/config/defaults.py's, overlaid with the ViT-B/16
recipes: configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml
(OPTIM, INPUT, MODEL, DATALOADER and TRAINER.PROMPTSRC) and
configs/trainers/IVLP/vit_b16_c2_ep20_batch4_4+4ctx_kd.yaml (TRAINER.IVLP;
its other sections equal the PromptSRC recipe's), so that
``get_cfg_default()`` is either recipe.  TRAINER.COOP, TRAINER.COCOOP,
TRAINER.MAPLE, TRAINER.LINEAR_PROBE, TRAINER.PLIP and TRAINER.LORA keep defaults.py's
values; their recipes are the override lists in
``RECIPES``, applied with ``cfg.merge_from_list``, or the yaml files
themselves, read with ``cfg.merge_from_file``.  ``get_cfg_base()`` is
defaults.py alone (the JAX package's ``get_cfg_default()``); the CLI
starts from it.
The nodes are plain mutable dataclasses with the yacs names
(``cfg.OPTIM.LR``, ``cfg.TRAINER.PROMPTSRC.N_CTX_TEXT``); set fields, or
merge a list or a file, to override.

``merge_from_file`` reads the yaml subset that the files under configs/ use,
without pyyaml (the card's machine has none): nested block maps, plain,
single- and double-quoted scalars typed as PyYAML's safe loader types them
(YAML 1.1: ints, floats with a dot, true/false/yes/no/on/off, null and ~),
inline ``[...]`` lists of scalars and ``#`` comments.  Anything else (block
lists, anchors, tags, flow maps, multi-line scalars, documents) raises
ValueError.
"""

import ast
import dataclasses
import re
from dataclasses import field
from typing import List, Tuple

from .ops.preprocess import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD


@dataclasses.dataclass
class OptimConfig:
    NAME: str = "sgd"  # yaml (defaults.py: adam)
    LR: float = 0.0025  # yaml
    WEIGHT_DECAY: float = 5e-4
    MOMENTUM: float = 0.9
    SGD_DAMPNING: int = 0  # read by no optimizer, as in the JAX package
    SGD_NESTEROV: bool = False
    RMSPROP_ALPHA: float = 0.99
    ADAM_BETA1: float = 0.9
    ADAM_BETA2: float = 0.999
    LR_SCHEDULER: str = "cosine"  # yaml
    STEPSIZE: Tuple[int, ...] = (-1,)
    GAMMA: float = 0.1
    MAX_EPOCH: int = 20  # yaml
    WARMUP_EPOCH: int = 1  # yaml
    WARMUP_TYPE: str = "constant"  # yaml
    WARMUP_CONS_LR: float = 1e-5  # yaml
    WARMUP_MIN_LR: float = 1e-5
    WARMUP_RECOUNT: bool = True
    # staged LR (build_optimizer's param_labels/lr_mult): read by nothing, as
    # in the JAX package, whose zoo passes neither
    STAGED_LR: bool = False
    NEW_LAYERS: Tuple[str, ...] = ()
    BASE_LR_MULT: float = 0.1


@dataclasses.dataclass
class InputConfig:
    SIZE: Tuple[int, int] = (224, 224)
    INTERPOLATION: str = "bicubic"  # yaml (defaults.py: bilinear)
    TRANSFORMS: Tuple[str, ...] = ("random_resized_crop", "random_flip", "normalize")  # yaml
    NO_TRANSFORM: bool = False
    RRCROP_SCALE: Tuple[float, float] = (0.08, 1.0)
    PIXEL_MEAN: List[float] = field(default_factory=lambda: list(CLIP_PIXEL_MEAN))  # yaml
    PIXEL_STD: List[float] = field(default_factory=lambda: list(CLIP_PIXEL_STD))  # yaml
    # the host train transforms' settings (data/transforms.py)
    CROP_PADDING: int = 4
    CUTOUT_N: int = 1
    CUTOUT_LEN: int = 16
    GN_MEAN: float = 0.0
    GN_STD: float = 0.15
    RANDAUGMENT_N: int = 2
    RANDAUGMENT_M: int = 10
    COLORJITTER_B: float = 0.4
    COLORJITTER_C: float = 0.4
    COLORJITTER_S: float = 0.4
    COLORJITTER_H: float = 0.1
    RGS_P: float = 0.2
    GB_P: float = 0.5
    GB_K: int = 21


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
    LABEL_SCOPE: str = "default"  # "all" or "default"; read by no trainer, as in the JAX package
    LOSS_TYPE: str = "ce"
    SIMCLR_ALPHA: float = 0.0
    USE_GPA: bool = True
    LOGITS_LOSS_WEIGHT: float = 1.0
    # the frozen teacher's image features precomputed once over the eval view
    # of every train item, read per step instead of the teacher image pass
    CACHED_TEACHER: bool = False
    # the per-step teacher image pass on an int8 copy of the image tower
    # (ops/quant.py); off under CACHED_TEACHER
    INT8_TEACHER: bool = False


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
class MaPLeConfig:
    N_CTX: int = 2
    CTX_INIT: str = "a photo of a"
    PREC: str = "fp16"
    PROMPT_DEPTH: int = 9
    USE_FOCAL_LOSS: bool = False


@dataclasses.dataclass
class LinearProbeConfig:
    LOSS_TYPE: str = "ce"  # ce or focal
    USE_BIAS: bool = True


@dataclasses.dataclass
class PLIPConfig:
    N_CTX_VISION: int = 0  # read by no trainer, as in the JAX package
    N_CTX_TEXT: int = 4
    CTX_INIT: str = "a photo of a"
    PREC: str = "fp16"
    PROMPT_DEPTH_VISION: int = 0  # read by no trainer
    PROMPT_DEPTH_TEXT: int = 0  # read by no trainer
    REG_COEFF: float = 0.01
    K: int = 1  # the gradient norm each ctx token is pulled toward (grad)
    REG_TYPE: str = "grad"  # grad / svd / spectral_norm


@dataclasses.dataclass
class LoRAConfig:
    N_CTX_VISION: int = 2
    N_CTX_TEXT: int = 2  # the fixed text prompts' context length
    CTX_INIT: str = "a photo of a"
    PREC: str = "fp16"
    PROMPT_DEPTH_VISION: int = 9
    PROMPT_DEPTH_TEXT: int = 9
    ENCODER: str = "both"  # text / vision / both
    POSITION: str = "all"  # bottom/mid/up/half-up/half-bottom/all/top3 (trainers/lora.py)
    PARAMS: List[str] = field(default_factory=lambda: ["q", "k", "v"])
    R: int = 2
    ALPHA: int = 1
    DROPOUT_RATE: float = 0.25
    TEXT_LOSS_WEIGHT: float = 25.0
    IMAGE_LOSS_WEIGHT: float = 10.0
    LOGITS_LOSS_WEIGHT: float = 1.0


# the Dassl zoo's trainer nodes (defaults.py:322-387, Dassl's defaults); the
# DA and SSL trainers that read some of them come in later slices
def _node(name, **fields):
    return dataclasses.make_dataclass(
        name, [(k, type(v), field(default=v)) for k, v in fields.items()])


MCDConfig = _node("MCDConfig", N_STEP_F=4)
MMEConfig = _node("MMEConfig", LMDA=0.1)
CDACConfig = _node("CDACConfig", CLASS_LR_MULTI=10, RAMPUP_COEF=30, RAMPUP_ITRS=1000,
                   TOPK_MATCH=5, P_THRESH=0.95, STRONG_TRANSFORMS=())
SEConfig = _node("SEConfig", EMA_ALPHA=0.999, CONF_THRE=0.95, RAMPUP=300)
M3SDAConfig = _node("M3SDAConfig", LMDA=0.5, N_STEP_F=4)
DAELConfig = _node("DAELConfig", WEIGHT_U=0.5, CONF_THRE=0.95, STRONG_TRANSFORMS=())
CrossGradConfig = _node("CrossGradConfig", EPS_F=1.0, EPS_D=1.0, ALPHA_F=0.5, ALPHA_D=0.5)
DDAIGConfig = _node("DDAIGConfig", G_ARCH="", LMDA=0.3, CLAMP=False, CLAMP_MIN=-1.0,
                    CLAMP_MAX=1.0, WARMUP=0, ALPHA=0.5)
DAELDGConfig = _node("DAELDGConfig", WEIGHT_U=0.5, CONF_THRE=0.95, STRONG_TRANSFORMS=())
DomainMixConfig = _node("DomainMixConfig", TYPE="crossdomain", ALPHA=1.0, BETA=1.0)
EntMinConfig = _node("EntMinConfig", LMDA=1e-3)
MeanTeacherConfig = _node("MeanTeacherConfig", WEIGHT_U=1.0, EMA_ALPHA=0.999, RAMPUP=5)
MixMatchConfig = _node("MixMatchConfig", WEIGHT_U=100.0, TEMP=2.0, MIXUP_BETA=0.75,
                       RAMPUP=20000)
FixMatchConfig = _node("FixMatchConfig", WEIGHT_U=1.0, CONF_THRE=0.95, STRONG_TRANSFORMS=())
ZOO_NODES = {"MCD": MCDConfig, "MME": MMEConfig, "CDAC": CDACConfig, "SE": SEConfig,
             "M3SDA": M3SDAConfig, "DAEL": DAELConfig, "CROSSGRAD": CrossGradConfig,
             "DDAIG": DDAIGConfig, "DAELDG": DAELDGConfig, "DOMAINMIX": DomainMixConfig,
             "ENTMIN": EntMinConfig, "MEANTEACHER": MeanTeacherConfig,
             "MIXMATCH": MixMatchConfig, "FIXMATCH": FixMatchConfig}


@dataclasses.dataclass
class TrainerConfig:
    NAME: str = ""
    PROMPTSRC: PromptSRCConfig = field(default_factory=PromptSRCConfig)
    IVLP: IVLPConfig = field(default_factory=IVLPConfig)
    COOP: CoOpConfig = field(default_factory=CoOpConfig)
    COCOOP: CoCoOpConfig = field(default_factory=CoCoOpConfig)
    MAPLE: MaPLeConfig = field(default_factory=MaPLeConfig)
    LINEAR_PROBE: LinearProbeConfig = field(default_factory=LinearProbeConfig)
    PLIP: PLIPConfig = field(default_factory=PLIPConfig)
    LORA: LoRAConfig = field(default_factory=LoRAConfig)
    MCD: MCDConfig = field(default_factory=MCDConfig)
    MME: MMEConfig = field(default_factory=MMEConfig)
    CDAC: CDACConfig = field(default_factory=CDACConfig)
    SE: SEConfig = field(default_factory=SEConfig)
    M3SDA: M3SDAConfig = field(default_factory=M3SDAConfig)
    DAEL: DAELConfig = field(default_factory=DAELConfig)
    CROSSGRAD: CrossGradConfig = field(default_factory=CrossGradConfig)
    DDAIG: DDAIGConfig = field(default_factory=DDAIGConfig)
    DAELDG: DAELDGConfig = field(default_factory=DAELDGConfig)
    DOMAINMIX: DomainMixConfig = field(default_factory=DomainMixConfig)
    ENTMIN: EntMinConfig = field(default_factory=EntMinConfig)
    MEANTEACHER: MeanTeacherConfig = field(default_factory=MeanTeacherConfig)
    MIXMATCH: MixMatchConfig = field(default_factory=MixMatchConfig)
    FIXMATCH: FixMatchConfig = field(default_factory=FixMatchConfig)


@dataclasses.dataclass
class BackboneConfig:
    NAME: str = "ViT-B/16"  # yaml
    PRETRAINED: bool = True  # load weights (trainers/backbone.py); False: random from SEED


@dataclasses.dataclass
class HeadConfig:
    """The zoo's MLP head after the backbone (models/simple_net.py)."""
    NAME: str = ""
    HIDDEN_LAYERS: Tuple[int, ...] = ()
    ACTIVATION: str = "relu"
    BN: bool = True
    DROPOUT: float = 0.0


@dataclasses.dataclass
class ModelConfig:
    INIT_WEIGHTS: str = ""  # a checkpoint whose state_dict initializes the prompts
    BACKBONE: BackboneConfig = field(default_factory=BackboneConfig)
    FROZEN_DTYPE: str = "fp32"
    TEXT_TRUNCATE: bool = True
    # test() and serving on an int8 copy of the ViT image tower (ops/quant.py;
    # the engine's frozen_eval): the GEMM families to quantize, and static
    # activation scales calibrated over that many eval batches at first use
    QUANT_INT8: bool = False
    QUANT_INT8_FAMILIES: List[str] = field(default_factory=lambda: ["attn", "mlp"])
    QUANT_INT8_STATIC: bool = False
    QUANT_INT8_CALIB_BATCHES: int = 4
    HEAD: HeadConfig = field(default_factory=HeadConfig)


@dataclasses.dataclass
class TrainXConfig:
    SAMPLER: str = "RandomSampler"
    BATCH_SIZE: int = 4  # yaml
    N_DOMAIN: int = 0
    N_INS: int = 16


@dataclasses.dataclass
class TrainUConfig:
    SAME_AS_X: bool = True
    SAMPLER: str = "RandomSampler"
    BATCH_SIZE: int = 32
    N_DOMAIN: int = 0
    N_INS: int = 16


@dataclasses.dataclass
class TestLoaderConfig:
    SAMPLER: str = "SequentialSampler"
    BATCH_SIZE: int = 100  # yaml (defaults.py: 32)


@dataclasses.dataclass
class DataLoaderConfig:
    NUM_WORKERS: int = 8  # yaml (defaults.py: 4); host decode threads
    K_TRANSFORMS: int = 1  # train views per item (stacked on a view axis past 1)
    RETURN_IMG0: bool = False  # the eval view beside the train view, as "img0"
    TRAIN_X: TrainXConfig = field(default_factory=TrainXConfig)
    TRAIN_U: TrainUConfig = field(default_factory=TrainUConfig)
    TEST: TestLoaderConfig = field(default_factory=TestLoaderConfig)
    DEVICE_AUG: bool = False
    PRE_SIZE: int = 256  # the train cache's image size under DEVICE_AUG
    # the train set as one uint8 cache on the device: auto (when it fits the
    # budget), on (required), off (uint8 batches from the loader every step)
    DEVICE_RESIDENT: str = "auto"
    DEVICE_RESIDENT_BUDGET_MB: int = 2048


@dataclasses.dataclass
class TrainConfig:
    CHECKPOINT_FREQ: int = 0  # also save every this many epochs (the last always)
    PRINT_FREQ: int = 20  # yaml (defaults.py: 10)
    # the zoo's train_x + train_u epochs: steps of train_x, train_u or smaller_one
    COUNT_ITER: str = "train_x"
    # checkpoint each transformer layer in the backward (CoCoOp's text passes)
    REMAT: bool = False
    # auto | on | off: run an epoch over the device-resident train set as
    # replays of one captured step (engine/trainer.py); auto defers to a
    # trainer's veto
    EPOCH_FUSE: str = "auto"
    # with the fused epoch, build its schedule on the device from a
    # generator seeded from (SEED, epoch) (Random/Sequential samplers only)
    DEVICE_SCHEDULE: bool = False


@dataclasses.dataclass
class TestConfig:
    EVALUATOR: str = "Classification"  # the only evaluator; another name raises
    PER_CLASS_RESULT: bool = False
    COMPUTE_CMAT: bool = False  # kept on the evaluator as ``cmat`` (no OUTPUT_DIR here)
    NO_TEST: bool = False
    SPLIT: str = "test"
    FINAL_MODEL: str = "last_step"  # or best_val


@dataclasses.dataclass
class DatasetConfig:
    ROOT: str = ""
    NAME: str = ""  # the dataset, and the KD teacher's template (trainers/templates.py)
    SOURCE_DOMAINS: Tuple[str, ...] = ()
    TARGET_DOMAINS: Tuple[str, ...] = ()
    NUM_LABELED: int = -1  # the SSL sets' labeled images (data/datasets/legacy.py)
    NUM_SHOTS: int = -1
    VAL_PERCENT: float = 0.1
    ALL_AS_UNLABELED: bool = False  # the SSL sets: train_x joins train_u too
    STL10_FOLD: int = -1  # -1: all 5000 labeled STL-10 images; else fold_indices.txt's row
    CIFAR_C_TYPE: str = ""  # CIFAR10C / CIFAR100C: the corruption
    CIFAR_C_LEVEL: int = 1  # and its severity, 1-5
    SUBSAMPLE_CLASSES: str = "all"  # all, base or new
    PER_CLASS_SHOTS: List[int] = field(default_factory=list)  # when NUM_SHOTS < 0


@dataclasses.dataclass
class Config:
    VERSION: int = 1
    OUTPUT_DIR: str = "./output"
    RESUME: str = ""
    SEED: int = -1
    USE_CUDA: bool = True  # kept for config compatibility; ignored (the device is --device's)
    VERBOSE: bool = True
    OPTIM: OptimConfig = field(default_factory=OptimConfig)
    INPUT: InputConfig = field(default_factory=InputConfig)
    TRAINER: TrainerConfig = field(default_factory=TrainerConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    DATALOADER: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)

    def __str__(self):
        """The yacs tree print (cfgnode.py:124-137): keys sorted, nodes
        indented."""
        return _node_str(self)

    def merge_from_file(self, path):
        """Merge a yaml file of the subset described above; an unknown key
        raises KeyError, as ``merge_from_list`` does."""
        with open(path) as f:
            tree = parse_yaml(f.read(), path)
        self.merge_from_list([v for kv in _flatten(tree) for v in kv])

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


def _node_str(node):
    lines = []
    for name in sorted(f.name for f in dataclasses.fields(node)):
        value = getattr(node, name)
        if dataclasses.is_dataclass(value):
            lines.append(f"{name}:")
            lines.extend("  " + ln for ln in _node_str(value).split("\n"))
        else:
            lines.append(f"{name}: {value}")
    return "\n".join(lines)


def _flatten(tree, prefix=""):
    """(dotted key, value) for every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ------------------------------------------------------------- yaml subset
# PyYAML's implicit resolvers for plain scalars (yaml/resolver.py,
# constructor.py), less the sexagesimal forms, which raise
_YAML_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_YAML_INT_BASE = re.compile(r"[-+]?0(b[0-1_]+|x[0-9a-fA-F_]+|[0-7_]+)")
_YAML_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?|\.[0-9][0-9_]*([eE][-+][0-9]+)?")
_YAML_INF = re.compile(r"([-+]?)\.(inf|Inf|INF)")
_YAML_NAN = re.compile(r"\.(nan|NaN|NAN)")
_YAML_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?")


def _yaml_error(path, lineno, msg):
    return ValueError(f"{path}:{lineno}: {msg} (not in the yaml subset that merge_from_file reads)")


def _plain_scalar(text, path, lineno):
    if text in _YAML_NULL:
        return None
    if text.lower() in _YAML_BOOL and text in (text.lower(), text.capitalize(), text.upper()):
        return _YAML_BOOL[text.lower()]
    sign = -1 if text.startswith("-") else 1
    if _YAML_INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _YAML_INT_BASE.fullmatch(text):
        body = text.replace("_", "").lstrip("+-")
        base = {"b": 2, "x": 16}.get(body[1], 8)
        return sign * int(body if base == 8 else body[2:], base)
    if _YAML_FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    m = _YAML_INF.fullmatch(text)
    if m:
        return float(m.group(1) + "inf")
    if _YAML_NAN.fullmatch(text):
        return float("nan")
    if _YAML_SEXAGESIMAL.fullmatch(text):
        raise _yaml_error(path, lineno, f"sexagesimal number {text!r}")
    if text[0] in "&*!|>%@`{}[],#'\"" or text.startswith(("- ", "? ")) or text == "-" \
            or ": " in text or text.endswith(":") or " #" in text:
        raise _yaml_error(path, lineno, f"unsupported scalar {text!r}")
    return text


def _quoted(text, i, path, lineno):
    """The quoted scalar starting at text[i]; returns (value, end index)."""
    q, out, i = text[i], [], i + 1
    escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0"}
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            if text[i + 1:i + 2] not in escapes:
                raise _yaml_error(path, lineno, f"escape {text[i:i + 2]!r}")
            out.append(escapes[text[i + 1]])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise _yaml_error(path, lineno, "unterminated or multi-line quoted scalar")


def _strip_comment(text, path, lineno):
    """``text`` without a trailing ``#`` comment (one outside quotes)."""
    i, in_q = 0, None
    while i < len(text):
        c = text[i]
        if in_q is None and c in "'\"" and (i == 0 or text[i - 1] in " [,:"):
            _, i = _quoted(text, i, path, lineno)
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _value(text, path, lineno):
    """A scalar or an inline list of scalars."""
    if text[:1] in "'\"":
        value, end = _quoted(text, 0, path, lineno)
        if text[end:].strip():
            raise _yaml_error(path, lineno, f"text after a quoted scalar: {text!r}")
        return value
    if text.startswith("["):
        if not text.endswith("]"):
            raise _yaml_error(path, lineno, f"multi-line or unterminated list {text!r}")
        items, body, i = [], text[1:-1], 0
        while i < len(body):
            while i < len(body) and body[i] == " ":
                i += 1
            if i == len(body):
                break
            if body[i] in "'\"":
                value, i = _quoted(body, i, path, lineno)
            elif body[i] in "[{":
                raise _yaml_error(path, lineno, "nested flow collection")
            else:
                j = body.find(",", i)
                j = len(body) if j < 0 else j
                value, i = _plain_scalar(body[i:j].strip(), path, lineno), j
            items.append(value)
            while i < len(body) and body[i] == " ":
                i += 1
            if i < len(body):
                if body[i] != ",":
                    raise _yaml_error(path, lineno, f"bad list {text!r}")
                i += 1
        return items
    return _plain_scalar(text, path, lineno)


def parse_yaml(text, path="<string>"):
    """The nested dict that ``yaml.safe_load`` gives for ``text``, for the
    subset described in the module docstring ({} for an empty document,
    where PyYAML gives None)."""
    root = {}
    stack = [[None, root]]  # [indent, mapping] from the root down
    pending = None  # (indent, key, mapping) of a key with no value on its line
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw, path, lineno)
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body[0] == "\t":
            raise _yaml_error(path, lineno, "tab indentation")
        if body.startswith(("---", "...", "%")):
            raise _yaml_error(path, lineno, f"document marker {body!r}")
        if body.startswith("- ") or body == "-":
            raise _yaml_error(path, lineno, "block list")
        m = re.fullmatch(r"([^\s:'\"#]+):(?:\s+(.*))?", body)
        if m is None:
            raise _yaml_error(path, lineno, f"not a 'KEY: value' line: {body!r}")
        key = _plain_scalar(m.group(1), path, lineno)
        if not isinstance(key, str):
            raise _yaml_error(path, lineno, f"key {m.group(1)!r} is not a string")
        if pending is not None and indent > pending[0]:
            pending[2][pending[1]] = {}
            stack.append([indent, pending[2][pending[1]]])
        pending = None
        if stack[0][0] is None:
            stack[0][0] = indent
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise _yaml_error(path, lineno, "inconsistent indentation")
        parent = stack[-1][1]
        if key in parent:
            raise _yaml_error(path, lineno, f"duplicate key {key!r}")
        rest = (m.group(2) or "").strip()
        parent[key] = _value(rest, path, lineno) if rest else None
        if not rest:
            pending = (indent, key, parent)
    return root


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


# defaults.py's values of the keys that the recipe overlay above sets
_DEFAULTS_PY = [
    "OPTIM.NAME", "adam",
    "OPTIM.LR", 0.0003,
    "OPTIM.LR_SCHEDULER", "single_step",
    "OPTIM.MAX_EPOCH", 10,
    "OPTIM.WARMUP_EPOCH", -1,
    "OPTIM.WARMUP_TYPE", "linear",
    "INPUT.INTERPOLATION", "bilinear",
    "INPUT.TRANSFORMS", (),
    "INPUT.PIXEL_MEAN", [0.485, 0.456, 0.406],
    "INPUT.PIXEL_STD", [0.229, 0.224, 0.225],
    "TRAINER.PROMPTSRC.PREC", "fp16",
    "TRAINER.IVLP.N_CTX_VISION", 2,
    "TRAINER.IVLP.N_CTX_TEXT", 2,
    "TRAINER.IVLP.PREC", "fp16",
    "TRAINER.IVLP.USE_MIXUP", True,
    "MODEL.BACKBONE.NAME", "",
    "DATALOADER.NUM_WORKERS", 4,
    "DATALOADER.TRAIN_X.BATCH_SIZE", 32,
    "DATALOADER.TEST.BATCH_SIZE", 32,
    "TRAIN.PRINT_FREQ", 10,
]


def get_cfg_base():
    """A fresh config equal to defaults.py, without the recipe overlay: the
    JAX package's ``get_cfg_default()``.  The CLI starts from it, as the JAX
    package's train.py does, so that a yaml file that leaves a key unset
    gives the same config in both packages."""
    cfg = Config()
    cfg.merge_from_list(_DEFAULTS_PY)
    return cfg


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
