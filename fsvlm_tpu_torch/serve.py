"""PromptSRC serving on PyTorch: class text features once, then
uint8 images -> normalize -> image tower -> logits -> top-k.

Counterpart of the JAX package's serving path: ``IVLP.text_features_fn`` /
``image_logits_fn`` (trainers/ivlp.py:188-196; PromptSRC inherits them),
``SimpleTrainer.test``'s split eval (engine/trainer.py:688-708),
``tools/predict.py::predict`` (:52-93) and the checkpoints that
``SimpleTrainer.load_model`` reads (``engine/checkpoint.py``).  No yaml, no
PIL and no ``regex``: the config is a dataclass, images arrive as uint8
arrays.

    pred = PromptSRCPredictor(classnames)            # cuda, random ViT-B/16
    pred.load_model("output/run1")                   # JAX-written prompts
    pred.predict(images_u8, topk=5)                  # [[(name, prob), ...], ...]
"""

import dataclasses
import os

import numpy as np
import torch

from . import resolve_device
from .engine.checkpoint import coerce_prompt_params, load_checkpoint, resume_from_checkpoint
from .models.clip import l2_normalize
from .ops.preprocess import normalize_only
from .trainers.backbone import load_clip_backbone
from .trainers.ivlp_family import (
    build_vlp_frozen,
    init_vlp_params,
    vlp_image_features,
    vlp_text_features,
)


@dataclasses.dataclass(frozen=True)
class PromptSRCServeConfig:
    """The serving keys of TRAINER.PROMPTSRC, MODEL.TEXT_TRUNCATE and
    MODEL.FROZEN_DTYPE.  Defaults are the values of
    configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml, and of
    fsvlm_tpu/config/defaults.py for the two keys that file leaves unset."""

    N_CTX_TEXT: int = 4
    N_CTX_VISION: int = 4
    PROMPT_DEPTH_TEXT: int = 9
    PROMPT_DEPTH_VISION: int = 9
    CTX_INIT: str = "a photo of a"
    PREC: str = "bf16"
    TEXT_TRUNCATE: bool = True
    FROZEN_DTYPE: str = "fp32"


# ------------------------------------------------------------------ predictor
class PromptSRCPredictor:
    """Serves a PromptSRC (IVLP-family) prompt learner over frozen CLIP.

    classnames: the label space, in label order.
    clip: an already built CLIP module (``trainers.backbone``); else one is
      loaded for ``backbone`` (random weights from ``seed`` unless
      ``pretrained``), stored in ``node.FROZEN_DTYPE``.
    prompt_params: dict of prompt tensors; else ``init_vlp_params`` draws
      them from ``seed`` as the JAX trainer does.  ``load_model`` replaces
      them with a JAX-written checkpoint's.
    device: defaults to cuda.  Compute dtype is bf16 on CUDA and fp32 on
      the CPU (fp32 everywhere when node.PREC is "fp32").
    attn_impl: None (the hand-written kernel on CUDA) or "plain", for
      comparisons only.
    """

    model_name = "VLPromptLearner"

    def __init__(self, classnames, node=None, backbone="ViT-B/16", clip=None,
                 pretrained=False, prompt_params=None, seed=0, device=None,
                 attn_impl=None):
        self.device = resolve_device(device)
        self.node = node or PromptSRCServeConfig()
        if self.node.PREC not in ("fp16", "fp32", "amp", "bf16"):
            raise ValueError(f"Unknown PREC: {self.node.PREC}")
        self.classnames = list(classnames)
        if clip is None:
            clip = load_clip_backbone(backbone, pretrained, self.node.FROZEN_DTYPE,
                                      seed, self.device)
        if clip.logit_scale.device != self.device:
            raise ValueError(f"clip lies on {clip.logit_scale.device}, not {self.device}")
        self.clip = clip
        self.frozen, pc = build_vlp_frozen(self.node, clip, self.classnames, seed,
                                            self.node.TEXT_TRUNCATE)
        if prompt_params is None:
            prompt_params = init_vlp_params(self.node, clip.cfg, pc,
                                            np.random.RandomState(max(seed, 0)))
        self.prompt_params = {k: v.to(self.device) for k, v in prompt_params.items()}
        fp32 = self.node.PREC == "fp32" or self.device.type == "cpu"
        self.compute_dtype = torch.float32 if fp32 else torch.bfloat16
        self.attn_impl = attn_impl
        self._text_features = None

    def load_model(self, directory, epoch=None):
        """Load ``<directory>/VLPromptLearner/model-best.pkl`` (or
        ``model.pkl-<epoch>``; the ``checkpoint`` pointer when there is no
        best file)."""
        name = "model-best.pkl" if epoch is None else f"model.pkl-{epoch}"
        fdir = os.path.join(directory, self.model_name)
        path = os.path.join(fdir, name)
        if not os.path.exists(path) and epoch is None:
            ckpt = resume_from_checkpoint(fdir)
        else:
            ckpt = load_checkpoint(path)
        if ckpt is None:
            raise FileNotFoundError(f"No checkpoint under {directory}")
        print(f'Load model from "{directory}" (epoch {ckpt["epoch"]}, '
              f'val_result {ckpt.get("val_result")})')
        self.prompt_params = coerce_prompt_params(self.prompt_params, ckpt["state_dict"])
        self._text_features = None

    @torch.inference_mode()
    def text_features(self):
        """L2-normalized class text features (C, E) fp32; computed once."""
        if self._text_features is None:
            self._text_features = l2_normalize(vlp_text_features(
                self.prompt_params, self.frozen, self.compute_dtype, self.attn_impl))
        return self._text_features

    @torch.inference_mode()
    def image_features(self, images_u8):
        """uint8 (B, 224, 224, 3) images -> unnormalized (B, E) fp32 features."""
        images = torch.as_tensor(images_u8).to(self.device)
        return vlp_image_features(self.prompt_params, self.frozen, normalize_only(images),
                                  self.compute_dtype, self.attn_impl)

    @torch.inference_mode()
    def logits(self, image_features):
        """(B, C) fp32 logits; the logit scale is exponentiated in the frozen
        dtype, as the JAX serving step does."""
        scale = torch.exp(self.clip.logit_scale).float()
        return (scale * l2_normalize(image_features.float())) @ self.text_features().T

    def image_logits(self, images_u8):
        return self.logits(self.image_features(images_u8))

    def topk(self, logits, k=5):
        """Per row, the top-k (classname, probability), as tools/predict.py."""
        logits = logits.detach().cpu().double().numpy()
        k = min(k, len(self.classnames))
        probs = np.exp(logits - logits.max(1, keepdims=True))
        probs /= probs.sum(1, keepdims=True)
        top = np.argsort(-probs, axis=1)[:, :k]
        return [[(self.classnames[int(c)], float(pr[int(c)])) for c in row]
                for row, pr in zip(top, probs)]

    def predict(self, images_u8, topk=5):
        return self.topk(self.image_logits(images_u8), topk)
