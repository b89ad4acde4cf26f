"""IVLP, the independent vision-language prompting base that PromptSRC
inherits (counterpart of fsvlm_tpu.trainers.ivlp, :51-71, :118-119,
:186-196): the compute dtype, the prompt init and frozen state, and the
split-eval functions (class text features once, then image logits).

IVLP's own loss (CE or focal with mixup, KD and the int8 KD teacher) and its
config node are not ported: PromptSRC supplies ``loss_fn``.
"""

import numpy as np
import torch

from ..engine.trainer import SimpleTrainer
from ..models.clip import l2_normalize
from .backbone import load_clip_backbone
from .ivlp_family import build_vlp_frozen, init_vlp_params, vlp_image_features, vlp_text_features


class IVLP(SimpleTrainer):
    model_name = "VLPromptLearner"
    trainer_cfg_key = "IVLP"

    @property
    def node(self):
        return getattr(self.cfg.TRAINER, self.trainer_cfg_key)

    def check_cfg(self, cfg):
        if self.node.PREC not in ("fp16", "fp32", "amp", "bf16"):
            raise ValueError(f"Unknown PREC: {self.node.PREC}")

    def compute_dtype(self):
        """bf16 on the card unless PREC is fp32; fp32 on the CPU."""
        if self.node.PREC == "fp32" or self.device.type == "cpu":
            return torch.float32
        return torch.bfloat16

    def build_model(self, clip):
        cfg, node = self.cfg, self.node
        if clip is None:
            clip = load_clip_backbone(cfg.MODEL.BACKBONE.NAME, cfg.MODEL.BACKBONE.PRETRAINED,
                                      cfg.MODEL.FROZEN_DTYPE, cfg.SEED, self.device)
        if clip.logit_scale.device != self.device:
            raise ValueError(f"clip lies on {clip.logit_scale.device}, not {self.device}")
        self.clip = clip
        self.frozen, pc = build_vlp_frozen(node, clip, self.classnames, cfg.SEED,
                                           cfg.MODEL.TEXT_TRUNCATE)
        init = init_vlp_params(node, clip.cfg, pc, np.random.RandomState(max(cfg.SEED, 0)))
        self.params = {k: v.to(self.device).requires_grad_() for k, v in init.items()}
        self.frozen["alpha"] = None

    # split eval: class text features once, then image logits per batch
    def text_features_fn(self, params, frozen):
        return l2_normalize(vlp_text_features(params, frozen, self.compute_dtype(),
                                              self.attn_impl))

    def image_logits_fn(self, params, frozen, images, txf):
        imf = l2_normalize(vlp_image_features(params, frozen, images, self.compute_dtype(),
                                              self.attn_impl))
        return torch.exp(frozen["clip"].logit_scale).float() * imf @ txf.T
