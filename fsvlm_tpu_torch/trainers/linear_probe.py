"""Linear probe on frozen CLIP image features (counterpart of
fsvlm_tpu.trainers.linear_probe, :20-76).

A Linear(embed_dim, n_classes) head on the image tower's features, which
run under ``torch.no_grad()`` (JAX's ``stop_gradient``); USE_BIAS keeps the
bias (it is drawn either way, so the weight is the same); LOSS_TYPE ce, or
focal with alpha from PER_CLASS_SHOTS.  ``logits_fn`` returns the softmax
probabilities, as the reference's inference does (:58-61).  Parameters
"w" (embed_dim, n_classes) and "b", from ``_init_linear`` on
RandomState(SEED).
"""

import numpy as np
import torch

from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import encode_image
from .backbone import clip_for_trainer
from .cocoop import _init_linear
from .losses import cross_entropy, focal_alpha_from_shots, focal_loss, masked_acc


@TRAINER_REGISTRY.register()
class LinearProbeCLIP(SimpleTrainer):
    model_name = "linear_head"
    trainer_cfg_key = "LINEAR_PROBE"
    data_parallel = True

    def check_cfg(self, cfg):
        loss_type = cfg.TRAINER.LINEAR_PROBE.LOSS_TYPE
        if loss_type.lower() not in ("ce", "focal"):
            raise ValueError(f"Unknown LINEAR_PROBE.LOSS_TYPE: {loss_type}")

    def compute_dtype(self):
        """bf16 on the card, fp32 on the CPU (no PREC key, as in JAX)."""
        return torch.float32 if self.device.type == "cpu" else torch.bfloat16

    def build_model(self, clip):
        cfg, node = self.cfg, self.node
        n_cls = self.dm.num_classes if self.dm is not None else self.num_classes
        print(f"[LinearProbeCLIP] Detected num_classes: {n_cls}")
        self.clip = clip = clip_for_trainer(cfg, clip, self.device)
        w, b = _init_linear(np.random.RandomState(max(cfg.SEED, 0)), clip.cfg.embed_dim, n_cls)
        self.use_bias = bool(node.USE_BIAS)
        init = {"w": w, "b": b} if self.use_bias else {"w": w}
        self.params = {k: torch.from_numpy(v).to(self.device).requires_grad_()
                       for k, v in init.items()}
        self.loss_type = node.LOSS_TYPE.lower()
        alpha = None
        if self.loss_type == "focal" and len(cfg.DATASET.PER_CLASS_SHOTS) > 0:
            alpha = focal_alpha_from_shots(cfg.DATASET.PER_CLASS_SHOTS, self.device)
        self.frozen = {"clip": clip, "alpha": alpha}

    def head_logits(self, params, frozen, images):
        with torch.no_grad():
            feat = encode_image(frozen["clip"], images, compute_dtype=self.compute_dtype(),
                                attn_impl=self.attn_impl)
        logits = feat @ params["w"]
        return logits + params["b"] if self.use_bias else logits

    def logits_fn(self, params, frozen, images):
        return torch.softmax(self.head_logits(params, frozen, images), dim=-1)

    def loss_fn(self, params, frozen, batch):
        logits = self.head_logits(params, frozen, batch["img"])
        labels, valid = batch["label"], batch.get("valid")
        if self.loss_type == "focal":
            loss = focal_loss(logits, labels, alpha=frozen["alpha"], valid=valid)
        else:
            loss = cross_entropy(logits, labels, valid=valid)
        return loss, {"acc": masked_acc(logits, labels, valid)}
