"""IVLP: independent vision-language deep prompting, and the base that
PromptSRC inherits (counterpart of fsvlm_tpu.trainers.ivlp, :51-196).

- the compute dtype, the prompt init and frozen state, and the split-eval
  functions (class text features once, then image logits);
- IVLP's own loss (:126-184): CE, or the focal loss with per-class alpha from
  DATASET.PER_CLASS_SHOTS; under USE_MIXUP the images are mixed before the
  student and teacher passes (the draws come in the batch as "perm" and
  "lam"; ``valid`` is not permuted); under USE_KD
  ``KD_ALPHA * loss + (1 - KD_ALPHA) * kd_loss(student, teacher, KD_T)``,
  the teacher being zero-shot CLIP: the frozen image tower on the (mixed)
  batch under ``torch.no_grad()`` (the JAX package's ``stop_gradient``)
  against text features of CUSTOM_TEMPLATES[DATASET.NAME] (default "a photo
  of a {}."), computed once at build in fp32; an optional SimCLR term on a
  second view ("img2").

Subclasses whose config node lacks a key get the JAX package's ``.get``
default (PromptSRC: no mixup, no KD).  Not ported: INT8_TEACHER (ROADMAP
A7), which raises instead of being ignored.
"""

import numpy as np
import torch

from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import encode_text_ids, l2_normalize
from ..models.clip.tokenizer import tokenize
from .backbone import clip_for_trainer
from .ivlp_family import build_vlp_frozen, init_vlp_params, vlp_image_features, vlp_text_features
from .losses import (
    cross_entropy,
    focal_alpha_from_shots,
    focal_loss,
    kd_loss,
    masked_acc,
    mixup_batch,
    mixup_criterion,
    nt_xent,
)
from .templates import CUSTOM_TEMPLATES


@TRAINER_REGISTRY.register()
class IVLP(SimpleTrainer):
    model_name = "VLPromptLearner"
    trainer_cfg_key = "IVLP"

    def build_model(self, clip):
        cfg, node = self.cfg, self.node
        self.clip = clip = clip_for_trainer(cfg, clip, self.device)
        self.frozen, pc = build_vlp_frozen(node, clip, self.classnames, cfg.SEED,
                                           cfg.MODEL.TEXT_TRUNCATE)
        init = init_vlp_params(node, clip.cfg, pc, np.random.RandomState(max(cfg.SEED, 0)))
        self.params = {k: v.to(self.device).requires_grad_() for k, v in init.items()}

        self.use_focal = bool(getattr(node, "USE_FOCAL_LOSS", False))
        alpha = None
        if self.use_focal and len(cfg.DATASET.PER_CLASS_SHOTS) > 0:
            alpha = focal_alpha_from_shots(cfg.DATASET.PER_CLASS_SHOTS, self.device)
        self.frozen["alpha"] = alpha
        self.simclr_alpha = float(getattr(node, "SIMCLR_ALPHA", 0.0))
        self.use_mixup = bool(getattr(node, "USE_MIXUP", False))
        self.mixup_alpha = float(getattr(node, "MIXUP_ALPHA", 1.0))
        self.use_kd = bool(getattr(node, "USE_KD", False))
        self.kd_alpha = float(getattr(node, "KD_ALPHA", 1.0))
        self.kd_T = float(getattr(node, "KD_T", 4.0))
        if self.use_kd and bool(getattr(node, "INT8_TEACHER", False)):
            raise NotImplementedError("INT8_TEACHER (the int8 KD teacher tower) is not ported "
                                      "yet (ROADMAP A7)")
        if self.use_kd:
            # zero-shot CLIP teacher text features, fp32 (encode_text_ids' default)
            template = CUSTOM_TEMPLATES.get(cfg.DATASET.NAME, "a photo of a {}.")
            ids = tokenize([template.format(c.replace("_", " ")) for c in self.classnames])
            with torch.no_grad():
                teacher_txt = encode_text_ids(clip, torch.from_numpy(ids).long().to(self.device),
                                              attn_impl=self.attn_impl)
            self.frozen["teacher_text"] = l2_normalize(teacher_txt)

    def _hard_loss(self, logits, labels, frozen, valid):
        if self.use_focal:
            return focal_loss(logits, labels, alpha=frozen["alpha"], valid=valid)
        return cross_entropy(logits, labels, valid=valid)

    def loss_fn(self, params, frozen, batch):
        images, labels, valid = batch["img"], batch["label"], batch.get("valid")
        dtype, impl = self.compute_dtype(), self.attn_impl
        logit_scale = torch.exp(frozen["clip"].logit_scale).float()

        if self.use_mixup:  # before the student and the teacher passes
            images, perm, lam = mixup_batch(images, batch["perm"], batch["lam"])
            labels_b = labels[perm]

        imf = l2_normalize(vlp_image_features(params, frozen, images, dtype, impl))
        txf = l2_normalize(vlp_text_features(params, frozen, dtype, impl))
        logits = logit_scale * imf @ txf.T

        if self.use_mixup:
            loss = mixup_criterion(lambda lg, y: self._hard_loss(lg, y, frozen, valid),
                                   logits, labels, labels_b, lam)
        else:
            loss = self._hard_loss(logits, labels, frozen, valid)

        if self.use_kd:
            loss = self.kd_alpha * loss + (1.0 - self.kd_alpha) * kd_loss(
                logits, self.teacher_logits(frozen, images), T=self.kd_T, valid=valid)

        if self.simclr_alpha > 0.0 and "img2" in batch:
            imf2 = l2_normalize(vlp_image_features(params, frozen, batch["img2"], dtype, impl))
            loss = loss + self.simclr_alpha * nt_xent(imf, imf2, valid=valid)
        return loss, {"acc": masked_acc(logits, labels, valid)}

    def teacher_logits(self, frozen, images):
        """The zero-shot CLIP teacher's logits for KD: the frozen image tower
        (no prompts) against the teacher text features, with no gradient."""
        with torch.no_grad():
            zs_img = l2_normalize(vlp_image_features({}, frozen, images, self.compute_dtype(),
                                                     self.attn_impl))
            return torch.exp(frozen["clip"].logit_scale).float() * zs_img @ frozen["teacher_text"].T

    # split eval: class text features once, then image logits per batch
    def text_features_fn(self, params, frozen):
        return l2_normalize(vlp_text_features(params, frozen, self.compute_dtype(),
                                              self.attn_impl))

    def image_logits_fn(self, params, frozen, images, txf):
        imf = l2_normalize(vlp_image_features(params, frozen, images, self.compute_dtype(),
                                              self.attn_impl))
        return torch.exp(frozen["clip"].logit_scale).float() * imf @ txf.T
