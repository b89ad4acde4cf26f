"""IVLP: independent vision-language deep prompting, and the base that
PromptSRC inherits (counterpart of fsvlm_tpu.trainers.ivlp, :51-196).

- the compute dtype, the prompt init and frozen state, and the split-eval
  functions (class text features once, then image logits);
- IVLP's own loss (:126-184): CE, or the focal loss with per-class alpha from
  DATASET.PER_CLASS_SHOTS; under USE_MIXUP the images are mixed before the
  student and teacher passes (the draws come in the batch as "perm" and
  "lam"; ``valid`` is not permuted; across ranks the permutation is of the
  global batch and the partners come from every rank); under USE_KD
  ``KD_ALPHA * loss + (1 - KD_ALPHA) * kd_loss(student, teacher, KD_T)``,
  the teacher being zero-shot CLIP: the frozen image tower on the (mixed)
  batch under ``torch.no_grad()`` (the JAX package's ``stop_gradient``)
  against text features of CUSTOM_TEMPLATES[DATASET.NAME] (default "a photo
  of a {}."), computed once at build in fp32; an optional SimCLR term on a
  second view ("img2").

Under USE_KD and INT8_TEACHER (:95-116, :159-163) the KD teacher's image
pass runs on an int8 copy of the image tower (``ops/quant.py``, attn and
mlp GEMMs), built once at build: dynamic activation scales, or under
MODEL.QUANT_INT8_STATIC static ones calibrated over the first
QUANT_INT8_CALIB_BATCHES train batches (``int8_teacher_tower``).

Subclasses whose config node lacks a key get the JAX package's ``.get``
default (PromptSRC: no mixup, no KD).
"""

import numpy as np
import torch

from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import encode_image, encode_text_ids, l2_normalize
from ..models.clip.tokenizer import tokenize
from ..parallel import mesh
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
    data_parallel = True

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
        self.int8_teacher = self.use_kd and bool(getattr(node, "INT8_TEACHER", False))
        if self.use_kd:
            # zero-shot CLIP teacher text features, fp32 (encode_text_ids' default)
            template = CUSTOM_TEMPLATES.get(cfg.DATASET.NAME, "a photo of a {}.")
            ids = tokenize([template.format(c.replace("_", " ")) for c in self.classnames])
            with torch.no_grad():
                teacher_txt = encode_text_ids(clip, torch.from_numpy(ids).long().to(self.device),
                                              attn_impl=self.attn_impl)
            self.frozen["teacher_text"] = l2_normalize(teacher_txt)
        if self.int8_teacher:
            self.frozen["clip_teacher"] = self.int8_teacher_tower("[IVLP] int8 KD teacher")

    def int8_teacher_tower(self, label):
        """The frozen CLIP with its image tower in int8 (attn and mlp), for a
        no-grad teacher pass; static activation scales under
        MODEL.QUANT_INT8_STATIC, calibrated over the train loader's first
        batches as the step sees them.  Under DATALOADER.DEVICE_AUG that
        loader gives the raw uint8 PRE_SIZE cache views, which the JAX
        package calibrates on unnormalized (or fails on, at PRE_SIZE !=
        INPUT.SIZE): that combination raises ValueError (ROADMAP C.2)."""
        cfg = self.cfg
        if cfg.MODEL.QUANT_INT8_STATIC and cfg.DATALOADER.DEVICE_AUG:
            raise ValueError(
                f"MODEL.QUANT_INT8_STATIC with TRAINER.{self.trainer_cfg_key}.INT8_TEACHER under "
                "DATALOADER.DEVICE_AUG: the train loader gives raw uint8 PRE_SIZE views, not the "
                "normalized views the teacher sees; unset DEVICE_AUG or QUANT_INT8_STATIC")
        qclip, static = self.int8_image_tower(self.clip, ("attn", "mlp"), self.train_loader_x)
        print(f"{label} image tower (INT8_TEACHER, act={'static' if static else 'dynamic'})")
        return qclip

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
            labels_b = mesh.gather_rows(labels)[perm]

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
        (no prompts; its int8 copy under INT8_TEACHER) against the teacher
        text features, with no gradient."""
        dtype, impl = self.compute_dtype(), self.attn_impl
        with torch.no_grad():
            if self.int8_teacher:
                zs_img = encode_image(frozen["clip_teacher"], images, compute_dtype=dtype,
                                      attn_impl=impl)
            else:
                zs_img = vlp_image_features({}, frozen, images, dtype, impl)
            zs_img = l2_normalize(zs_img)
            return torch.exp(frozen["clip"].logit_scale).float() * zs_img @ frozen["teacher_text"].T

    # split eval: class text features once, then image logits per batch
    def text_features_fn(self, params, frozen):
        return l2_normalize(vlp_text_features(params, frozen, self.compute_dtype(),
                                              self.attn_impl))

    def image_logits_fn(self, params, frozen, images, txf):
        imf = l2_normalize(vlp_image_features(params, frozen, images, self.compute_dtype(),
                                              self.attn_impl))
        return torch.exp(frozen["clip"].logit_scale).float() * imf @ txf.T
