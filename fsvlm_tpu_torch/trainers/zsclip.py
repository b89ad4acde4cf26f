"""Zero-shot CLIP baselines (counterpart of fsvlm_tpu.trainers.zsclip,
:24-92).

- ZeroshotCLIP: one hand-written template per dataset (CUSTOM_TEMPLATES of
  DATASET.NAME, "a photo of a {}." by default);
- ZeroshotCLIP2: prompt ensembling over IMAGENET_TEMPLATES_SELECT plus the
  dataset's template (except for ImageNet): the mean of the L2-normalized
  per-template text features, normalized again.

The class text features are computed once, at build, from the raw token
ids (no truncation), in the compute dtype; each batch then runs the image
tower alone.  Nothing is trainable: ``train()`` steps the loss without a
gradient, and there is nothing to save or restore.
"""

import torch

from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import encode_image, encode_text_ids, l2_normalize
from ..models.clip.tokenizer import tokenize
from .backbone import clip_for_trainer
from .losses import cross_entropy, masked_acc
from .templates import CUSTOM_TEMPLATES, IMAGENET_TEMPLATES_SELECT


@TRAINER_REGISTRY.register()
class ZeroshotCLIP(SimpleTrainer):
    model_name = "zsclip"

    def check_cfg(self, cfg):
        pass

    def compute_dtype(self):
        """bf16 on the card, fp32 on the CPU (no PREC key, as in JAX)."""
        return torch.float32 if self.device.type == "cpu" else torch.bfloat16

    def templates_for(self, cfg):
        return [CUSTOM_TEMPLATES.get(cfg.DATASET.NAME, "a photo of a {}.")]

    def build_model(self, clip):
        cfg = self.cfg
        self.clip = clip = clip_for_trainer(cfg, clip, self.device)
        templates = self.templates_for(cfg)
        print(f"Prompt ensembling (n={len(templates)})" if len(templates) > 1 else
              f"Prompts: {[templates[0].format(c) for c in self.classnames[:3]]} ...")
        mean_feats = 0.0
        with torch.no_grad():
            for temp in templates:
                ids = tokenize([temp.format(c.replace("_", " ")) for c in self.classnames])
                feats = encode_text_ids(clip, torch.from_numpy(ids).long().to(self.device),
                                        compute_dtype=self.compute_dtype(),
                                        attn_impl=self.attn_impl)
                mean_feats = mean_feats + l2_normalize(feats)
        self.params = {}
        self.frozen = {"clip": clip, "text_features": l2_normalize(mean_feats / len(templates))}

    def logits_fn(self, params, frozen, images):
        imf = l2_normalize(encode_image(frozen["clip"], images, compute_dtype=self.compute_dtype(),
                                        attn_impl=self.attn_impl))
        return torch.exp(frozen["clip"].logit_scale).float() * imf @ frozen["text_features"].T

    def loss_fn(self, params, frozen, batch):
        logits = self.logits_fn(params, frozen, batch["img"])
        valid = batch.get("valid")
        return (cross_entropy(logits, batch["label"], valid=valid),
                {"acc": masked_acc(logits, batch["label"], valid)})

    # nothing to persist or restore
    def save_model(self, *args, **kwargs):
        pass

    def resume_model_if_exist(self, directory):
        return 0

    def load_model(self, directory, epoch=None):
        print("Note that load_model() is skipped for zero-shot CLIP")


@TRAINER_REGISTRY.register()
class ZeroshotCLIP2(ZeroshotCLIP):
    """Prompt ensembling variant."""

    def templates_for(self, cfg):
        templates = list(IMAGENET_TEMPLATES_SELECT)
        if cfg.DATASET.NAME != "ImageNet":
            templates.append(CUSTOM_TEMPLATES.get(cfg.DATASET.NAME, "a photo of a {}."))
        return templates
