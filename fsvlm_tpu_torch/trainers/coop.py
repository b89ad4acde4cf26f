"""CoOp: context optimization (counterpart of fsvlm_tpu.trainers.coop).

Learnable text context vectors, unified or class-specific (CSC), with the
class token at the end, in the middle or at the front; frozen CLIP towers;
LOSS_TYPE ce, focal (alpha from DATASET.PER_CLASS_SHOTS; USE_FOCAL_LOSS turns
ce into focal) or simclr (the fork's NT-Xent over the logits of two views,
"img" and "img2"; across ranks over the global batch, ``losses.nt_xent``).
The trainable state is {"ctx"}; the text encoder runs over all n_cls
assembled prompts each step, and the image tower runs under
``torch.no_grad()`` (the JAX package's ``stop_gradient``).  Split eval: the
class text features once (``text_features_fn``), then image logits per
batch (``image_logits_fn``).
"""

import numpy as np
import torch

from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import clip_logits, encode_image, encode_text_embeds, l2_normalize
from .backbone import clip_for_trainer
from .losses import cross_entropy, focal_alpha_from_shots, focal_loss, masked_acc, nt_xent
from .prompts import assemble_prompts, build_prompt_context, prompt_tensors


@TRAINER_REGISTRY.register()
class CoOp(SimpleTrainer):
    model_name = "prompt_learner"
    trainer_cfg_key = "COOP"
    data_parallel = True

    def build_model(self, clip):
        cfg, tc = self.cfg, self.node
        self.clip = clip = clip_for_trainer(cfg, clip, self.device)
        pc = build_prompt_context(
            clip.text.token_embedding.detach().float().cpu().numpy(),
            self.classnames,
            n_ctx=tc.N_CTX,
            ctx_init=tc.CTX_INIT,
            class_token_position=tc.CLASS_TOKEN_POSITION,
            csc=tc.CSC,
            rng=np.random.RandomState(max(cfg.SEED, 0)),
            context_length=clip.cfg.context_length,
            truncate=bool(cfg.MODEL.TEXT_TRUNCATE),
        )
        print(f'Initial context: "{pc["prompt_prefix"]}"')
        print(f'Number of context words (tokens): {pc["n_ctx"]}')

        self.loss_type = tc.LOSS_TYPE
        if tc.USE_FOCAL_LOSS and self.loss_type == "ce":
            self.loss_type = "focal"
        alpha = None
        if self.loss_type == "focal" and len(cfg.DATASET.PER_CLASS_SHOTS) > 0:
            alpha = focal_alpha_from_shots(cfg.DATASET.PER_CLASS_SHOTS, self.device)

        self.params = {"ctx": torch.from_numpy(np.asarray(pc["init_ctx"], np.float32))
                       .to(self.device).requires_grad_()}
        self.frozen = {"clip": clip, **prompt_tensors(pc, self.device), "alpha": alpha}

    def text_features(self, params, frozen):
        prompts = assemble_prompts(params["ctx"], frozen["base_embed"], frozen["ctx_scatter"])
        return encode_text_embeds(frozen["clip"], prompts, frozen["eot_idx"],
                                  compute_dtype=self.compute_dtype(), attn_impl=self.attn_impl)

    def image_features(self, frozen, images):
        """The frozen image tower, with no gradient."""
        with torch.no_grad():
            return encode_image(frozen["clip"], images, compute_dtype=self.compute_dtype(),
                                attn_impl=self.attn_impl)

    def logits_fn(self, params, frozen, images):
        return clip_logits(self.image_features(frozen, images), self.text_features(params, frozen),
                           frozen["clip"].logit_scale)

    def loss_fn(self, params, frozen, batch):
        valid = batch.get("valid")
        if self.loss_type == "simclr":
            logits1 = self.logits_fn(params, frozen, batch["img"])
            logits2 = self.logits_fn(params, frozen, batch["img2"])
            return nt_xent(logits1, logits2, valid=valid), {}
        logits = self.logits_fn(params, frozen, batch["img"])
        if self.loss_type == "focal":
            loss = focal_loss(logits, batch["label"], alpha=frozen["alpha"], valid=valid)
        else:
            loss = cross_entropy(logits, batch["label"], valid=valid)
        return loss, {"acc": masked_acc(logits, batch["label"], valid)}

    # split eval: the class text features once per test(), then image logits
    def text_features_fn(self, params, frozen):
        return l2_normalize(self.text_features(params, frozen))

    def image_logits_fn(self, params, frozen, images, txf):
        imf = l2_normalize(self.image_features(frozen, images))
        return torch.exp(frozen["clip"].logit_scale).float() * imf @ txf.T
