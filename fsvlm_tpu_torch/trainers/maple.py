"""MaPLe: multi-modal prompt learning with coupled text->vision prompts
(counterpart of fsvlm_tpu.trainers.maple, :30-182).

- a shared text context ``ctx`` (N_CTX tokens, phrase init), projected to
  the vision width by ``proj`` into the vision tower's shallow prompts
  (ctx @ proj.w + proj.b);
- at PROMPT_DEPTH > 1, per-depth text prompts ``compound_text`` (depth-1,
  n_ctx, D) spliced into text layers 1..depth-1, each row projected by its
  own linear (``compound_proj``: w (depth-1, D, W), b (depth-1, W)) into
  the vision prompts of the same layers;
- CE, or focal (USE_FOCAL_LOSS, alpha from PER_CLASS_SHOTS);
- no remat (JAX :121, :147).

Parameters are flat keys of ``params`` ("ctx", "proj.w", "proj.b",
"compound_text", "compound_proj.w", "compound_proj.b"), the weights in the
JAX package's (in, out) layout, drawn from one numpy RandomState(SEED) in
its order: the prompt context, proj, compound_text, then each depth's
projection.  Split eval as CoOp: the class text features once, then image
logits per batch.
"""

import numpy as np
import torch

from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import VisionPrompts, encode_image, encode_text_embeds, l2_normalize
from .backbone import clip_for_trainer
from .cocoop import _init_linear
from .ivlp_family import _pad_deep
from .losses import cross_entropy, focal_alpha_from_shots, focal_loss, masked_acc
from .prompts import assemble_prompts, build_prompt_context, prompt_tensors


@TRAINER_REGISTRY.register()
class MaPLe(SimpleTrainer):
    model_name = "MultiModalPromptLearner"
    trainer_cfg_key = "MAPLE"

    def check_cfg(self, cfg):
        super().check_cfg(cfg)
        if cfg.TRAINER.MAPLE.PROMPT_DEPTH < 1:
            raise ValueError("MAPLE.PROMPT_DEPTH must be >= 1")

    def build_model(self, clip):
        cfg, node = self.cfg, self.node
        self.clip = clip = clip_for_trainer(cfg, clip, self.device)
        n_ctx = node.N_CTX
        depth = min(node.PROMPT_DEPTH, clip.cfg.transformer_layers)
        D, W = clip.cfg.transformer_width, clip.cfg.vision_width
        rng = np.random.RandomState(max(cfg.SEED, 0))
        pc = build_prompt_context(
            clip.text.token_embedding.detach().float().cpu().numpy(),
            self.classnames,
            n_ctx=n_ctx,
            ctx_init=node.CTX_INIT if n_ctx <= 4 else "",
            class_token_position="end",
            rng=rng,
            context_length=clip.cfg.context_length,
            init_keep_n_ctx=True,
            truncate=bool(cfg.MODEL.TEXT_TRUNCATE),
        )
        print("MaPLe design: Multi-modal Prompt Learning")
        print(f'Initial context: "{pc["prompt_prefix"]}"')
        print(f"Number of MaPLe context words (tokens): {pc['n_ctx']}")

        proj_w, proj_b = _init_linear(rng, D, W)
        init = {"ctx": pc["init_ctx"], "proj.w": proj_w, "proj.b": proj_b}
        if depth > 1:
            init["compound_text"] = rng.normal(0, 0.02, (depth - 1, n_ctx, D))
            ws, bs = zip(*(_init_linear(rng, D, W) for _ in range(depth - 1)))
            init["compound_proj.w"], init["compound_proj.b"] = np.stack(ws), np.stack(bs)
        self.params = {k: torch.from_numpy(np.asarray(v, np.float32)).to(self.device)
                       .requires_grad_() for k, v in init.items()}

        self.use_focal = bool(node.USE_FOCAL_LOSS)
        alpha = None
        if self.use_focal and len(cfg.DATASET.PER_CLASS_SHOTS) > 0:
            alpha = focal_alpha_from_shots(cfg.DATASET.PER_CLASS_SHOTS, self.device)
        self.frozen = {"clip": clip, **prompt_tensors(pc, self.device), "alpha": alpha}

    def text_features(self, params, frozen):
        clip = frozen["clip"]
        prompts = assemble_prompts(params["ctx"], frozen["base_embed"], frozen["ctx_scatter"])
        deep = flags = None
        if "compound_text" in params:
            deep, flags = _pad_deep(params["compound_text"], clip.cfg.transformer_layers)
        return encode_text_embeds(clip, prompts, frozen["eot_idx"], deep_prompts=deep,
                                  splice_flags=flags, compute_dtype=self.compute_dtype(),
                                  attn_impl=self.attn_impl)

    def image_features(self, params, frozen, images):
        clip = frozen["clip"]
        deep = flags = None
        if "compound_text" in params:  # each depth's linear projection of its text prompts
            rows = (torch.einsum("knd,kdw->knw", params["compound_text"], params["compound_proj.w"])
                    + params["compound_proj.b"][:, None, :])
            deep, flags = _pad_deep(rows, clip.cfg.vision_layers)
        shallow = params["ctx"] @ params["proj.w"] + params["proj.b"]
        return encode_image(clip, images, prompts=VisionPrompts(shallow, deep, flags),
                            compute_dtype=self.compute_dtype(), attn_impl=self.attn_impl)

    def logits_fn(self, params, frozen, images):
        return self.image_logits_fn(params, frozen, images, self.text_features_fn(params, frozen))

    def loss_fn(self, params, frozen, batch):
        logits = self.logits_fn(params, frozen, batch["img"])
        valid = batch.get("valid")
        if self.use_focal:
            loss = focal_loss(logits, batch["label"], alpha=frozen["alpha"], valid=valid)
        else:
            loss = cross_entropy(logits, batch["label"], valid=valid)
        return loss, {"acc": masked_acc(logits, batch["label"], valid)}

    # split eval: the class text features once per test(), then image logits
    def text_features_fn(self, params, frozen):
        return l2_normalize(self.text_features(params, frozen))

    def image_logits_fn(self, params, frozen, images, txf):
        imf = l2_normalize(self.image_features(params, frozen, images))
        return torch.exp(frozen["clip"].logit_scale).float() * imf @ txf.T
