"""PLIP: prompt tuning with a Lipschitz-smoothness regularizer (counterpart
of fsvlm_tpu.trainers.plip, :1-160).

Learnable text context vectors (N_CTX_TEXT, initialized from CTX_INIT with
the configured count kept), the class token at the end, frozen CLIP towers;
the loss is CE + REG_COEFF * penalty, by REG_TYPE:

- "grad": the per-token L2 norm of d(CE)/d(ctx) pulled toward K,
  mean((||g_i|| - K)^2), with g from ``torch.autograd.grad(...,
  create_graph=True)``, so the step differentiates the text tower twice.
  The kernels' backwards are first order only: the text tower takes
  ``reference_attention`` (JAX's default route, which JAX's PLIP
  differentiates twice) whatever FSVLM_FORCE_PALLAS says; LayerNorm and
  QuickGELU differentiate their own backwards.  The image tower, which ctx
  does not reach, stays on the kernels.
- "spectral_norm": a 5-step power-iteration estimate of ||ctx||_2 from a
  start vector drawn each step from the trainer's generator (torch cannot
  draw JAX's threefry bits; a batch may hand one in as "v0").
- "svd": ctx = U diag(S) Vh with only the singular values S trainable (U,
  Vh from ``np.linalg.svd`` of the initial ctx, the JAX package's call) and
  no penalty.

Across ranks (``parallel.mesh``) each penalty is every rank's whole term at
1/R: "grad"'s on the global CE's gradient (this rank's, summed over the
ranks by the differentiable ``all_reduce_sum``), "spectral_norm"'s on the
replicated ctx from a start vector that every rank draws alike.

The trainable state is {"ctx"}, or {"S"} under svd; checkpoints hold it
under ``prompt_learner/`` as the JAX package's do.  The image tower runs
under ``torch.no_grad()``.  Split eval: the class text features once
(``text_features_fn``), then image logits per batch (``image_logits_fn``).
"""

import numpy as np
import torch

from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import clip_logits, encode_image, encode_text_embeds, l2_normalize
from ..parallel import mesh
from .backbone import clip_for_trainer
from .losses import cross_entropy, masked_acc
from .prompts import assemble_prompts, build_prompt_context, prompt_tensors

REG_TYPES = ("grad", "svd", "spectral_norm")
POWER_STEPS = 5


@TRAINER_REGISTRY.register()
class PLIP(SimpleTrainer):
    model_name = "prompt_learner"
    trainer_cfg_key = "PLIP"

    def check_cfg(self, cfg):
        super().check_cfg(cfg)
        if cfg.TRAINER.PLIP.REG_TYPE not in REG_TYPES:
            raise ValueError(f"Unknown PLIP.REG_TYPE: {cfg.TRAINER.PLIP.REG_TYPE}")

    def build_model(self, clip):
        cfg, node = self.cfg, self.node
        self.clip = clip = clip_for_trainer(cfg, clip, self.device)
        pc = build_prompt_context(
            clip.text.token_embedding.detach().float().cpu().numpy(),
            self.classnames,
            n_ctx=node.N_CTX_TEXT,
            ctx_init=node.CTX_INIT,
            class_token_position="end",
            rng=np.random.RandomState(max(cfg.SEED, 0)),
            context_length=clip.cfg.context_length,
            init_keep_n_ctx=True,
            truncate=bool(cfg.MODEL.TEXT_TRUNCATE),
        )
        print(f'Initial context: "{pc["prompt_prefix"]}"')
        print("K:", node.K)
        print("REG_COEFF:", node.REG_COEFF)
        self.reg_type, self.K, self.coeff = node.REG_TYPE, float(node.K), float(node.REG_COEFF)
        init_ctx = np.asarray(pc["init_ctx"], np.float32)
        self.frozen = {"clip": clip, **prompt_tensors(pc, self.device)}
        if self.reg_type == "svd":
            u, s, vh = np.linalg.svd(init_ctx, full_matrices=False)
            self.params = {"S": torch.from_numpy(s).to(self.device).requires_grad_()}
            self.frozen["U"] = torch.from_numpy(u).to(self.device)
            self.frozen["Vh"] = torch.from_numpy(vh).to(self.device)
        else:
            self.params = {"ctx": torch.from_numpy(init_ctx).to(self.device).requires_grad_()}

    def get_ctx(self, params, frozen):
        if self.reg_type == "svd":
            return frozen["U"] @ torch.diag(params["S"]) @ frozen["Vh"]
        return params["ctx"]

    def text_features(self, ctx, frozen, attn_impl=None):
        prompts = assemble_prompts(ctx, frozen["base_embed"], frozen["ctx_scatter"])
        return encode_text_embeds(frozen["clip"], prompts, frozen["eot_idx"],
                                  compute_dtype=self.compute_dtype(),
                                  attn_impl=attn_impl or self.attn_impl)

    def image_features(self, frozen, images):
        """The frozen image tower, with no gradient."""
        with torch.no_grad():
            return encode_image(frozen["clip"], images, compute_dtype=self.compute_dtype(),
                                attn_impl=self.attn_impl)

    def logits_fn(self, params, frozen, images):
        return clip_logits(self.image_features(frozen, images),
                           self.text_features(self.get_ctx(params, frozen), frozen),
                           frozen["clip"].logit_scale)

    def loss_fn(self, params, frozen, batch):
        ctx = self.get_ctx(params, frozen)
        labels, valid = batch["label"], batch.get("valid")
        imf = self.image_features(frozen, batch["img"])
        # the gradient penalty differentiates the text tower twice
        text_impl = "reference" if self.reg_type == "grad" else None
        logits = clip_logits(imf, self.text_features(ctx, frozen, text_impl),
                             frozen["clip"].logit_scale)
        ce = cross_entropy(logits, labels, valid=valid)
        if self.reg_type == "grad":
            # the gradient of the global CE: this rank's share summed over the
            # ranks (differentiable, so each rank's share takes its own double
            # backward); the penalty on it is every rank's whole term, at 1/R
            g, = torch.autograd.grad(ce, ctx, create_graph=True)
            g = mesh.all_reduce_sum(g)
            penalty = mesh.replicated_term(((torch.linalg.vector_norm(g, dim=1) - self.K) ** 2)
                                           .mean())
        elif self.reg_type == "spectral_norm":
            v = batch.get("v0")  # this step's start vector, else drawn from the generator
            if v is None:
                v = torch.randn(ctx.shape[1], generator=self.generator, device=self.device)
            v = v / torch.linalg.vector_norm(v)
            gram = ctx.T @ ctx
            for _ in range(POWER_STEPS):
                v = gram @ v
                v = v / torch.linalg.vector_norm(v)
            penalty = mesh.replicated_term(torch.linalg.vector_norm(ctx @ v))
        else:  # svd: the constraint lives in the parameterization
            penalty = torch.zeros((), device=ctx.device)
        loss = ce + self.coeff * penalty
        return loss, {"penalty": penalty.float(), "acc": masked_acc(logits, labels, valid)}

    # split eval: the class text features once per test(), then image logits
    def text_features_fn(self, params, frozen):
        return l2_normalize(self.text_features(self.get_ctx(params, frozen), frozen))

    def image_logits_fn(self, params, frozen, images, txf):
        imf = l2_normalize(self.image_features(frozen, images))
        return torch.exp(frozen["clip"].logit_scale).float() * imf @ txf.T
