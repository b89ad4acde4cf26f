"""CoCoOp: conditional context optimization (counterpart of
fsvlm_tpu.trainers.cocoop).

A meta-net MLP (vis_dim -> vis_dim/16 -> ctx_dim, ReLU between) turns each
image's normalized features into a bias added to the shared context, so
every image gets its own n_cls prompts.  As in the JAX package the prompts
(B, n_cls, L, D) are assembled with one einsum and flattened to (B*n_cls, L,
D) through the text tower, at any batch size.  Past ``BATCHED_TEXT_LIMIT``
text sequences (or with TRAINER.COCOOP.CLASS_CHUNK > 0) the logits are
built class block by class block instead: the class list is padded with its
first classes to whole blocks, each block runs one (B*chunk) text pass, and
the padding is trimmed from the concatenated logits.  Under TRAIN.REMAT
each block is checkpointed (its forward recomputed in the backward), and so
is every transformer layer inside it, as the JAX package nests
``jax.checkpoint`` (:188, :183).

Parameters are flat keys of ``params``: "ctx" and "meta_net.w1",
"meta_net.b1", "meta_net.w2", "meta_net.b2", the weights in the JAX
package's (in, out) layout; ``meta_net_from_torch`` is the one place that
transposes torch's (out, in) ``nn.Linear`` weights.  The meta-net is drawn
from the same numpy RandomState as the context, after it, as in the JAX
package (:71-88), so one seed gives the same init in both.  Past
``BATCHED_TEXT_LIMIT`` the trainer vetoes TRAIN.EPOCH_FUSE "auto", as the
JAX package's does (:115-128), and says so: its epochs then run step by
step; "on" still fuses them.  Across ranks both the veto and the class
blocks read the global batch, as the JAX package's SPMD step does; a batch
of 1 is padded to one row per rank (``parallel.mesh.shard_batch``), the pad
rows out of every mean.
"""

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import encode_image, encode_text_embeds, l2_normalize
from ..parallel import mesh
from .backbone import clip_for_trainer
from .losses import cross_entropy, focal_alpha_from_shots, focal_loss, masked_acc
from .prompts import build_prompt_context, prompt_tensors

# Above this batch * n_cls product the logits are built class block by class
# block (one block's B * chunk text forwards live at a time).  Module-level
# so that tests can force the chunked branch at a tiny size.
BATCHED_TEXT_LIMIT = 4096

META_NET_KEYS = ("meta_net.w1", "meta_net.b1", "meta_net.w2", "meta_net.b2")


def _init_linear(rng, fan_in, fan_out):
    """torch nn.Linear's default init (kaiming uniform, a = sqrt(5)) drawn
    from the numpy ``rng``: (in, out) weight and bias, float32."""
    bound = 1.0 / np.sqrt(fan_in)
    w = rng.uniform(-bound, bound, size=(fan_in, fan_out)).astype(np.float32)
    b = rng.uniform(-bound, bound, size=(fan_out,)).astype(np.float32)
    return w, b


def meta_net_from_torch(state):
    """The meta-net entries of ``params`` from a torch state dict with
    "linear1.weight", "linear1.bias", "linear2.weight", "linear2.bias"
    ((out, in) weights): float32 tensors, weights transposed to (in, out)."""
    def t(name):
        return torch.as_tensor(np.asarray(state[name], np.float32))

    return {"meta_net.w1": t("linear1.weight").T.contiguous(), "meta_net.b1": t("linear1.bias"),
            "meta_net.w2": t("linear2.weight").T.contiguous(), "meta_net.b2": t("linear2.bias")}


@TRAINER_REGISTRY.register()
class CoCoOp(SimpleTrainer):
    model_name = "prompt_learner"
    trainer_cfg_key = "COCOOP"
    data_parallel = True

    def build_model(self, clip):
        cfg, node = self.cfg, self.node
        self.clip = clip = clip_for_trainer(cfg, clip, self.device)
        rng = np.random.RandomState(max(cfg.SEED, 0))
        pc = build_prompt_context(
            clip.text.token_embedding.detach().float().cpu().numpy(),
            self.classnames,
            n_ctx=node.N_CTX,
            ctx_init=node.CTX_INIT,
            class_token_position="end",
            rng=rng,
            context_length=clip.cfg.context_length,
            truncate=bool(cfg.MODEL.TEXT_TRUNCATE),
        )
        print(f'Initial context: "{pc["prompt_prefix"]}"')

        vis_dim, ctx_dim = clip.cfg.embed_dim, clip.cfg.transformer_width
        hidden = max(vis_dim // 16, 1)
        w1, b1 = _init_linear(rng, vis_dim, hidden)
        w2, b2 = _init_linear(rng, hidden, ctx_dim)
        init = dict(zip(("ctx",) + META_NET_KEYS, (pc["init_ctx"], w1, b1, w2, b2)))
        self.params = {k: torch.from_numpy(np.asarray(v, np.float32)).to(self.device)
                       .requires_grad_() for k, v in init.items()}

        self.use_focal = bool(node.USE_FOCAL_LOSS)
        alpha = None
        if self.use_focal and len(cfg.DATASET.PER_CLASS_SHOTS) > 0:
            alpha = focal_alpha_from_shots(cfg.DATASET.PER_CLASS_SHOTS, self.device)
        self.frozen = {"clip": clip, **prompt_tensors(pc, self.device), "alpha": alpha}
        self.remat = bool(cfg.TRAIN.REMAT)
        self.class_chunk = int(node.CLASS_CHUNK)
        # TRAIN.EPOCH_FUSE "auto": past the batched-text limit a step is
        # seconds of class-chunked text work, and the JAX package keeps
        # such epochs step by step (its whole-epoch program crashed the
        # TPU worker at 500 classes x batch 32); "on" still fuses
        train_bs = int(cfg.DATALOADER.TRAIN_X.BATCH_SIZE)
        if train_bs * self.num_classes > BATCHED_TEXT_LIMIT:
            self._epoch_fuse_auto_off = True
            print(f"[CoCoOp] batch x classes = {train_bs} x {self.num_classes} > "
                  f"{BATCHED_TEXT_LIMIT}: EPOCH_FUSE=auto selects per-step dispatch")

    def _text_logits(self, frozen, imf, ctx, scale, base, scat, eot):
        """scale * cos(image, class text) for the classes of ``base`` /
        ``scat`` / ``eot``: one (B * n) text pass over every image's prompts."""
        B, n = imf.shape[0], base.shape[0]
        prompts = base[None] + torch.einsum("cpj,bjd->bcpd", scat, ctx.float())
        L, D = prompts.shape[-2:]
        txf = encode_text_embeds(frozen["clip"], prompts.reshape(B * n, L, D), eot.repeat(B),
                                 compute_dtype=self.compute_dtype(), attn_impl=self.attn_impl,
                                 remat=self.remat).reshape(B, n, -1)
        return scale * torch.einsum("be,bce->bc", imf, l2_normalize(txf))

    def class_chunk_for(self, batch_size):
        """The class block size for a batch: CLASS_CHUNK, else (0) past
        BATCHED_TEXT_LIMIT the most classes whose text passes fit under it;
        0 or >= n_cls means one batched pass."""
        chunk = self.class_chunk
        if chunk <= 0 and batch_size * self.num_classes > BATCHED_TEXT_LIMIT:
            chunk = max(1, min(self.num_classes, BATCHED_TEXT_LIMIT // max(batch_size, 1)))
        return chunk

    def logits_fn(self, params, frozen, images):
        imf = l2_normalize(encode_image(frozen["clip"], images, compute_dtype=self.compute_dtype(),
                                        attn_impl=self.attn_impl))
        h = torch.relu(imf @ params["meta_net.w1"] + params["meta_net.b1"])
        bias = h @ params["meta_net.w2"] + params["meta_net.b2"]  # (B, D)
        ctx = params["ctx"][None] + bias[:, None, :]  # (B, n_ctx, D)
        scale = torch.exp(frozen["clip"].logit_scale).float()
        base, scat, eot = frozen["base_embed"], frozen["ctx_scatter"], frozen["eot_idx"]

        n_cls = self.num_classes
        # the global batch's, as the JAX package's SPMD step sees it
        chunk = self.class_chunk_for(images.shape[0] * mesh.world_size())
        if chunk <= 0 or chunk >= n_cls:
            return self._text_logits(frozen, imf, ctx, scale, base, scat, eot)
        n_pad = (-n_cls) % chunk  # pad with the first classes to whole blocks
        if n_pad:
            base, scat, eot = (torch.cat([t, t[:n_pad]]) for t in (base, scat, eot))
        blocks = []
        for c0 in range(0, n_cls + n_pad, chunk):
            args = (frozen, imf, ctx, scale, base[c0:c0 + chunk], scat[c0:c0 + chunk],
                    eot[c0:c0 + chunk])
            if self.remat:
                blocks.append(checkpoint(self._text_logits, *args, use_reentrant=False,
                                         preserve_rng_state=False))
            else:
                blocks.append(self._text_logits(*args))
        return torch.cat(blocks, dim=1)[:, :n_cls]

    def loss_fn(self, params, frozen, batch):
        logits = self.logits_fn(params, frozen, batch["img"])
        valid = batch.get("valid")
        if self.use_focal:
            loss = focal_loss(logits, batch["label"], alpha=frozen["alpha"], valid=valid)
        else:
            loss = cross_entropy(logits, batch["label"], valid=valid)
        return loss, {"acc": masked_acc(logits, batch["label"], valid)}
