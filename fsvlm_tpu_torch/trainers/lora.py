"""CLIP-LoRA: low-rank adaptation of the attention projections (counterpart
of fsvlm_tpu.trainers.lora, :1-327).

- q/k/v/o factors on the layers of the text and/or vision towers that
  POSITION selects (INDEX_POSITIONS_*; ENCODER, PARAMS, R, ALPHA): every
  layer keeps its factors, stacked per projection as A (n_layers, dim, r)
  and B (n_layers, r, dim), and a 0/1 layer mask folded into the scale
  alpha / sqrt(r) gates them, so a layer outside POSITION gets a gradient
  of exactly 0 (and is still decayed by SGD's weight decay, as in JAX);
- A ~ U(-1/sqrt(dim), 1/sqrt(dim)) from ``np.random.RandomState(SEED)`` in
  the JAX package's order (text, then vision; PARAMS order), B = 0;
- fixed text prompts "a photo of a {}." (ctx frozen at its phrase init);
- optional SCL losses against a frozen zero-shot teacher, TEXT/IMAGE/
  LOGITS_LOSS_WEIGHT (the KL summed over classes, meaned over valid rows,
  divided by the class count; across ranks the text L1, which reads the
  factors alone, is every rank's whole term at 1/R);
- DROPOUT_RATE: the reference's LoRA dropout on each projection's branch
  input while training; each step's keep masks come from the trainer's
  generator on the device (``dropout_draws``), one independent mask per
  projection, tower and layer, drawn before the layer outside its
  checkpoint (across ranks the image tower's for the global batch, then
  sliced: ``DropoutDraws``); evaluation draws none;
- both towers rematerialized (``remat``), in training and evaluation;
- a LoRA-only checkpoint {weights, metadata{r, alpha, encoder, params,
  position}, epoch, val_result} at ``<dir>/<DATASET>/<backbone>/lora/``
  ``best.pkl`` (the best-val save, or every save without best-val
  tracking) and ``last.pkl``, written by rank 0 alone, with ``weights``
  in the JAX tree layout {"text"|"vision": {"q": (A, B), ...}}, so that
  either package loads the other's; a metadata mismatch raises
  ValueError.  ``resume_model_if_exist`` returns 0, as in JAX.

The trainable tensors are flat entries of ``params``: "text.q.0" is the
text tower's stacked q A, "text.q.1" its B.
"""

import os
import pickle

import numpy as np
import torch

from ..engine.checkpoint import flatten, load_checkpoint
from ..engine.trainer import TRAINER_REGISTRY, SimpleTrainer
from ..models.clip import encode_image_vit, encode_text_embeds, encode_text_ids, l2_normalize
from ..models.clip.tokenizer import tokenize
from ..parallel import mesh
from ..utils import mkdir_if_missing
from .backbone import clip_for_trainer
from .ivlp_family import build_vlp_frozen
from .losses import cross_entropy, l1_loss, masked_acc, masked_mean
from .prompts import assemble_prompts

INDEX_POSITIONS_TEXT = {
    "top1": [11],
    "top2": [10, 11],
    "top3": [9, 10, 11],
    "bottom": [0, 1, 2, 3],
    "mid": [4, 5, 6, 7],
    "up": [8, 9, 10, 11],
    "half-up": [6, 7, 8, 9, 10, 11],
    "half-bottom": [0, 1, 2, 3, 4, 5],
    "all": list(range(12)),
}

INDEX_POSITIONS_VISION = {
    "top": [11],
    "top3": [9, 10, 11],
    "bottom": [0, 1, 2, 3],
    "mid": [4, 5, 6, 7],
    "up": [8, 9, 10, 11],
    "half-up": [6, 7, 8, 9, 10, 11],
    "half-bottom": [0, 1, 2, 3, 4, 5],
    "all": None,  # every layer of the backbone
}

TOWERS = ("text", "vision")
LORA_PROJ = ("q", "k", "v", "o")


def layer_mask(position, table, n_layers):
    """The 0/1 mask of the layers that carry LoRA, as floats; a position the
    table lacks selects every layer (JAX :66-74)."""
    layers = table.get(position)
    if layers is None:
        layers = range(n_layers)
    mask = [0.0] * n_layers
    for i in layers:
        if i < n_layers:
            mask[i] = 1.0
    return mask


def init_factors(rng, n_layers, dim, r, proj_names):
    """{name: (A, B)}: A ~ kaiming-uniform(a = sqrt(5)) = U(-1/sqrt(dim),
    1/sqrt(dim)) of (n_layers, dim, r) from the numpy ``rng``, B = 0 of
    (n_layers, r, dim), float32 (JAX :77-86)."""
    bound = 1.0 / np.sqrt(dim)
    return {name: (rng.uniform(-bound, bound, size=(n_layers, dim, r)).astype(np.float32),
                   np.zeros((n_layers, r, dim), np.float32)) for name in proj_names}


class DropoutDraws:
    """One step's LoRA dropout keep masks, per (tower, layer): {projection:
    bool mask of the layer's input shape}, True with probability 1 - rate.
    Drawn on first use from ``generator`` (on its device) and kept, so that
    a recomputed layer, or a second trainer handed the same object, sees
    the same masks; or handed in whole as ``masks`` (tests inject the JAX
    package's ``jax.random.bernoulli`` draws).  Across ranks the image
    tower's masks, whose first axis is this rank's rows, are drawn at the
    global batch's shape from the generator (the same on every rank) and
    sliced to this rank's rows, as the JAX package's per-layer keys draw
    over the global array; the text tower's (per class) are every rank's
    alike."""

    def __init__(self, rate, names, generator=None, masks=None):
        self.rate, self.names, self.generator = rate, tuple(names), generator
        self.masks = {} if masks is None else masks

    def tower(self, tower):
        """``draw(layer, shape)`` for ``transformer``'s LoRA dropout."""
        def draw(layer, shape):
            key = (tower, layer)
            if key not in self.masks:
                g, p = self.generator, 1 - self.rate

                def mask(n):
                    return torch.rand((n,) + tuple(shape[1:]), generator=g, device=g.device) < p

                if tower == "vision":  # rows: the global batch's masks, this rank's rows
                    self.masks[key] = {n: mesh.draw_rows(mask, shape[0]) for n in self.names}
                else:
                    self.masks[key] = {n: mask(shape[0]) for n in self.names}
            return self.masks[key]
        return draw


@TRAINER_REGISTRY.register()
class LoRA(SimpleTrainer):
    model_name = "lora"
    trainer_cfg_key = "LORA"

    def check_cfg(self, cfg):
        super().check_cfg(cfg)
        node = cfg.TRAINER.LORA
        if node.ENCODER not in ("text", "vision", "both"):
            raise ValueError(f"Unknown LORA.ENCODER: {node.ENCODER}")
        if not all(p in LORA_PROJ for p in node.PARAMS):
            raise ValueError(f"LORA.PARAMS must be among {LORA_PROJ}, got {node.PARAMS}")

    def build_model(self, clip):
        cfg, node = self.cfg, self.node
        self.clip = clip = clip_for_trainer(cfg, clip, self.device)
        if not clip.cfg.is_vit:
            raise NotImplementedError("LoRA targets the ViT backbones")
        frozen, pc = build_vlp_frozen(node, clip, self.classnames, cfg.SEED,
                                      cfg.MODEL.TEXT_TRUNCATE)
        # fixed prompts: ctx frozen at its phrase init (the reference keeps
        # the prompt out of the optimizer)
        frozen["fixed_prompts"] = assemble_prompts(
            torch.from_numpy(np.asarray(pc["init_ctx"], np.float32)).to(self.device),
            frozen["base_embed"], frozen["ctx_scatter"])

        rng = np.random.RandomState(max(cfg.SEED, 0))
        r, alpha = int(node.R), float(node.ALPHA)
        self.lora_meta = {"r": r, "alpha": alpha, "encoder": node.ENCODER,
                          "params": list(node.PARAMS), "position": node.POSITION}
        self.scale = float(np.float32(alpha / np.sqrt(r)))  # JAX's f32 scale
        self.proj_names = tuple(node.PARAMS)
        c = clip.cfg
        shapes = {"text": (c.transformer_layers, c.transformer_width, INDEX_POSITIONS_TEXT),
                  "vision": (c.vision_layers, c.vision_width, INDEX_POSITIONS_VISION)}
        self.towers = [t for t in TOWERS if node.ENCODER in (t, "both")]
        self.layer_masks, self.params = {}, {}
        for tower in self.towers:
            n_layers, dim, table = shapes[tower]
            for name, ab in init_factors(rng, n_layers, dim, r, node.PARAMS).items():
                for i, x in enumerate(ab):
                    self.params[f"{tower}.{name}.{i}"] = (
                        torch.from_numpy(x).to(self.device).requires_grad_())
            self.layer_masks[tower] = layer_mask(node.POSITION, table, n_layers)

        self.text_w = float(node.TEXT_LOSS_WEIGHT)
        self.image_w = float(node.IMAGE_LOSS_WEIGHT)
        self.logits_w = float(node.LOGITS_LOSS_WEIGHT)
        if self.text_w > 0 or self.logits_w > 0:
            # the zero-shot teacher's text features, fp32 (encode_text_ids' default)
            ids = tokenize([f"a photo of a {c.replace('_', ' ')}." for c in self.classnames])
            with torch.no_grad():
                frozen["zs_text"] = l2_normalize(encode_text_ids(
                    clip, torch.from_numpy(ids).long().to(self.device), attn_impl=self.attn_impl))
        self.frozen = frozen
        self.dropout_rate = float(node.DROPOUT_RATE)
        self.use_dropout = self.dropout_rate > 0

    def dropout_draws(self):
        return DropoutDraws(self.dropout_rate, self.proj_names, self.generator)

    def lora_arg(self, params, tower, drop=None):
        """``transformer``'s LoRA argument for ``tower``, or None when it
        carries none; ``drop``: a step's DropoutDraws (training only)."""
        if tower not in self.towers:
            return None
        proj = {n: (params[f"{tower}.{n}.0"], params[f"{tower}.{n}.1"]) for n in self.proj_names}
        arg = {"proj": proj, "scale": self.scale, "mask": self.layer_masks[tower]}
        if drop is not None:
            arg["dropout"] = (drop.tower(tower), self.dropout_rate)
        return arg

    def text_features(self, params, frozen, drop=None):
        return encode_text_embeds(frozen["clip"], frozen["fixed_prompts"], frozen["eot_idx"],
                                  compute_dtype=self.compute_dtype(), attn_impl=self.attn_impl,
                                  lora=self.lora_arg(params, "text", drop), remat=True)

    def image_features(self, params, frozen, images, drop=None):
        return encode_image_vit(frozen["clip"], images, compute_dtype=self.compute_dtype(),
                                attn_impl=self.attn_impl,
                                lora=self.lora_arg(params, "vision", drop), remat=True)

    def loss_fn(self, params, frozen, batch):
        images, labels, valid = batch["img"], batch["label"], batch.get("valid")
        drop = batch.get("drop")
        txf = l2_normalize(self.text_features(params, frozen, drop))
        imf = l2_normalize(self.image_features(params, frozen, images, drop))
        logit_scale = torch.exp(frozen["clip"].logit_scale).float()
        logits = logit_scale * imf @ txf.T
        loss = cross_entropy(logits, labels, valid=valid)
        if self.image_w > 0 or self.logits_w > 0:
            with torch.no_grad():
                zs_img = l2_normalize(encode_image_vit(
                    frozen["clip"], images, compute_dtype=self.compute_dtype(),
                    attn_impl=self.attn_impl))
        if self.text_w > 0:  # reads the factors alone: every rank's whole term, at 1/R
            loss = loss + self.text_w * mesh.replicated_term(
                l1_loss(txf, frozen["zs_text"], rows=False))
        if self.image_w > 0:
            loss = loss + self.image_w * l1_loss(imf, zs_img, valid=valid)
        if self.logits_w > 0:
            zs_logits = logit_scale * zs_img @ frozen["zs_text"].T
            s = torch.log_softmax(logits.float(), dim=1)
            t = torch.log_softmax(zs_logits.float(), dim=1)
            per_row = (torch.exp(t) * (t - s)).sum(dim=1)
            loss = loss + self.logits_w * masked_mean(per_row, valid) / logits.shape[1]
        return loss, {"acc": masked_acc(logits, labels, valid)}

    def logits_fn(self, params, frozen, images):
        txf = self.text_features_fn(params, frozen)
        return self.image_logits_fn(params, frozen, images, txf)

    # split eval, deterministic (no dropout)
    def text_features_fn(self, params, frozen):
        return l2_normalize(self.text_features(params, frozen))

    def image_logits_fn(self, params, frozen, images, txf):
        imf = l2_normalize(self.image_features(params, frozen, images))
        return torch.exp(frozen["clip"].logit_scale).float() * imf @ txf.T

    # ------------------------------------------------------ LoRA checkpoints
    def lora_dir(self, directory):
        backbone = self.cfg.MODEL.BACKBONE.NAME.replace("/", "-")
        return os.path.join(directory, self.cfg.DATASET.NAME, backbone, "lora")

    def lora_weights(self):
        """The factors in the JAX tree layout, as numpy copies."""
        def np_(t):
            return t.detach().cpu().numpy().copy()

        return {tower: {n: (np_(self.params[f"{tower}.{n}.0"]), np_(self.params[f"{tower}.{n}.1"]))
                        for n in self.proj_names} for tower in self.towers}

    def save_model(self, epoch, directory, val_result=None, model_name=""):
        """The LoRA-only checkpoint (JAX :246-278): the best-val save owns
        best.pkl, and periodic and final saves go to last.pkl when best-val
        tracking is on (else every save to best.pkl).  Across ranks rank 0
        alone writes."""
        if not mesh.is_main():
            return
        save_dir = self.lora_dir(directory)
        mkdir_if_missing(save_dir)
        payload = {"weights": self.lora_weights(), "metadata": dict(self.lora_meta),
                   "epoch": epoch + 1, "val_result": val_result}
        track_best = self.cfg.TEST.FINAL_MODEL == "best_val" and not self.cfg.TEST.NO_TEST
        fname = "best.pkl" if ("best" in (model_name or "") or not track_best) else "last.pkl"
        path = os.path.join(save_dir, fname)
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        print(f"LoRA checkpoint saved to {path}")

    def resume_model_if_exist(self, directory):
        return 0

    def load_model(self, directory, epoch=None):
        """best.pkl, else last.pkl, of ``directory``'s LoRA folder; every
        metadata key must equal the config's (ValueError otherwise)."""
        if not directory:
            print("Note that load_model() is skipped as no pretrained model is given")
            return
        path = os.path.join(self.lora_dir(directory), "best.pkl")
        if not os.path.exists(path):
            alt = os.path.join(self.lora_dir(directory), "last.pkl")
            if not os.path.exists(alt):
                raise FileNotFoundError(f"LoRA checkpoint not found at {path}")
            path = alt
        payload = load_checkpoint(path)
        meta = payload["metadata"]
        for key, expected in self.lora_meta.items():
            if meta.get(key) != expected:
                raise ValueError(f"LoRA metadata mismatch for '{key}': checkpoint has "
                                 f"{meta.get(key)!r}, config expects {expected!r}")
        weights = flatten(payload["weights"])
        if set(weights) != set(self.params):
            raise ValueError(f"LoRA checkpoint holds {sorted(weights)}, the trainer "
                             f"{sorted(self.params)}")
        with torch.no_grad():  # in place: the optimizer holds the tensors
            for name, p in self.params.items():
                p.copy_(torch.from_numpy(np.array(weights[name], np.float32)))
        print(f"Loaded LoRA weights from {path} (epoch {payload['epoch']})")
