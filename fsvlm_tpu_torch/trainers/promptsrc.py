"""PromptSRC: prompt learning with self-regulating constraints (counterpart of
fsvlm_tpu.trainers.promptsrc, :47-183 and :222-253).

- IVLP prompts (text ctx + deep, vision shallow + deep);
- a frozen-CLIP teacher: "a photo of a {}." text features computed once at
  build (promptsrc.py:57-60), and a teacher image pass on the augmented
  batch every step, under ``torch.no_grad()`` (the JAX package's
  ``stop_gradient``, :132-137), so it saves nothing for the backward;
- under CACHED_TEACHER ("fast SCL", :62-66, :185-220) the teacher's
  L2-normalized image features are computed once at build, over the eval
  view (``data.transforms.TestTransform``) of every item of the
  DataManager's train set (a tensor-fed trainer raises) in batches of
  min(64, N), and each step reads its rows by dataset position
  (``batch["index"]``) instead of running the teacher image pass: the
  teacher sees the clean image, not the augmented one;
- the loss (reference forward_backward, promptsrc.py:285-331):
    CE (or focal) + TEXT_W * L1(text, zs_text) + IMAGE_W * L1(img, zs_img)
      + LOGITS_W * KL(student || teacher) summed over classes / n_classes,
  with an optional SimCLR term on a second view ("img2"); across ranks
  (``parallel.mesh``) the text L1, which reads the prompts alone, is
  every rank's whole term at 1/R, and the others are global row means;
- Gaussian Prompt Aggregation: per-epoch Gaussian weights over epochs
  1..MAX_EPOCH (mean GPA_MEAN, std GPA_STD, normalized), accumulated into a
  second set of prompt tensors at each epoch's end and copied into the live
  prompts after the last epoch; checkpoints carry the accumulator
  (``extra_state`` / ``load_extra_state``, :222-253).

- under INT8_TEACHER, when CACHED_TEACHER is off (:66-91, :122-128), the
  per-step teacher image pass runs on the augmented batch through an int8
  copy of the image tower (``ops/quant.py``), built once at build
  (``IVLP.int8_teacher_tower``);

Features, logits, softmaxes and losses are fp32; the logit scale is
exponentiated in the frozen towers' dtype, as in the JAX package.
"""

import numpy as np
import torch

from ..data.loader import BatchLoader, DatasetWrapper
from ..data.samplers import SequentialSampler
from ..data.transforms import TestTransform
from ..engine.checkpoint import flatten
from ..engine.trainer import TRAINER_REGISTRY
from ..models.clip import encode_image, encode_text_ids, l2_normalize
from ..models.clip.tokenizer import tokenize
from ..parallel import mesh
from .ivlp import IVLP
from .ivlp_family import vlp_image_features, vlp_text_features
from .losses import (
    cross_entropy,
    focal_alpha_from_shots,
    focal_loss,
    l1_loss,
    masked_acc,
    masked_mean,
    nt_xent,
)


@TRAINER_REGISTRY.register()
class PromptSRC(IVLP):
    model_name = "VLPromptLearner"
    trainer_cfg_key = "PROMPTSRC"

    def build_model(self, clip):
        super().build_model(clip)
        cfg, node = self.cfg, self.node
        # frozen teacher text features: the single template "a photo of a {}."
        # (fp32 compute, the JAX package's encode_text_ids default)
        ids = tokenize([f"a photo of a {c.replace('_', ' ')}." for c in self.classnames])
        with torch.no_grad():
            teacher_txt = encode_text_ids(self.clip, torch.from_numpy(ids).long().to(self.device),
                                          attn_impl=self.attn_impl)
        self.frozen["zs_text"] = l2_normalize(teacher_txt)
        self.cached_teacher = bool(node.CACHED_TEACHER)
        if self.cached_teacher:
            self.frozen["zs_img_cache"] = self.build_teacher_cache(*self.eval_view_batches())
        self.int8_teacher = bool(node.INT8_TEACHER) and not self.cached_teacher
        if self.int8_teacher:
            self.frozen["clip_teacher"] = self.int8_teacher_tower("[PromptSRC] int8 teacher")

        self.loss_type = node.LOSS_TYPE
        alpha = None
        if self.loss_type == "focal" and len(cfg.DATASET.PER_CLASS_SHOTS) > 0:
            alpha = focal_alpha_from_shots(cfg.DATASET.PER_CLASS_SHOTS, self.device)
        self.frozen["alpha"] = alpha

        # GPA (promptsrc.py:267-273)
        self.use_gpa = bool(node.USE_GPA)
        mu, sigma = node.GPA_MEAN, node.GPA_STD
        gauss = np.exp(-0.5 * ((np.arange(1, cfg.OPTIM.MAX_EPOCH + 1) - mu) / sigma) ** 2) / (
            sigma * np.sqrt(2 * np.pi))
        self.gauss = gauss / gauss.sum()
        self.gpa_params = None

    def loss_fn(self, params, frozen, batch):
        node = self.node
        images, labels, valid = batch["img"], batch["label"], batch.get("valid")
        dtype, impl = self.compute_dtype(), self.attn_impl
        logit_scale = torch.exp(frozen["clip"].logit_scale).float()

        txf = l2_normalize(vlp_text_features(params, frozen, dtype, impl))
        imf = l2_normalize(vlp_image_features(params, frozen, images, dtype, impl))
        logits = logit_scale * imf @ txf.T

        if self.cached_teacher:  # the clean-image features, by dataset position
            zs_img = frozen["zs_img_cache"][batch["index"]]
        elif self.int8_teacher:  # the augmented batch, at int8 teacher precision
            with torch.no_grad():
                zs_img = l2_normalize(encode_image(frozen["clip_teacher"], images,
                                                   compute_dtype=dtype, attn_impl=impl))
        else:
            # frozen-CLIP teacher pass on the augmented batch (reference
            # semantics, promptsrc.py:198-201)
            with torch.no_grad():
                zs_img = l2_normalize(vlp_image_features({}, frozen, images, dtype, impl))
        zs_logits = logit_scale * zs_img @ frozen["zs_text"].T

        if self.loss_type == "focal":
            loss_ce = focal_loss(logits, labels, alpha=frozen["alpha"], valid=valid)
        else:
            loss_ce = cross_entropy(logits, labels, valid=valid)
        # the text features read the prompts alone: every rank's whole term, at 1/R
        loss_scl_text = (mesh.replicated_term(l1_loss(txf, frozen["zs_text"], rows=False))
                         * node.TEXT_LOSS_WEIGHT)
        loss_scl_image = l1_loss(imf, zs_img, valid=valid) * node.IMAGE_LOSS_WEIGHT
        # KL(student || teacher) summed over classes, averaged over valid rows,
        # over the class count (promptsrc.py:316-324)
        s = torch.log_softmax(logits.float(), dim=1)
        t = torch.log_softmax(zs_logits.float(), dim=1)
        per_row = (torch.exp(t) * (t - s)).sum(dim=1)
        loss_scl_logits = masked_mean(per_row, valid) / logits.shape[1] * node.LOGITS_LOSS_WEIGHT

        loss = loss_ce + loss_scl_text + loss_scl_image + loss_scl_logits
        aux = {
            "loss_ce": loss_ce,
            "loss_scl_text": loss_scl_text,
            "loss_scl_image": loss_scl_image,
            "loss_scl_logits": loss_scl_logits,
            "acc": masked_acc(logits, labels, valid),
        }
        if node.SIMCLR_ALPHA > 0.0 and "img2" in batch:
            imf2 = l2_normalize(vlp_image_features(params, frozen, batch["img2"], dtype, impl))
            loss = loss + node.SIMCLR_ALPHA * nt_xent(imf, imf2, valid=valid)
        return loss, aux

    def eval_view_batches(self):
        """(N, batches): the eval view of every item of the DataManager's
        train set, in dataset order, as padded uint8 batches of min(64, N)
        with "index" and "valid"."""
        if self.dm is None:
            raise ValueError("CACHED_TEACHER reads the DataManager's train set: build the trainer "
                             "from cfg alone")
        data = self.dm.dataset.train_x
        return len(data), BatchLoader(
            DatasetWrapper(data, TestTransform(self.cfg), cache_transformed=False),
            SequentialSampler(data), min(64, max(1, len(data))),
            num_threads=max(1, self.cfg.DATALOADER.NUM_WORKERS))

    @torch.no_grad()
    def build_teacher_cache(self, n, batches):
        """(n, E) fp32 on the device: the frozen tower's L2-normalized image
        features (no prompts, #6 on the card) of ``batches`` (as
        ``eval_view_batches`` gives them), row i for dataset position i."""
        cache = torch.zeros((n, self.clip.cfg.embed_dim), dtype=torch.float32, device=self.device)
        for batch in batches:
            x = self.eval_images(torch.from_numpy(batch["img"]).to(self.device))
            feats = l2_normalize(vlp_image_features({}, self.frozen, x, self.compute_dtype(),
                                                    self.attn_impl)).float()
            valid = torch.from_numpy(batch["valid"]).to(self.device)
            index = torch.from_numpy(batch["index"]).to(self.device).long()
            cache[index[valid]] = feats[valid]
        print(f"[PromptSRC] cached teacher image features: {tuple(cache.shape)}")
        return cache

    def extra_state(self):
        st = super().extra_state()
        if self.gpa_params is not None:
            st["gpa_params"] = {k: v.cpu().numpy() for k, v in self.gpa_params.items()}
        return st

    def load_extra_state(self, state):
        super().load_extra_state(state)
        if state.get("gpa_params") is not None:
            self.gpa_params = {k: torch.from_numpy(np.array(v, np.float32)).to(self.device)
                               for k, v in flatten(state["gpa_params"]).items()}
        elif self.use_gpa:
            # resuming without the accumulator drops the pre-resume epochs
            # from the Gaussian aggregate
            print("WARNING: resuming PromptSRC from a checkpoint without gpa_params — the "
                  "GPA aggregate will exclude pre-resume epochs")

    @torch.no_grad()
    def after_epoch(self):
        if self.use_gpa:
            w = float(self.gauss[self.epoch])
            weighted = {k: p * w for k, p in self.params.items()}
            if self.gpa_params is None:
                self.gpa_params = weighted
            else:
                self.gpa_params = {k: weighted[k] + self.gpa_params[k] for k in weighted}
            if (self.epoch + 1) == self.max_epoch:
                print("Using GPA model for final inference...")
                for k, p in self.params.items():
                    p.copy_(self.gpa_params[k])
        super().after_epoch()
