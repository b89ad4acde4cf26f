"""The training loop core and test() (counterpart of
fsvlm_tpu.engine.trainer.SimpleTrainer, :97-142, :159-180, :212-252,
:262-270, :570-607, :677-715), without DataManager.

The trainer takes the class names, a uint8 image cache (N, P, P, 3) and its
labels, both moved to ``device`` (default cuda), and keeps its state there:
the prompt tensors (fp32 leaves), the optimizer, and a ``torch.Generator``
that draws the epoch permutation, under DATALOADER.DEVICE_AUG the crop
boxes and flips, and under mixup each step's batch permutation.  Mixup's
lam ~ Beta(alpha, alpha) has no device sampler that takes a generator: the
epoch's lams are drawn on the host from a ``numpy.random.Generator`` seeded
from SEED and moved to the device once per epoch, beside the epoch
schedule.  A step launches its work and returns its metrics as device
tensors, with no host sync; ``run_epoch`` reads them back once, at the
epoch's end.

- ``train_step(batch, aug, mix)``: a batch that carries its images ("img":
  float, already normalized, or uint8 under DEVICE_AUG), "label" and
  optionally "valid" / "img2"; ``aug`` = (boxes, flips) and ``mix`` =
  (perm, lam) hand in the step's draws (tests inject the JAX package's);
- ``train_step_resident(index, valid)``: indices into the cache, gathered on
  the device, as the JAX package's train_step_resident;
- ``forward_backward(batch)``: either, by whether the batch carries "img";
- ``train()``: epochs of ``steps_per_epoch`` resident steps, each framed by
  ``before_epoch`` / ``after_epoch``;
- ``test(images, labels)``: top-1 accuracy on a uint8 test cache, text
  features once where the trainer splits its eval.

Subclasses name their config node (``trainer_cfg_key``:
``cfg.TRAINER.<key>``, whose PREC sets the compute dtype) and implement
``build_model(clip)``, which sets ``params`` (dict of fp32 tensors),
``frozen``, ``use_mixup`` / ``mixup_alpha`` where they mix, and
``loss_fn(params, frozen, batch) -> (loss, aux)``; under ``use_mixup`` the
batch carries its draws as "perm" and "lam"; for ``test()``, either
``text_features_fn(params, frozen)`` and ``image_logits_fn(params, frozen,
images, txf)`` (split eval) or ``logits_fn(params, frozen, images)``.
Checkpoint save and resume, best-val selection and the DataManager's
loaders are not ported.
"""

import math

import numpy as np
import torch

from .. import resolve_device
from ..ops.preprocess import (
    crop_resize_flip_normalize,
    normalize_only,
    random_resized_crop_flip_normalize,
)
from .evaluator import Classification
from .optim import build_optimizer


class SimpleTrainer:
    model_name = None
    trainer_cfg_key = None  # the trainer's node of cfg.TRAINER
    use_mixup = False  # set by build_model: every step then draws (perm, lam)
    mixup_alpha = 1.0

    def __init__(self, cfg, classnames, images=None, labels=None, clip=None, device=None,
                 steps_per_epoch=None, attn_impl=None):
        """cfg: ``fsvlm_tpu_torch.config.Config``.  images/labels: the train
        set as a uint8 (N, P, P, 3) cache and (N,) integer labels.  clip: an
        already built CLIP module on ``device`` (else one is loaded for
        MODEL.BACKBONE.NAME).  steps_per_epoch: default N // batch size (1
        when N is smaller than a batch), as the JAX package's drop-last
        train loader.  attn_impl: None (the hand-written kernels on CUDA) or
        "plain", for comparisons only."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.check_cfg(cfg)
        self.classnames = list(classnames)
        self.num_classes = len(self.classnames)
        self.attn_impl = attn_impl
        self.start_epoch = self.epoch = self.batch_idx = 0
        self.max_epoch = cfg.OPTIM.MAX_EPOCH
        self.generator = torch.Generator(device=self.device).manual_seed(max(cfg.SEED, 0))
        self.mix_rng = np.random.default_rng(max(cfg.SEED, 0))  # the epochs' mixup lams
        self.epoch_lams = None
        # on the device once: copying them at every step would sync the host
        self.pixel_stats = [torch.tensor(v, dtype=torch.float32, device=self.device)
                            for v in (cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)]
        self.cache = self.labels = None
        if images is not None:
            self.set_train_data(images, labels)
        self.build_model(clip)
        self._build_optimizer(steps_per_epoch)

    # ------------------------------------------------------------------ setup
    @property
    def node(self):
        return getattr(self.cfg.TRAINER, self.trainer_cfg_key)

    def check_cfg(self, cfg):
        if self.node.PREC not in ("fp16", "fp32", "amp", "bf16"):
            raise ValueError(f"Unknown PREC: {self.node.PREC}")

    def compute_dtype(self):
        """bf16 on the card unless PREC is fp32 (fp16 and amp included, as
        the JAX package computes them in bf16 on the TPU); fp32 on the CPU."""
        if self.node.PREC == "fp32" or self.device.type == "cpu":
            return torch.float32
        return torch.bfloat16

    def build_model(self, clip):
        raise NotImplementedError

    def set_train_data(self, images, labels):
        """Move the uint8 (N, P, P, 3) train images and their labels to the
        device, where every step gathers its batch."""
        images = torch.as_tensor(images)
        if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"images must be uint8 (N, P, P, 3), got {images.dtype} "
                             f"{tuple(images.shape)}")
        labels = torch.as_tensor(labels)
        if labels.shape != images.shape[:1]:
            raise ValueError(f"need one label per image, got {tuple(labels.shape)}")
        self.cache = images.to(self.device)
        self.labels = labels.to(self.device, torch.long)

    def _build_optimizer(self, steps_per_epoch):
        if steps_per_epoch is None:
            n, B = (len(self.cache) if self.cache is not None else 0), self.batch_size
            steps_per_epoch = n // B if n >= B else 1
        self.steps_per_epoch = steps_per_epoch
        self.optim, self.lr_schedule = build_optimizer(self.cfg, self.params.values(),
                                                       steps_per_epoch)
        print(f"# params to be updated: {sum(p.numel() for p in self.params.values()):,}")

    @property
    def batch_size(self):
        return self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE

    # ------------------------------------------------------------------- steps
    def augment(self, images, aug=None):
        """DEVICE_AUG's random-resized-crop + flip + normalize of uint8
        images; ``aug`` = (boxes, flips) hands in the draws, else they come
        from the trainer's generator."""
        inp = self.cfg.INPUT
        if aug is None:
            return random_resized_crop_flip_normalize(images, self.generator, inp.SIZE[0],
                                                      inp.RRCROP_SCALE, *self.pixel_stats)
        boxes, flips = aug
        return crop_resize_flip_normalize(images, boxes, flips, inp.SIZE[0], *self.pixel_stats)

    def draw_epoch_lams(self):
        """This epoch's mixup lams, one per step, ~ Beta(alpha, alpha) (1 when
        alpha <= 0, as mixup_batch), drawn on the host and moved to the
        device in one copy."""
        n = self.steps_per_epoch
        a = self.mixup_alpha
        lams = self.mix_rng.beta(a, a, n) if a > 0 else np.ones(n)
        self.epoch_lams = torch.from_numpy(lams.astype(np.float32)).to(self.device)

    def mixup_draws(self, batch_size):
        """This step's (perm, lam) on the device, with no host sync: a
        permutation of the batch from the generator, and the epoch's lam at
        this step (a view of the device tensor: indexing it by a Python int
        reads nothing back)."""
        if self.epoch_lams is None:
            self.draw_epoch_lams()
        perm = torch.randperm(batch_size, generator=self.generator, device=self.device)
        return perm, self.epoch_lams[self.batch_idx % len(self.epoch_lams)]

    def train_step(self, batch, aug=None, mix=None):
        """One optimizer step on a batch that carries its images.  Returns
        the metrics (loss and the loss function's aux) as device tensors."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
                 if k in ("img", "img2", "label", "valid")}
        batch["label"] = batch["label"].long()
        if self.cfg.DATALOADER.DEVICE_AUG:
            batch["img"] = self.augment(batch["img"], aug)
        elif batch["img"].dtype == torch.uint8:
            batch["img"] = normalize_only(batch["img"], *self.pixel_stats)
        if self.use_mixup:
            perm, lam = self.mixup_draws(len(batch["label"])) if mix is None else mix
            batch["perm"] = torch.as_tensor(perm, device=self.device).long()
            batch["lam"] = torch.as_tensor(lam, dtype=torch.float32, device=self.device)
        params = list(self.params.values())
        loss, aux = self.loss_fn(self.params, self.frozen, batch)
        grads = torch.autograd.grad(loss, params)
        self.optim.step(grads)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["loss"] = loss.detach()
        return metrics

    def train_step_resident(self, index, valid=None, aug=None, mix=None):
        """One step on cache rows ``index`` (gathered on the device)."""
        index = torch.as_tensor(index, device=self.device).long()
        batch = {"img": self.cache[index], "label": self.labels[index]}
        if valid is not None:
            batch["valid"] = valid
        return self.train_step(batch, aug, mix)

    def forward_backward(self, batch, aug=None, mix=None):
        if "img" not in batch:  # index-only batch -> resident gather
            return self.train_step_resident(batch["index"], batch.get("valid"), aug, mix)
        return self.train_step(batch, aug, mix)

    # ------------------------------------------------------------------- loop
    def epoch_schedule(self):
        """This epoch's (index, valid), each (steps_per_epoch, B): a
        permutation of the cache drawn from the generator, padded with its
        last element (valid False) when the epoch needs more than N items
        (parity: build_schedule, trainer.py:226-252)."""
        n, B, steps = len(self.cache), self.batch_size, self.steps_per_epoch
        perm = torch.randperm(n, generator=self.generator, device=self.device)
        total = steps * B
        if total > n:
            perm = torch.cat([perm, perm[-1:].expand(total - n)])
        index = perm[:total].reshape(steps, B)
        valid = (torch.arange(total, device=self.device) < n).reshape(steps, B)
        return index, valid

    def before_epoch(self):
        pass

    def run_epoch(self):
        """``steps_per_epoch`` resident steps; the metrics are read back once,
        at the end.  Returns them as a list of {name: float}."""
        index, valid = self.epoch_schedule()
        if self.use_mixup:
            self.draw_epoch_lams()
        pending = []
        for self.batch_idx in range(self.steps_per_epoch):
            pending.append(self.train_step_resident(index[self.batch_idx], valid[self.batch_idx]))
        host = [{k: float(v) for k, v in m.items()} for m in pending]
        for bi, m in enumerate(host):
            if not math.isfinite(m["loss"]):
                raise FloatingPointError(f"Loss is infinite or NaN at epoch {self.epoch} "
                                         f"step {bi}: {m}")
        return host

    def after_epoch(self):
        pass

    def train(self, start_epoch=None, max_epoch=None):
        """Run the epochs; returns each epoch's run_epoch() metrics."""
        self.start_epoch = start_epoch if start_epoch is not None else self.start_epoch
        self.max_epoch = max_epoch if max_epoch is not None else self.max_epoch
        history = []
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            history.append(self.run_epoch())
            self.after_epoch()
        return history

    # ------------------------------------------------------------------- test
    @torch.no_grad()
    def test(self, images, labels, return_pred=False):
        """Evaluate on a uint8 (N, P, P, 3) test cache and its (N,) labels in
        batches of DATALOADER.TEST.BATCH_SIZE, each normalized only (no
        augmentation), as the test loader gives them.  With
        ``text_features_fn`` the class text features are computed once, then
        ``image_logits_fn`` per batch (trainer.py:262-270, 688-704); else
        ``logits_fn`` per batch.  Prints the evaluator's result block and
        returns the top-1 accuracy (%), or (y_true, y_pred) with
        ``return_pred``."""
        images = torch.as_tensor(images)
        labels = np.asarray(labels)
        if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"images must be uint8 (N, P, P, 3), got {images.dtype} "
                             f"{tuple(images.shape)}")
        if labels.shape != tuple(images.shape[:1]):
            raise ValueError(f"need one label per image, got {labels.shape}")
        self.evaluator = Classification(self.cfg, dict(enumerate(self.classnames)))
        print(f"Evaluate on the *{self.cfg.TEST.SPLIT}* set")
        split = getattr(self, "text_features_fn", None) is not None
        txf = self.text_features_fn(self.params, self.frozen) if split else None
        B = self.cfg.DATALOADER.TEST.BATCH_SIZE
        for i in range(0, len(images), B):
            x = normalize_only(images[i:i + B].to(self.device), *self.pixel_stats)
            if split:
                logits = self.image_logits_fn(self.params, self.frozen, x, txf)
            else:
                logits = self.logits_fn(self.params, self.frozen, x)
            self.evaluator.process(logits.float().cpu().numpy(), labels[i:i + B])
        results = self.evaluator.evaluate()
        if return_pred:
            return self.evaluator.y_true, self.evaluator.y_pred
        return results["accuracy"]

    def get_current_lr(self):
        return self.lr_schedule.lr_at_epoch(self.epoch)

    def extra_state(self):
        """Trainer state beyond params and optimizer that a resume would
        restore (checkpoint save and resume are not ported)."""
        return {"rng_state": self.generator.get_state(),
                "mix_rng_state": self.mix_rng.bit_generator.state}
