"""The training loop, test(), checkpoints and the trainer registry
(counterpart of fsvlm_tpu.engine.trainer.SimpleTrainer).

A trainer is fed one of two ways:

- ``SimpleTrainer(cfg)``, as the JAX package's: the DataManager
  (``data/``) builds the dataset of DATASET.NAME with its few-shot
  subsets, the train loader (the host train transforms' views, or
  DATALOADER.DEVICE_AUG's uint8 images; the sampler of
  DATALOADER.TRAIN_X.SAMPLER) and the val and test loaders.  Under
  DEVICE_AUG and DATALOADER.DEVICE_RESIDENT (auto: when the set fits
  DEVICE_RESIDENT_BUDGET_MB) the whole train set goes to the device once
  (``RawDatasetWrapper.materialize``) and each step gathers its batch there
  by index; each epoch's index batches come from the sampler, as the JAX
  package's host schedule (trainer.py:442-568).  Otherwise each step's
  batch comes from the loader, copied to the device one batch ahead
  (``device_batches``).  ``train()`` then runs the JAX
  package's lifecycle: resume from the output directory (or cfg.RESUME),
  best-val selection and checkpoints at each epoch's end (TEST.FINAL_MODEL,
  TRAIN.CHECKPOINT_FREQ, the last epoch always), and after the last epoch
  the best model's (or the last) test().
- ``SimpleTrainer(cfg, classnames, images, labels)``: the class names, a
  uint8 image cache (N, P, P, 3) and its labels, moved to the device; each
  epoch is a permutation drawn on the device.  No data layer, no
  checkpoints: ``train()`` runs the epochs only.

The trainer keeps its state on ``device`` (default cuda): the prompt
tensors (fp32 leaves), the optimizer, and a ``torch.Generator`` that draws
the device-side permutation, under DEVICE_AUG the crop boxes and flips,
and under mixup each step's batch permutation.  Mixup's lam ~ Beta(alpha,
alpha) has no device sampler that takes a generator: the epoch's lams are
drawn on the host from a ``numpy.random.Generator`` seeded from SEED and
moved to the device once per epoch.  A step launches its work and returns
its metrics as device tensors, with no host sync; ``run_epoch`` reads them
back once, at the epoch's end, and prints the JAX package's train lines.

An epoch over the resident cache runs one of two ways, chosen by
``fuses_epoch`` as the JAX package chooses (trainer.py:450-467):

- fused (TRAIN.EPOCH_FUSE "auto", the default, or "on"; a trainer may veto
  "auto", as CoCoOp does past its batched-text limit; never in the zoo;
  across ranks on each rank's columns of the schedule): the epoch's
  schedule, and under mixup its lams, are
  copied into the static buffers of an ``engine/fused.py::FusedEpoch``,
  the first step runs eagerly, the second is captured as a CUDA graph and
  the rest are its replays, each step reading its row and lam at a device
  step counter and writing its metrics into a device buffer at it; on the
  CPU the same code runs eagerly.  The trajectory is bit-equal to the
  per-step path's.  Under TRAIN.DEVICE_SCHEDULE (Random or Sequential
  sampler) the schedule is built on the device from a generator seeded from
  (SEED, epoch) (``device_schedule``), else it is the host's;
- step by step ("off", a veto, or no resident cache): each step launched
  from Python, as below.

- ``train_step(batch, aug, mix, drop)``: a batch that carries its images
  ("img", and "img2" for the SimCLR objectives: float, already normalized;
  or uint8, augmented on the device under DEVICE_AUG, and normalized as
  ``eval_images`` normalizes), "label" and optionally "valid" / "index";
  ``aug`` = (boxes, flips), ``mix`` = (perm, lam) and ``drop`` (a
  trainer's dropout masks, see ``use_dropout``) hand in the step's draws
  (tests inject the JAX package's);
- ``train_step_resident(index, valid)``: indices into the cache, gathered on
  the device, as the JAX package's train_step_resident;
- ``test(split=...)`` on the loaders, or ``test(images, labels)`` on a
  uint8 cache: top-1 accuracy, text features once where the trainer
  splits its eval, the image tower from ``frozen_eval()`` (in int8 under
  MODEL.QUANT_INT8, ``ops/quant.py``);
- ``save_model`` / ``resume_model_if_exist`` / ``load_model``: the JAX
  package's checkpoint files (``engine/checkpoint.py``); a resume restores
  the prompts, the optimizer's momentum and step count, the generator, the
  mixup rng and the best val result.  As in the JAX package the samplers
  are not part of it: they restart from SEED.

Subclasses register with ``TRAINER_REGISTRY``, name their config node
(``trainer_cfg_key``: ``cfg.TRAINER.<key>``, whose PREC sets the compute
dtype) and implement ``build_model(clip)``, which sets ``params`` (dict of
fp32 tensors, possibly none: a trainer with nothing to train steps its loss
without a gradient; a nested tree is flat under dotted names, "text.q.0"
for the JAX tree's {"text": {"q": (A, B)}}), ``frozen``, ``use_mixup`` /
``mixup_alpha`` where they mix, ``use_dropout`` where a step draws dropout
masks (from ``dropout_draws()``, on the device from the generator), and
``loss_fn(params, frozen, batch) -> (loss, aux)``; under ``use_mixup`` the
batch carries its draws as "perm" and "lam", under ``use_dropout`` as
"drop"; for ``test()``, either
``text_features_fn(params, frozen)`` and ``image_logits_fn(params, frozen,
images, txf)`` (split eval) or ``logits_fn(params, frozen, images)``.
"""

import datetime
import math
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import DataManager, RawDatasetWrapper
from ..data.samplers import RandomSampler, SequentialSampler
from ..ops.preprocess import (
    crop_resize_flip_normalize,
    normalize_only,
    random_resized_crop_flip_normalize,
    sample_crop_boxes,
    sample_flips,
)
from ..ops.quant import calibrate_visual_amax, quantize_clip
from ..parallel import mesh
from ..utils import AverageMeter, MetricMeter, mkdir_if_missing
from ..utils.registry import Registry
from .checkpoint import (
    coerce_prompt_params,
    load_checkpoint,
    nest,
    resume_from_checkpoint,
    save_checkpoint,
)
from .evaluator import build_evaluator
from .fused import FusedEpoch
from .optim import build_optimizer, make_lr_schedule
from .tb import TensorboardWriter

TRAINER_REGISTRY = Registry("TRAINER")
STEP_KEYS = ("img", "img2", "label", "valid", "index")  # what a train step reads of a batch
OFF = ("off", "false", "0", "no")  # TRAIN.EPOCH_FUSE / DEVICE_SCHEDULE spellings of off
# the environment that the attention route reads at every call: a captured
# step keeps the route it was captured on
ROUTE_ENV = ("FSVLM_FORCE_PALLAS", "FSVLM_ATTN_BF16", "FSVLM_ATTN_REMAT")


def build_trainer(cfg, **kwargs):
    """The trainer of TRAINER.NAME, fed by the DataManager; ``kwargs`` go to
    its constructor (``device``, ``clip``, ``attn_impl``).  An unknown name
    raises KeyError listing the ported trainers."""
    from .. import trainers  # noqa: F401  (registers the ported trainers)

    name = cfg.TRAINER.NAME
    if name not in TRAINER_REGISTRY:
        raise KeyError(f"No trainer {name!r}; ported: {TRAINER_REGISTRY.registered_names()}")
    return TRAINER_REGISTRY.get(name)(cfg, **kwargs)


def sum_metrics(metrics):
    """A step's metrics summed over the ranks: each is this rank's part of a
    global row mean; as they are without a process group."""
    if not mesh.active():
        return metrics
    vals = [v.detach().clone() for v in metrics.values()]
    mesh.all_reduce_(vals)
    return dict(zip(metrics, vals))


class SimpleTrainer:
    model_name = None
    trainer_cfg_key = None  # the trainer's node of cfg.TRAINER
    use_mixup = False  # set by build_model: every step then draws (perm, lam)
    mixup_alpha = 1.0
    use_dropout = False  # set by build_model: every step then draws dropout masks
    step_keys = STEP_KEYS  # what train_step and device_batches keep of a batch
    # whether run_epoch may fuse an epoch over the resident cache (the zoo's
    # own run_epoch never does, as JAX's zoo has no train_epoch_resident)
    epoch_fusion = True
    # set by build_model where TRAIN.EPOCH_FUSE "auto" must run step by step
    # (printed); "on" overrides it
    _epoch_fuse_auto_off = False

    def __init__(self, cfg, classnames=None, images=None, labels=None, clip=None, device=None,
                 steps_per_epoch=None, attn_impl=None):
        """cfg: ``fsvlm_tpu_torch.config.Config``.  classnames: None to build
        the DataManager from cfg; else the label space, with images/labels
        the train set as a uint8 (N, P, P, 3) cache and (N,) integer labels.
        clip: an already built CLIP module on ``device`` (else one is loaded
        for MODEL.BACKBONE.NAME).  steps_per_epoch: default the train
        loader's length, or N // batch size (1 when N is smaller than a
        batch), as the JAX package's drop-last train loader.  attn_impl:
        None (the hand-written kernels on CUDA) or "plain", for comparisons
        only."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.check_cfg(cfg)
        self.attn_impl = attn_impl
        self.start_epoch = self.epoch = self.batch_idx = 0
        self.max_epoch = cfg.OPTIM.MAX_EPOCH
        self.output_dir = cfg.OUTPUT_DIR
        self.best_result = -np.inf
        self.generator = torch.Generator(device=self.device).manual_seed(max(cfg.SEED, 0))
        self.mix_rng = np.random.default_rng(max(cfg.SEED, 0))  # the epochs' mixup lams
        self.epoch_lams = None
        # on the device once: copying them at every step would sync the host
        self.pixel_stats = [torch.tensor(v, dtype=torch.float32, device=self.device)
                            for v in (cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)]
        self.dm = None
        self.train_loader_x = self.train_loader_u = self.val_loader = self.test_loader = None
        self.cache = self.labels = self.domains = None
        self._resident_off = False
        self._fused = None  # the fused epoch's FusedEpoch, made at its first epoch
        self._frozen_eval = None
        self._writer = None  # the TensorBoard writer, from before_train to after_train
        self._profiler = None  # FSVLM_PROFILE_DIR's torch.profiler, likewise
        if classnames is None:
            self.build_data_loader()
        else:
            self.classnames = list(classnames)
            self.lab2cname = dict(enumerate(self.classnames))
        self.num_classes = len(self.classnames)
        self.evaluator = build_evaluator(cfg, self.lab2cname)
        if images is not None:
            self.set_train_data(images, labels)
        self.build_model(clip)
        if cfg.MODEL.INIT_WEIGHTS:  # dassl's load_pretrained_weights (trainer.py:64-72)
            self.load_init_weights(load_checkpoint(cfg.MODEL.INIT_WEIGHTS))
            print(f'Initialized params from "{cfg.MODEL.INIT_WEIGHTS}"')
        self._build_optimizer(steps_per_epoch)
        self.sync_replicas()

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

    def build_data_loader(self):
        self.dm = dm = DataManager(self.cfg)
        self.train_loader_x, self.train_loader_u, self.val_loader, self.test_loader = (
            dm.train_loader_x, dm.train_loader_u, dm.val_loader, dm.test_loader)
        self.num_source_domains = dm.num_source_domains
        self.classnames = dm.dataset.classnames
        self.lab2cname = dm.lab2cname

    def build_model(self, clip):
        raise NotImplementedError

    def replica_tensors(self):
        """The state that every rank holds alike: the parameters and the
        optimizer's."""
        return list(self.params.values()) + (self.optim.tensors() if self.optim else [])

    def sync_replicas(self):
        """Rank 0's state on every rank (at build and after a resume: the JAX
        package's replicate, trainer.py:107-109); nothing on one process."""
        mesh.broadcast_(self.replica_tensors())
        self._fused = None  # recapture after any change of the state

    def load_init_weights(self, ckpt):
        """MODEL.INIT_WEIGHTS: the checkpoint's weights, as the JAX package's."""
        self.load_params(ckpt["state_dict"])

    def set_train_data(self, images, labels, domains=None):
        """Move the uint8 (N, P, P, 3) train images, their labels and (from
        the DataManager) their domains to the device, where every step
        gathers its batch and DEVICE_SCHEDULE its schedule."""
        images = torch.as_tensor(images)
        if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"images must be uint8 (N, P, P, 3), got {images.dtype} "
                             f"{tuple(images.shape)}")
        labels = torch.as_tensor(labels)
        if labels.shape != images.shape[:1]:
            raise ValueError(f"need one label per image, got {tuple(labels.shape)}")
        self.cache = images.to(self.device)
        self.labels = labels.to(self.device, torch.long)
        self.domains = None if domains is None else torch.as_tensor(domains).to(self.device,
                                                                               torch.long)

    def _build_optimizer(self, steps_per_epoch):
        if steps_per_epoch is None and self.dm is not None:
            steps_per_epoch = len(self.train_loader_x) if self.train_loader_x else 1
        if steps_per_epoch is None:
            n, B = (len(self.cache) if self.cache is not None else 0), self.batch_size
            steps_per_epoch = n // B if n >= B else 1
        self.steps_per_epoch = steps_per_epoch
        if self.params:
            self.optim, self.lr_schedule = build_optimizer(self.cfg, self.params.values(),
                                                           steps_per_epoch)
        else:  # nothing to train (zero-shot): the schedule only prints its LR
            self.optim = None
            self.lr_schedule = make_lr_schedule(self.cfg, steps_per_epoch, self.device)
        print(f"# params to be updated: {sum(p.numel() for p in self.params.values()):,}")

    @property
    def batch_size(self):
        return self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE

    def _maybe_device_cache(self):
        """The device-resident uint8 train set, built on first use when
        DATALOADER.DEVICE_RESIDENT allows and the set fits its budget (or
        is forced on); else None (trainer.py:308-372)."""
        if self.cache is not None or self.dm is None or self._resident_off:
            return self.cache
        mode = str(self.cfg.DATALOADER.DEVICE_RESIDENT).lower()
        if mode in OFF:
            return None
        wrapper = self.train_loader_x.wrapper
        if not isinstance(wrapper, RawDatasetWrapper):  # host-augmented batches
            if mode in ("true", "on", "1", "yes"):
                raise ValueError("DATALOADER.DEVICE_RESIDENT=on requires the device-aug "
                                 "raw-uint8 train pipeline (DATALOADER.DEVICE_AUG=True)")
            return None
        n = len(wrapper)
        nbytes = n * wrapper.pre_size * wrapper.pre_size * 3
        budget = int(self.cfg.DATALOADER.DEVICE_RESIDENT_BUDGET_MB) << 20
        if nbytes > budget and mode not in ("true", "on", "1", "yes"):
            print(f"* device-resident train set disabled: {nbytes >> 20} MB "
                  f"> budget {self.cfg.DATALOADER.DEVICE_RESIDENT_BUDGET_MB} MB")
            self._resident_off = True
            return None
        images = wrapper.materialize(num_threads=max(1, self.cfg.DATALOADER.NUM_WORKERS))
        data = wrapper.data_source
        self.set_train_data(images, np.asarray([it.label for it in data]),
                            np.asarray([it.domain for it in data]))
        print(f"* device-resident train set: {n} images x {wrapper.pre_size}^2 "
              f"({nbytes >> 20} MB) on {self.device}; per-step H2D is indices only")
        return self.cache

    # ------------------------------------------------------------------- steps
    def augment(self, images, aug=None):
        """DEVICE_AUG's random-resized-crop + flip + normalize of uint8
        images; ``aug`` = (boxes, flips) hands in the draws, else they come
        from the trainer's generator."""
        inp = self.cfg.INPUT
        if aug is None and mesh.distributed():  # the global batch's draws, this rank's rows
            B, H, W, _ = images.shape
            aug = (mesh.draw_rows(lambda n: sample_crop_boxes(n, H, W, inp.RRCROP_SCALE,
                                                              self.generator), B),
                   mesh.draw_rows(lambda n: sample_flips(n, self.generator), B))
        if aug is None:
            return random_resized_crop_flip_normalize(images, self.generator, inp.SIZE[0],
                                                      inp.RRCROP_SCALE, *self.pixel_stats)
        boxes, flips = aug
        return crop_resize_flip_normalize(images, boxes, flips, inp.SIZE[0], *self.pixel_stats)

    def eval_images(self, images):
        """uint8 eval views on the device -> the float images the towers
        take: normalized, as the JAX package's TestTransform, when
        "normalize" is in INPUT.TRANSFORMS, else x / 255."""
        if "normalize" in self.cfg.INPUT.TRANSFORMS:
            return normalize_only(images, *self.pixel_stats)
        return images.to(torch.float32) / 255.0

    def draw_epoch_lams(self):
        """This epoch's mixup lams, one per step, ~ Beta(alpha, alpha) (1 when
        alpha <= 0, as mixup_batch), drawn on the host and copied to the
        device in one copy, into the same tensor every epoch (a captured
        step reads it)."""
        n = self.steps_per_epoch
        a = self.mixup_alpha
        lams = torch.from_numpy((self.mix_rng.beta(a, a, n) if a > 0 else np.ones(n))
                                .astype(np.float32))
        if self.epoch_lams is None:
            self.epoch_lams = lams.to(self.device)
        else:
            self.epoch_lams.copy_(lams)

    def mixup_draws(self, batch_size):
        """This step's (perm, lam) on the device, with no host sync: a
        permutation of the batch from the generator (across ranks of the
        padded global batch, the same on every rank, as ``augment`` draws
        its boxes), and the epoch's lam at this step: in a fused epoch read
        at the device step counter, else a view of the device tensor
        (indexing it by a Python int reads nothing back)."""
        if self.epoch_lams is None:
            self.draw_epoch_lams()
        perm = torch.randperm(batch_size * mesh.world_size(), generator=self.generator,
                              device=self.device)
        n = len(self.epoch_lams)
        if self._fused is not None and self._fused.active:
            return perm, self.epoch_lams.index_select(0, self._fused.counter.view(1) % n)[0]
        return perm, self.epoch_lams[self.batch_idx % n]

    def dropout_draws(self):
        """This step's dropout draw source, on the device from the generator
        (trainers that set ``use_dropout``)."""
        raise NotImplementedError

    def train_step(self, batch, aug=None, mix=None, drop=None):
        """One optimizer step on a batch that carries its images (with no
        parameters, the loss alone, without a gradient).  Returns the
        metrics (loss and the loss function's aux) as device tensors."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
                 if k in self.step_keys}
        batch["label"] = batch["label"].long()
        if "index" in batch:
            batch["index"] = batch["index"].long()
        if self.cfg.DATALOADER.DEVICE_AUG:
            batch["img"] = self.augment(batch["img"], aug)
        for k in ("img", "img2"):  # host views: uint8 normalized here, float as they are
            if k in batch and batch[k].dtype == torch.uint8:
                batch[k] = self.eval_images(batch[k])
        if self.use_mixup:
            perm, lam = self.mixup_draws(len(batch["label"])) if mix is None else mix
            batch["perm"] = torch.as_tensor(perm, device=self.device).long()
            batch["lam"] = torch.as_tensor(lam, dtype=torch.float32, device=self.device)
        if self.use_dropout:
            batch["drop"] = self.dropout_draws() if drop is None else drop
        params = list(self.params.values())
        with torch.set_grad_enabled(bool(params)):
            loss, aux = self.loss_fn(self.params, self.frozen, batch)
        if params:
            self.optim.step(torch.autograd.grad(loss, params))
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["loss"] = loss.detach()
        return sum_metrics(metrics)

    def train_step_resident(self, index, valid=None, aug=None, mix=None, drop=None):
        """One step on cache rows ``index`` (gathered on the device)."""
        index = torch.as_tensor(index, device=self.device).long()
        batch = {"img": self.cache[index], "label": self.labels[index], "index": index}
        if valid is not None:
            batch["valid"] = valid
        return self.train_step(batch, aug, mix, drop)

    def forward_backward(self, batch, aug=None, mix=None, drop=None):
        if "img" not in batch:  # index-only batch -> resident gather
            return self.train_step_resident(batch["index"], batch.get("valid"), aug, mix, drop)
        return self.train_step(batch, aug, mix, drop)

    # ------------------------------------------------------------------- loop
    def epoch_schedule(self):
        """This epoch's (index, valid), each (steps, B) on the device: the
        train loader's sampler order (its index batches, as the JAX
        package's host schedule), or without a loader a permutation of the
        cache drawn from the generator, padded with its last element (valid
        False) when the epoch needs more than N items (build_schedule,
        trainer.py:226-252)."""
        if self.dm is not None:
            batches = list(self.train_loader_x.iter_index_batches())
            return tuple(torch.from_numpy(np.stack([b[k] for b in batches])).to(self.device)
                         for k in ("index", "valid"))
        n, B, steps = len(self.cache), self.batch_size, self.steps_per_epoch
        perm = torch.randperm(n, generator=self.generator, device=self.device)
        total = steps * B
        if total > n:
            perm = torch.cat([perm, perm[-1:].expand(total - n)])
        index = perm[:total].reshape(steps, B)
        valid = (torch.arange(total, device=self.device) < n).reshape(steps, B)
        return index, valid

    def shard_x(self, batch, world=None, index=None):
        """This rank's rows of a host train_x batch (``mesh.shard_batch``)."""
        return mesh.shard_batch(batch, world, index)

    def device_batches(self, batches, shard=mesh.shard_batch):
        """The loader's batches on the device, each copied while the step
        before it is queued (the JAX package's device_batches,
        trainer.py:469-484): from pinned host memory, without blocking the
        host.  Across ranks, this rank's rows of each (``shard``: train_x's
        by ``shard_x``)."""
        ahead = None
        for batch in batches:
            if mesh.active():
                batch = shard({k: batch[k] for k in self.step_keys if k in batch})
            cur = {}
            for k in self.step_keys:
                if k in batch:
                    t = torch.from_numpy(np.ascontiguousarray(batch[k]))
                    if self.device.type == "cuda":
                        t = t.pin_memory()
                    cur[k] = t.to(self.device, non_blocking=True)
            if ahead is not None:
                yield ahead
            ahead = cur
        if ahead is not None:
            yield ahead

    def before_train(self):
        """With the DataManager: resume from cfg.RESUME, else from the output
        directory, then make it and open the TensorBoard writer in its
        ``tensorboard`` folder (trainer.py:284-293).  Then, where
        FSVLM_PROFILE_DIR is set, start a torch.profiler over the CPU and (on
        the card) CUDA activities, which ``after_train`` stops and writes
        into that directory as one Chrome trace (the JAX package's
        jax.profiler trace, :295-302)."""
        if self.dm is not None:
            self.resume_model_if_exist(self.cfg.RESUME or self.output_dir)
            self.sync_replicas()
            mkdir_if_missing(self.output_dir)
            if mesh.is_main():  # one writer (trainer.py:291)
                self._writer = TensorboardWriter(os.path.join(self.output_dir, "tensorboard"))
        profile_dir = os.environ.get("FSVLM_PROFILE_DIR")
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            mkdir_if_missing(profile_dir)
            self._profiler = profile(activities=activities)
            self._profiler.start()

    def _stop_profiler(self):
        """Stop FSVLM_PROFILE_DIR's profiler, if one runs, and write its
        Chrome trace there."""
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.stop()
        path = os.path.join(os.environ["FSVLM_PROFILE_DIR"],
                            f"trace.{os.getpid()}.{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        print(f"Profiler trace written to {path}")

    def before_epoch(self):
        pass

    def fuses_epoch(self):
        """Whether run_epoch fuses this epoch, by the JAX package's rules
        (trainer.py:450-467): a resident cache, steps to run, TRAIN.EPOCH_FUSE
        not off (and under "auto" no veto of the trainer's) and a trainer
        with a resident step; across ranks too, as the JAX package fuses
        over its mesh."""
        mode = str(self.cfg.TRAIN.EPOCH_FUSE).lower()
        return (self._maybe_device_cache() is not None
                and self._num_batches() > 0
                and mode not in OFF
                and not (mode == "auto" and self._epoch_fuse_auto_off)
                and self.epoch_fusion)

    def _num_batches(self):
        return len(self.train_loader_x) if self.dm is not None else self.steps_per_epoch

    def run_epoch(self):
        """The epoch's steps, resident where the train set is on the device,
        else on the loader's batches; the metrics are read back once,
        at the end, and printed as the JAX package's train lines.  Returns
        them as a list of {name: float}.  Fused (``fuses_epoch``): the
        resident steps as replays of one captured step."""
        if self.fuses_epoch():
            return self._run_epoch_fused()
        t0 = time.time()
        if self._maybe_device_cache() is not None:
            index, valid = self.epoch_schedule()
            if mesh.active():  # every rank's cache, each rank's columns
                index, valid = mesh.shard_columns(index, valid)
            steps = zip(index, valid)
        else:
            steps = self.device_batches(self.train_loader_x, self.shard_x)
        data_time = time.time() - t0
        if self.use_mixup:
            self.draw_epoch_lams()
        pending = []
        for self.batch_idx, step in enumerate(steps):
            if isinstance(step, dict):
                pending.append(self.train_step(step))
            else:
                pending.append(self.train_step_resident(*step))
        host = [{k: float(v) for k, v in m.items()} for m in pending]
        self._check_finite(host)
        self._print_train_lines(host, time.time() - t0, data_time)
        return host

    def _check_finite(self, host):
        for bi, m in enumerate(host):
            if not math.isfinite(m["loss"]):
                raise FloatingPointError(f"Loss is infinite or NaN at epoch {self.epoch} "
                                         f"step {bi}: {m}")

    def device_schedule(self, num_batches):
        """TRAIN.DEVICE_SCHEDULE's epoch schedule, built on the device
        (trainer.py:212-252, :374-408): under a RandomSampler a permutation
        of the resident set from a generator seeded from (SEED, epoch) alone,
        so a pure function of the epoch (JAX: fold_in(epoch_key, 1 << 20));
        under a SequentialSampler an arange; cut to ``num_batches`` x B
        (drop-last), or padded with its last element (valid False), and the
        labels and domains gathered.  {"index", "valid", "label", "domain"},
        each (steps, B); None when off, without the DataManager's resident
        set, or (printed) for another sampler.  The order is not the host
        sampler's, nor JAX's threefry order: the documented divergence that
        the default (off) keeps out of the default path."""
        if str(self.cfg.TRAIN.DEVICE_SCHEDULE).lower() in OFF + ("",) or self.domains is None:
            return None
        sampler = self.train_loader_x.sampler
        if not isinstance(sampler, (RandomSampler, SequentialSampler)):
            print("* TRAIN.DEVICE_SCHEDULE: unsupported sampler "
                  f"{type(sampler).__name__}; falling back to host schedule")
            return None
        n, B, dev = len(self.cache), self.train_loader_x.batch_size, self.device
        if isinstance(sampler, RandomSampler):
            seed = np.random.SeedSequence((max(self.cfg.SEED, 0), self.epoch, 1 << 20))
            gen = torch.Generator(device=dev).manual_seed(int(seed.generate_state(1, np.uint64)[0]))
            perm = torch.randperm(n, generator=gen, device=dev)
        else:
            perm = torch.arange(n, device=dev)
        total = num_batches * B
        if total > n:  # pad as the host path pads: repeat the last element
            perm = torch.cat([perm, perm[-1:].expand(total - n)])
        index = perm[:total].reshape(num_batches, B)
        valid = (torch.arange(total, device=dev) < n).reshape(num_batches, B)
        return {"index": index, "valid": valid, "label": self.labels[index],
                "domain": self.domains[index]}

    def _fused_key(self):
        """What a captured step depends on besides its buffers."""
        return (self.batch_size, self.compute_dtype(), self.use_mixup, self.use_dropout,
                tuple(os.environ.get(k) for k in ROUTE_ENV))

    def _fused_step(self):
        """One step of the fused epoch: the schedule's row at the device
        step counter, gathered from the cache (train_step_resident's batch,
        its label from the schedule)."""
        f = self._fused
        index = f.row(f.index)
        batch = {"img": self.cache[index], "label": f.row(f.label), "index": index,
                 "valid": f.row(f.valid)}
        return self.train_step(batch)

    def _run_epoch_fused(self):
        """The epoch as the JAX package's fused epoch runs it (trainer.py:508-568):
        its schedule (DEVICE_SCHEDULE's, else the host one ``epoch_schedule``
        gives the per-step path) and mixup lams copied into the static
        buffers of a ``FusedEpoch``, the steps run as replays of one
        captured step (on the CPU, eagerly), and the metrics read back once
        and printed as the per-step path prints them.  Across ranks each
        rank loads its columns of the schedule, padded as ``shard_batch``
        pads (the JAX package's P(None, "data"), trainer.py:535-551); the
        step's collectives (the gradients', the metrics', the gathers) are
        captured with it, the eager warm-up step having made the
        communicator.  A non-finite loss raises FloatingPointError at the
        epoch's end, naming the step, after every step ran
        (trainer.py:518-521)."""
        t0 = time.time()
        sched = self.device_schedule(self._num_batches())
        if sched is None:
            index, valid = self.epoch_schedule()
            sched = {"index": index, "valid": valid, "label": self.labels[index]}
        if mesh.active():  # every rank's schedule, each rank's columns
            sched = dict(zip(("index", "valid", "label"), mesh.shard_columns(
                sched["index"], sched["valid"], sched["label"])))
        steps, B = sched["index"].shape
        if self.use_mixup:
            self.draw_epoch_lams()
        key = self._fused_key()
        if self._fused is None or not self._fused.fits(steps, key):
            self._fused = FusedEpoch(self.device, steps, B, key, type(self).__name__)
        f = self._fused
        f.load(sched["index"], sched["valid"], sched["label"])
        data_time = time.time() - t0
        f.active = True
        try:
            f.run(steps, self._fused_step, self.generator)
        finally:
            f.active = False
        self.batch_idx = steps - 1
        host = f.host_metrics(steps)
        self._check_finite(host)
        self._print_train_lines(host, time.time() - t0, data_time)
        return host

    def _print_train_lines(self, host, seconds, data_time):
        """The per-step lines of the JAX package's fused epoch
        (trainer.py:417-430, :558-568), every TRAIN.PRINT_FREQ steps and at
        the last: the epoch's time spread over its steps."""
        losses, batch_time, data = MetricMeter(), AverageMeter(), AverageMeter()
        data.update(data_time)
        n = len(host)
        per_step = max(seconds - data_time, 0.0) / max(n, 1)
        for bi, m in enumerate(host):
            batch_time.update(per_step + (data_time if bi == 0 else 0.0))
            losses.update(m)
            if self._writer:  # trainer.py:432-440
                n_iter = self.epoch * n + bi
                for name, meter in losses.meters.items():
                    self._writer.scalar(f"train/{name}", meter.avg, n_iter)
                self._writer.scalar("train/lr", self.get_current_lr(), n_iter)
            if (bi + 1) % self.cfg.TRAIN.PRINT_FREQ == 0 or bi + 1 == n:
                remain = (n - bi - 1) + (self.max_epoch - self.epoch - 1) * n
                eta = datetime.timedelta(seconds=int(batch_time.avg * remain))
                print(f"epoch [{self.epoch + 1}/{self.max_epoch}][{bi + 1}/{n}]\t"
                      f"time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                      f"data {data.val:.3f} ({data.avg:.3f})\t{losses}\t"
                      f"lr {self.get_current_lr():.4e}\teta {eta}")

    def after_epoch(self):
        """With the DataManager: the val test and the best-val save under
        TEST.FINAL_MODEL best_val; a checkpoint every CHECKPOINT_FREQ epochs
        and after the last (trainer.py:590-607)."""
        if self.dm is None:
            return
        cfg = self.cfg
        last_epoch = (self.epoch + 1) == self.max_epoch
        meet_freq = (cfg.TRAIN.CHECKPOINT_FREQ > 0
                     and (self.epoch + 1) % cfg.TRAIN.CHECKPOINT_FREQ == 0)
        if not cfg.TEST.NO_TEST and cfg.TEST.FINAL_MODEL == "best_val" and self.val_loader:
            curr_result = self.test(split="val")
            if curr_result > self.best_result:
                self.best_result = curr_result
                self.save_model(self.epoch, self.output_dir, val_result=curr_result,
                                model_name="model-best.pkl")
        if meet_freq or last_epoch:
            self.save_model(self.epoch, self.output_dir)

    def after_train(self):
        """Stop FSVLM_PROFILE_DIR's profiler; with the DataManager, deploy the
        best-val model (or keep the last), test it and close the TensorBoard
        writer (trainer.py:609-625)."""
        self._stop_profiler()
        if self.dm is None:
            return None
        print("Finish training")
        result = None
        if not self.cfg.TEST.NO_TEST:
            if self.cfg.TEST.FINAL_MODEL == "best_val":
                print("Deploy the model with the best val performance")
                if mesh.is_main():  # rank 0 wrote it; the other ranks take its state
                    self.load_model(self.output_dir)
                self.sync_replicas()
            result = self.test()
        elapsed = round(time.time() - self.time_start)
        print(f"Elapsed: {datetime.timedelta(seconds=elapsed)}")
        if self._writer is not None:
            self._writer.close()
        return result

    def train(self, start_epoch=None, max_epoch=None):
        """Run the lifecycle; returns each epoch's run_epoch() metrics."""
        self.start_epoch = start_epoch if start_epoch is not None else self.start_epoch
        self.max_epoch = max_epoch if max_epoch is not None else self.max_epoch
        self.time_start = time.time()
        self.before_train()
        history = []
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            history.append(self.run_epoch())
            self.after_epoch()
        self.after_train()
        return history

    # ------------------------------------------------------------------- test
    @torch.no_grad()
    def test(self, images=None, labels=None, split=None, return_pred=False):
        """Top-1 accuracy (%) on the ``split`` loader (TEST.SPLIT by default;
        "val" falls back to test without a val set), or on a uint8 (N, P, P,
        3) cache ``images`` and its (N,) ``labels`` in batches of
        DATALOADER.TEST.BATCH_SIZE.  Each batch is normalized only (no
        augmentation).  With ``text_features_fn`` the class text features
        are computed once, then ``image_logits_fn`` per batch
        (trainer.py:262-270, 688-704); else ``logits_fn`` per batch.  Prints
        the evaluator's result block; returns the accuracy, or (y_true,
        y_pred) with ``return_pred``."""
        if images is not None:
            images = torch.as_tensor(images)
            labels = np.asarray(labels)
            if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
                raise ValueError(f"images must be uint8 (N, P, P, 3), got {images.dtype} "
                                 f"{tuple(images.shape)}")
            if labels.shape != tuple(images.shape[:1]):
                raise ValueError(f"need one label per image, got {labels.shape}")
            split = self.cfg.TEST.SPLIT
            B = self.cfg.DATALOADER.TEST.BATCH_SIZE
            batches = ((images[i:i + B], labels[i:i + B], None) for i in range(0, len(images), B))
        else:
            split = split or self.cfg.TEST.SPLIT
            if split == "val" and self.val_loader is not None:
                loader = self.val_loader
            else:
                split, loader = "test", self.test_loader
            batches = ((torch.from_numpy(b["img"]), b["label"], b["valid"]) for b in loader)
        self.evaluator = build_evaluator(self.cfg, self.lab2cname)
        print(f"Evaluate on the *{split}* set")
        split_eval = getattr(self, "text_features_fn", None) is not None
        txf = self.text_features_fn(self.params, self.frozen) if split_eval else None
        frozen = self.frozen_eval()
        for x, y, valid in batches:
            n = len(x)  # across ranks: this rank's rows, then the gathered logits
            x = self.eval_images(mesh.shard_rows(x).to(self.device))
            if split_eval:
                logits = self.image_logits_fn(self.params, frozen, x, txf)
            else:
                logits = self.logits_fn(self.params, frozen, x)
            logits = mesh.gather_rows(logits.float())[:n].cpu().numpy()
            if valid is not None:
                logits, y = logits[valid], y[valid]
            self.evaluator.process(logits, y)
        results = self.evaluator.evaluate()
        for k, v in results.items():  # trainer.py:711-712
            if self._writer:
                self._writer.scalar(f"{split}/{k}", v, self.epoch)
        if return_pred:
            return self.evaluator.y_true, self.evaluator.y_pred
        return results["accuracy"]

    @torch.no_grad()
    def model_inference(self, images):
        """Logits of float (B, H, W, 3) images (``eval_images``' output) on
        the eval towers (``frozen_eval``): ``logits_fn``, or the split eval
        with the class text features computed anew."""
        frozen = self.frozen_eval()
        if getattr(self, "text_features_fn", None) is not None:
            txf = self.text_features_fn(self.params, self.frozen)
            return self.image_logits_fn(self.params, frozen, images, txf)
        return self.logits_fn(self.params, frozen, images)

    # ------------------------------------------------------------------ int8
    def frozen_eval(self):
        """The frozen state that test() and ``model_inference`` run
        (trainer.py:627-669): ``frozen``, or under MODEL.QUANT_INT8, built
        once at first use, a copy whose CLIP has its ViT image tower in int8
        (QUANT_INT8_FAMILIES; under QUANT_INT8_STATIC static activation
        scales calibrated over the first QUANT_INT8_CALIB_BATCHES batches
        of the test loader, or of the train loader where there is none).
        The text tower and training stay float; a ModifiedResNet tower or a
        trainer without a frozen CLIP is left as it is."""
        if self._frozen_eval is not None:
            return self._frozen_eval
        fe = self.frozen
        clip = fe.get("clip") if isinstance(fe, dict) else None
        if self.cfg.MODEL.QUANT_INT8 and clip is not None and clip.cfg.is_vit:
            families = tuple(self.cfg.MODEL.QUANT_INT8_FAMILIES or ("attn", "mlp"))
            qclip, static = self.int8_image_tower(clip, families, self.test_loader
                                                  or self.train_loader_x)
            print(f"[eval] int8 image tower (MODEL.QUANT_INT8, families={','.join(families)}, "
                  f"act={'static' if static else 'dynamic'})")
            fe = dict(fe, clip=qclip)
        self._frozen_eval = fe
        return fe

    def int8_image_tower(self, clip, families, loader):
        """(CLIP with its image tower in int8, whether its activation scales
        are static): dynamic scales, or under MODEL.QUANT_INT8_STATIC static
        ones calibrated on the float tower over the first
        QUANT_INT8_CALIB_BATCHES batches of ``loader`` (uint8 views
        normalized as ``eval_images``, float views as they are).  Without a
        loader (a trainer fed tensors) static scales raise ValueError."""
        static_amax = None
        m = self.cfg.MODEL
        if m.QUANT_INT8_STATIC:
            if loader is None:
                raise ValueError("MODEL.QUANT_INT8_STATIC calibrates on the DataManager's loaders, "
                                 "and this trainer was fed tensors: build it from cfg alone, or "
                                 "unset QUANT_INT8_STATIC")

            def batches():
                for i, batch in enumerate(loader):
                    if i >= m.QUANT_INT8_CALIB_BATCHES:
                        break
                    x = torch.from_numpy(np.ascontiguousarray(batch["img"])).to(self.device)
                    yield self.eval_images(x) if x.dtype == torch.uint8 else x

            static_amax = {"visual": calibrate_visual_amax(clip, batches(),
                                                           attn_impl=self.attn_impl)}
        return quantize_clip(clip, towers=("visual",), families=families,
                             static_amax=static_amax), static_amax is not None

    def get_current_lr(self):
        return self.lr_schedule.lr_at_epoch(self.epoch)

    # ------------------------------------------------------------ checkpoints
    def extra_state(self):
        """Trainer state beyond params and optimizer that a resume restores,
        as numpy and builtins."""
        return {"rng_state": self.generator.get_state().numpy(),
                "mix_rng_state": self.mix_rng.bit_generator.state,
                "best_result": float(self.best_result)}

    def load_extra_state(self, state):
        self._fused = None  # recapture after any change of the state
        if state.get("rng_state") is not None:
            self.generator.set_state(torch.from_numpy(np.array(state["rng_state"], np.uint8)))
        if state.get("mix_rng_state") is not None:
            self.mix_rng.bit_generator.state = state["mix_rng_state"]
        if state.get("best_result") is not None:
            self.best_result = float(state["best_result"])

    @torch.no_grad()
    def load_params(self, loaded):
        """Copy a checkpoint's state_dict into the live prompt tensors (in
        place: the optimizer holds them), name by name where the shape
        fits (trainer.py:768-806)."""
        for name, value in coerce_prompt_params(self.params, loaded).items():
            if value is not self.params[name]:
                self.params[name].copy_(value)

    def save_model(self, epoch, directory, val_result=None, model_name=""):
        save_checkpoint({
            "state_dict": nest(self.params),
            "epoch": epoch + 1,
            "optimizer": self.optim.state_dict(list(self.params)),
            "val_result": val_result,
            "extra": self.extra_state(),
        }, os.path.join(directory, self.model_name), model_name=model_name)

    def resume_model_if_exist(self, directory):
        ckpt = resume_from_checkpoint(os.path.join(directory, self.model_name))
        if ckpt is None:
            print(f'No checkpoint found in "{directory}", train from scratch')
            return 0
        self.load_params(ckpt["state_dict"])
        optim_state = ckpt.get("optimizer")
        if isinstance(optim_state, dict) and self.optim.accepts(optim_state):
            self.optim.load_state_dict(optim_state, list(self.params))
        elif isinstance(optim_state, dict) and "count" in optim_state:
            print(f"Warning: the checkpoint holds the state of optimizer "
                  f"{optim_state.get('name', 'sgd')!r}, and this run's is {self.optim.name!r}: "
                  f"not loaded; the moments and the schedule's step count restart")
        else:
            print("Warning: the checkpoint holds no optimizer state of this package (a JAX "
                  "package checkpoint?); the momentum and the schedule's step count restart")
        self.start_epoch = ckpt["epoch"]
        self.load_extra_state(ckpt.get("extra") or {})
        print(f"Resumed from epoch {self.start_epoch}")
        return self.start_epoch

    def load_model(self, directory, epoch=None):
        """Load ``<directory>/<model_name>/model-best.pkl`` (or
        ``model.pkl-<epoch>``; the ``checkpoint`` pointer when there is no
        best file)."""
        if not directory:
            print("Skip load_model (no pretrained path given)")
            return
        name = "model-best.pkl" if epoch is None else f"model.pkl-{epoch}"
        path = os.path.join(directory, self.model_name, name)
        if not os.path.exists(path) and epoch is None:
            ckpt = resume_from_checkpoint(os.path.join(directory, self.model_name))
        else:
            ckpt = load_checkpoint(path)
        if ckpt is None:
            raise FileNotFoundError(f"No checkpoint under {directory}")
        print(f'Load model from "{directory}" (epoch {ckpt["epoch"]}, '
              f'val_result {ckpt.get("val_result")})')
        self.load_params(ckpt["state_dict"])
        self._fused = None
