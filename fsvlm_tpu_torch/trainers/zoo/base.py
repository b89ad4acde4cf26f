"""Whole-network trainer bases of the Dassl zoo (counterpart of
fsvlm_tpu.trainers.zoo.base).

The CLIP trainers tune a few prompt tensors against frozen towers; the zoo
trains whole CNNs (``nets``: group -> ``nn.Module``, by default {"net":
SimpleNet}) with BatchNorm statistics (``model_state``: group -> nested
dict of tensors, threaded through every forward and kept only where the
JAX step keeps them) and method state (``extra``).  A method's
``build_method()`` sets its groups and ``step_core(bx, bu, step, draws)``,
which runs one train step in place (forwards, ``torch.autograd.grad``, the
groups' optimizer steps in the JAX step's order) and returns its metrics
as device tensors: no host sync.  ``step`` is the global iteration (a host
int), ``draws`` the step's random source (``models.draws``: the trainer's
generator, or values handed in).

- ``param_groups``: None, one optimizer over every group (the JAX
  package's single optax state), or the groups that each get their own
  optimizer state and step count (the reference registers one torch
  optimizer per model, dassl trainer.py:86-116); a group stepped k > 1
  times per iteration (``group_updates_per_step``) sees lr(count // k).
- Batches: "img" (and DAELDG's "img2") as the loader gives them, NHWC,
  uint8 normalized as ``eval_images`` or float as they are (float32, or
  float64 for a net held in float64), then NCHW;
  "label" and "domain" (``step_keys`` keep "domain", which the base
  trainer's drop), "valid".
- Checkpoints hold the JAX trainer's trees: ``state_dict`` the groups'
  params in the JAX layout (models/convert.py), ``extra`` the BN
  statistics (``model_state``) and ``method_extra``: ``extra`` (tensors
  and their trees, as they are) and the weights of ``extra_nets`` (a
  method's frozen copies of a network: ADDA's source model, SE's and
  MeanTeacher's teachers) in the JAX layout; ``optimizer`` the port's per-group optimizer states.
  ``load_model`` restores the statistics too, and so does MODEL.INIT_WEIGHTS
  from a zoo checkpoint that holds them (the JAX package's restore the
  weights alone, so its --eval-only tests a zoo net on its initial
  statistics, and its ADDA freezes its source model on them: ROADMAP C.2).
- ``param_groups = []``: nothing to update (AdaBN), no optimizer.
- DATALOADER.DEVICE_AUG raises ValueError (base.py:103-109).

NetTrainerX runs labeled epochs on train_x; NetTrainerXU zips train_x and
train_u cyclically for TRAIN.COUNT_ITER's number of steps (train_x,
train_u or smaller_one, dassl trainer.py:560-610).

Across ranks (``parallel.mesh``) a step computes the JAX package's step
on its mesh over the same padded global batch: the masked means, moments
and pair means are the global batch's, the step's metrics are summed over
the ranks and ``replica_tensors`` (weights, statistics, ``extra``,
``extra_nets``, the optimizers) are broadcast from rank 0 at build and
after a resume.  A backbone's own draws (dropout, style mixing) are drawn
for the global batch and sliced (``mesh.draw_rows``).  The train_x batch
is sharded by ``shard_x``: contiguous rows (``mesh.shard_batch``), or for
the methods that cut it into per-domain blocks (DAELDG, M3SDA, DAEL) each
rank's share of every block (``mesh.shard_blocks``), each block then one
forward on every rank (``block_forward``), its losses under ``block_mask``.
"""

import copy
import itertools
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ...engine.checkpoint import load_checkpoint, resume_from_checkpoint, save_checkpoint
from ...engine.optim import build_optimizer, make_lr_schedule
from ...engine.trainer import STEP_KEYS, SimpleTrainer, sum_metrics
from ...models.convert import flatten, load_params, load_state, params_tree, state_tree
from ...models.backbones.common import TO_PORT
from ...models.draws import Draws
from ...models.simple_net import SimpleNet
from ...parallel import mesh

# ---------------------------------------------------------------- metrics


def cross_entropy_logits(logits, labels, valid=None):
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return masked_mean(nll, valid)


def masked_mean(x, valid):
    """Mean of ``x`` over its valid rows (every element without a mask),
    over the global batch across ranks (``parallel.mesh``)."""
    return mesh.global_mean(x, valid)


def masked_row_mean(x, valid):
    """Mean over rows of a per-row mean: rows weighted by ``valid``."""
    return masked_mean(x.reshape(x.shape[0], -1).mean(1), valid)


def masked_pair_mean(x, valid):
    """Mean of a pairwise (B, B) matrix where both rows are valid; across
    ranks this rank's rows against the global batch's columns, over the
    global count of valid pairs (``parallel.mesh``)."""
    return mesh.global_pair_mean(x, valid)


def masked_moments(f, valid, ddof=0):
    """Row-masked per-feature mean and variance of ``f`` (B, D), of the
    global batch across ranks (``parallel.mesh``)."""
    return mesh.global_moments(f, valid, ddof)


def accuracy(logits, labels, valid=None):
    return 100.0 * masked_mean((logits.argmax(-1) == labels).float(), valid)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _leaves(tree):
    return [t for v in tree.values() for t in (_leaves(v) if isinstance(v, dict) else [v])]


def grads_of(loss, modules):
    """d loss / d each module's parameters, a list per module; zeros where
    the loss does not reach a parameter (ADDA's classifier), as jax.grad."""
    params = [list(m.parameters()) for m in modules]
    flat = torch.autograd.grad(loss, [p for ps in params for p in ps], allow_unused=True)
    out, i = [], 0
    for ps in params:
        out.append([torch.zeros_like(p) if g is None else g
                    for p, g in zip(ps, flat[i:i + len(ps)])])
        i += len(ps)
    return out


class NetTrainerX(SimpleTrainer):
    """Labeled-only zoo base (TrainerX)."""

    model_name = "model"
    param_groups = None
    # the default net without a classifier: a feature extractor, SimpleNet(cfg,
    # MODEL, 0), for the methods that own their heads (MCD, MME, M3SDA, CDAC,
    # DAEL, DAELDG; the JAX package builds the classifier net, then this one)
    feature_net = False
    step_keys = STEP_KEYS + ("domain",)
    split_batch = None  # rows per domain block, where a method cuts batches (domain_split)
    epoch_fusion = False  # no resident step: JAX's zoo sets _train_epoch_resident = None

    def __init__(self, cfg, device=None, **kwargs):
        if cfg.DATALOADER.DEVICE_AUG:
            raise ValueError(
                "DATALOADER.DEVICE_AUG is only supported by the CLIP prompt trainers; the "
                "DA/DG/SSL zoo trainers require the host transform pipeline (multi-view / "
                "strong-weak augmentations)")
        super().__init__(cfg, device=device, **kwargs)

    def check_cfg(self, cfg):
        pass

    # ------------------------------------------------------------------ setup
    def build_model(self, clip=None):
        cfg = self.cfg
        self.nets = {"net": SimpleNet(cfg, cfg.MODEL, 0 if self.feature_net else self.num_classes,
                                      seed=max(cfg.SEED, 0))}
        self.frozen, self.extra, self.extra_nets = {}, {}, {}
        self.build_method()
        for m in self.nets.values():
            m.to(self.device)
        self.model_state = {g: _to(m.init_state(), self.device) for g, m in self.nets.items()
                            if hasattr(m, "init_state")}
        self.params = {f"{g}.{n}": p for g, m in self.nets.items() for n, p in m.named_parameters()}
        self.init_extra()

    def init_extra(self):
        """Set ``extra`` / ``extra_nets`` from the initial networks (SE's
        teacher), before MODEL.INIT_WEIGHTS."""

    def frozen_copy(self, group):
        """A copy of a network with its gradients off, and of its statistics
        (ADDA's source model, SE's teacher)."""
        net = copy.deepcopy(self.nets[group]).requires_grad_(False)
        return net, _clone(self.model_state[group])

    def build_method(self):
        """Set the method's ``nets`` and ``step_core`` (and ``infer``)."""
        raise NotImplementedError

    def finalize_method(self):
        """Runs after MODEL.INIT_WEIGHTS, before the first step (ADDA's frozen
        source model, AdaBN's statistics reset)."""

    def domain_split(self):
        """(rows per domain, domains per batch) of a RandomDomainSampler batch:
        TRAIN_X.N_DOMAIN, or every source domain where it is not positive
        (DAELDG, M3SDA, DAEL)."""
        n_domain = self.cfg.DATALOADER.TRAIN_X.N_DOMAIN
        if n_domain <= 0:
            n_domain = self.num_source_domains
        self.n_domain = n_domain
        self.split_batch = self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE // n_domain
        return self.split_batch, n_domain

    def shard_x(self, batch, world=None, index=None):
        """This rank's rows of a host train_x batch: contiguous rows
        (``mesh.shard_batch``), or each rank's share of every per-domain
        block where the method cuts the batch into blocks (``blocks``)."""
        if self.split_batch is None:
            return super().shard_x(batch, world, index)
        return mesh.shard_blocks(batch, self.split_batch, self.n_domain, world, index)

    def blocks(self, x):
        """The per-domain blocks of a train_x tensor, this rank's rows of
        each (``shard_x``)."""
        b = mesh.block_rows(self.split_batch)
        return [x[i * b:(i + 1) * b] for i in range(self.n_domain)]

    def block_forward(self, net, x, state, draws):
        """``net``'s train-mode forward over one block: ``split`` global rows
        (``mesh.rows``), the pad rows out of its statistics."""
        with mesh.rows((x.shape[0], self.split_batch)):
            return net(x, state, True, draws=draws)

    def block_mask(self, device):
        """The weights of a block's rows in its losses and moments: 0 on a
        pad row; None where every row counts (R divides ``split``)."""
        with mesh.rows((mesh.block_rows(self.split_batch), self.split_batch)) as lay:
            return lay.weight(device)

    def _num_batches(self):
        return len(self.train_loader_x)

    def _build_optimizer(self, steps_per_epoch=None):
        cfg = self.cfg
        self.steps_per_epoch = steps_per_epoch or max(self._num_batches(), 1)
        self.lr_schedule = make_lr_schedule(cfg, self.steps_per_epoch, self.device)
        if self.param_groups is None:
            self.optim, _ = build_optimizer(cfg, self.params.values(), self.steps_per_epoch)
            self.optims = {None: self.optim}
        else:
            ups = self.group_updates_per_step()
            self.optims = {}
            for g in self.param_groups:
                k = int(ups.get(g, 1))
                override = (lambda c, _k=k: self.lr_schedule(c // _k)) if k > 1 else None
                self.optims[g], _ = build_optimizer(cfg, self.nets[g].parameters(),
                                                    self.steps_per_epoch,
                                                    schedule_override=override)
            self.optim = None
        print(f"# params to be updated: {sum(p.numel() for p in self.params.values()):,}")
        self.finalize_method()

    def group_updates_per_step(self):
        """Optimizer updates per iteration of each group (MCD, MME, M3SDA
        step some groups several times)."""
        return {}

    def group_update(self, group, grads):
        self.optims[group].step(grads)

    # ------------------------------------------------------------------ steps
    def prepare_batch(self, batch):
        """A loader batch on the device: labels long, images NCHW float."""
        out = {}
        for k in self.step_keys:
            if k not in batch:
                continue
            t = torch.as_tensor(batch[k]).to(self.device)
            if k in ("img", "img2"):
                t = (self.eval_images(t) if t.dtype == torch.uint8
                     else t if t.dtype == torch.float64 else t.float())
                t = t.movedim(-1, -3).contiguous()
            elif k != "valid":
                t = t.long()
            out[k] = t
        return out

    def train_step(self, batch, draws=None, batch_u=None):
        """One step on a loader batch (and a train_u batch); ``draws`` hands
        in the step's random values.  Returns the metrics as device tensors."""
        bx = self.prepare_batch(batch)
        bu = self.prepare_batch(batch_u) if batch_u is not None else None
        step = self.epoch * self.steps_per_epoch + self.batch_idx
        metrics = self.step_core(bx, bu, step, draws if draws is not None else Draws(self.generator))
        return sum_metrics({k: v.detach() for k, v in metrics.items()})

    def infer(self, x):
        """Logits of NCHW images in eval mode."""
        return self.nets["net"](x, self.model_state["net"])[0]

    def logits_fn(self, params, frozen, images):
        with torch.no_grad():
            return self.infer(images.movedim(-1, -3))

    def replica_tensors(self):
        """Every group's weights and statistics, ``extra`` and ``extra_nets``,
        and every optimizer's state."""
        out = list(self.params.values()) + _leaves(self.model_state) + _leaves(self.extra)
        out += [p for m in self.extra_nets.values() for p in m.parameters()]
        return out + [t for o in self.optims.values() for t in o.tensors()]

    # ------------------------------------------------------------ checkpoints
    def optim_state(self):
        if self.param_groups is None:
            return self.optim.state_dict(list(self.params))
        return {g: self.optims[g].state_dict([n for n, _ in self.nets[g].named_parameters()])
                for g in self.param_groups}

    def load_optim_state(self, state):
        pairs = ([(self.optim, state, list(self.params))] if self.param_groups is None else
                 [(self.optims[g], (state or {}).get(g), [n for n, _ in
                                                          self.nets[g].named_parameters()])
                  for g in self.param_groups])
        for optim, s, names in pairs:
            if isinstance(s, dict) and optim.accepts(s):
                optim.load_state_dict(s, names)
            else:
                print("Warning: the checkpoint holds no optimizer state of this package for "
                      "this trainer; the moments and the schedule's step count restart")

    def extra_state(self):
        s = super().extra_state()
        s["model_state"] = state_tree(self.model_state)
        s["method_extra"] = {**state_tree(self.extra),
                             **{k: params_tree(m) for k, m in self.extra_nets.items()}}
        return s

    def load_extra_state(self, state):
        super().load_extra_state(state)
        if state.get("model_state") is not None:
            self.model_state = load_state(state["model_state"], self.device)
        if state.get("method_extra") is not None:
            extra = dict(state["method_extra"])
            for k, m in self.extra_nets.items():
                load_params(m, extra.pop(k))
            self.extra = load_state(extra, self.device)

    def load_init_weights(self, ckpt):
        """The weights, and the BatchNorm statistics of the groups that a zoo
        checkpoint holds (ROADMAP C.2: the JAX package loads the weights
        alone)."""
        self.load_params(ckpt["state_dict"])
        saved = (ckpt.get("extra") or {}).get("model_state") or {}
        for g in self.model_state:
            if g in saved:
                self.model_state[g] = load_state(saved[g], self.device)

    @torch.no_grad()
    def load_params(self, loaded):
        """Each group's weights from a JAX-layout ``state_dict`` tree, name by
        name where the shape fits (SimpleTrainer._coerce_params)."""
        for g, m in self.nets.items():
            if g not in loaded:
                print(f"Warning: /{g} missing from checkpoint; keeping init")
                continue
            flat = flatten(loaded[g])
            for mod_name, mod in m.named_modules():
                for pname, p in mod._parameters.items():
                    if p is None:
                        continue
                    name = f"{mod_name}.{pname}" if mod_name else pname
                    if name not in flat:
                        print(f"Warning: /{g}/{name} missing from checkpoint; keeping init")
                        continue
                    layout = getattr(mod, "layouts", {}).get(pname)
                    a = np.asarray(flat[name], np.float32)
                    a = TO_PORT[layout](a) if layout else a
                    if tuple(a.shape) != tuple(p.shape):
                        print(f"Warning: shape mismatch at /{g}/{name}; keeping init")
                        continue
                    p.copy_(torch.from_numpy(np.ascontiguousarray(a)))

    def save_model(self, epoch, directory, val_result=None, model_name=""):
        save_checkpoint({
            "state_dict": {g: params_tree(m) for g, m in self.nets.items()},
            "epoch": epoch + 1,
            "optimizer": self.optim_state(),
            "val_result": val_result,
            "extra": self.extra_state(),
        }, os.path.join(directory, self.model_name), model_name=model_name)

    def resume_model_if_exist(self, directory):
        ckpt = resume_from_checkpoint(os.path.join(directory, self.model_name))
        if ckpt is None:
            print(f'No checkpoint found in "{directory}", train from scratch')
            return 0
        self.load_params(ckpt["state_dict"])
        self.load_optim_state(ckpt.get("optimizer"))
        self.start_epoch = ckpt["epoch"]
        self.load_extra_state(ckpt.get("extra") or {})
        print(f"Resumed from epoch {self.start_epoch}")
        return self.start_epoch

    def load_model(self, directory, epoch=None):
        """The weights and the BN statistics of ``model-best.pkl`` (or
        ``model.pkl-<epoch>``, or the pointer's)."""
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
        model_state = (ckpt.get("extra") or {}).get("model_state")
        if model_state is not None:
            self.model_state = load_state(model_state, self.device)


class NetTrainerXU(NetTrainerX):
    """Labeled + unlabeled zoo base (TrainerXU): train_x and train_u (or
    train_x again) zipped cyclically."""

    def _num_batches(self):
        len_x = len(self.train_loader_x)
        len_u = len(self.train_loader_u) if self.train_loader_u else len_x
        count = self.cfg.TRAIN.COUNT_ITER
        if count == "train_x":
            return len_x
        if count == "train_u":
            return len_u
        if count == "smaller_one":
            return min(len_x, len_u)
        raise ValueError(count)

    def run_epoch(self):
        """TRAIN.COUNT_ITER steps over the cycled loaders, each pair copied to
        the device a step ahead; the metrics read back once, at the end."""
        t0 = time.time()
        n = self._num_batches()

        def cycle(loader):
            while True:
                yield from loader

        it_x = cycle(self.train_loader_x)
        it_u = cycle(self.train_loader_u or self.train_loader_x)
        pending = []
        try:
            pairs = zip(self.device_batches(itertools.islice(it_x, n), self.shard_x),
                        self.device_batches(itertools.islice(it_u, n)))
            for self.batch_idx, (bx, bu) in enumerate(pairs):
                pending.append(self.train_step(bx, batch_u=bu))
        finally:
            it_x.close()
            it_u.close()
        host = [{k: float(v) for k, v in m.items()} for m in pending]
        for bi, m in enumerate(host):
            if not np.isfinite(m["loss"]):
                raise FloatingPointError(f"Loss is infinite or NaN at epoch {self.epoch} "
                                         f"step {bi}: {m}")
        self._print_train_lines(host, time.time() - t0, 0.0)
        return host

