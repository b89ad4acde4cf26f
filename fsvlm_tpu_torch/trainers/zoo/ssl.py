"""The semi-supervised trainers (counterpart of fsvlm_tpu.trainers.zoo.ssl):
SupBaseline, EntMin, MeanTeacher, MixMatch and FixMatch
(Dassl.pytorch/dassl/engine/ssl/*.py), and the weak/strong view wrapper and
its loader, which FixMatch, DAELDG, CDAC and DAEL use.

Each ``step_core(bx, bu, step, draws)`` runs the JAX step's forwards in its
order and keeps the BatchNorm statistics that it keeps: MeanTeacher's
teacher runs in train mode on its own statistics, which become the
teacher's new ones; MixMatch's K pseudo-label passes run in train mode and
their statistics chain into the training passes; FixMatch's weak pass over
[x; u] does the same.  The ramps and MeanTeacher's EMA weight depend on the
iteration alone and are computed on the host in float32, as the JAX step
computes them, so that a step makes no host sync.  MixMatch's permutation
and its two Beta draws come from ``draws`` (the trainer's generator, or
values handed in), in that order, after the backbone's.

Across ranks (``parallel.mesh``) every loss is a row mean over the global
batch; MixMatch's permutation runs over the global pool of [x; u] (the
ranks' rows gathered in the JAX package's order, x then each u view), and
each rank mixes its own rows.
"""

import copy
import random

import numpy as np
import torch
import torch.nn.functional as F

from ...data.loader import BatchLoader, DatasetWrapper
from ...data.samplers import build_sampler
from ...data.transforms import TrainTransform
from ...engine.trainer import TRAINER_REGISTRY
from ...parallel import mesh
from .base import NetTrainerXU, accuracy, cross_entropy_logits, grads_of, masked_mean
from .ops import create_onehot, sharpen_prob


class _WeakStrongWrapper(DatasetWrapper):
    """"img": the weak view(s), "img2": the strong view(s) of each train item,
    both drawn from the visit's rng (ssl.py:242-272; with k = 2 each
    pipeline stacks two views, CDAC's layout)."""

    def __init__(self, data_source, tfm_weak, tfm_strong, seed=None, k=1):
        super().__init__(data_source, tfm_weak, train=True, seed=seed)
        self.tfm_strong = tfm_strong
        self.k = k

    def __getitem__(self, idx, rng=None):
        item = self.data_source[idx]
        img = self.image(idx)
        rng = rng or self._item_rng(idx)
        kw = {"rng": rng} if rng is not None else {}
        if self.k > 1:
            weak = np.stack([self.transform(img, **kw) for _ in range(self.k)])
            strong = np.stack([self.tfm_strong(img, **kw) for _ in range(self.k)])
        else:
            weak = self.transform(img, **kw)
            strong = self.tfm_strong(img, **kw)
        return {"img": weak, "img2": strong, "label": item.label, "domain": item.domain,
                "index": idx, "impath": item.impath}


def two_view_loader(cfg, strong_transforms, data_source, sampler_name, batch_size, n_domain=0,
                    k=1):
    """A train loader of each item's weak (INPUT.TRANSFORMS, "img") and
    strong (``strong_transforms``, "img2") views, k of each, the weak and
    strong pipelines drawing from rngs seeded SEED and SEED + 1."""
    strong_cfg = copy.deepcopy(cfg)
    strong_cfg.INPUT.TRANSFORMS = tuple(strong_transforms)
    seed = cfg.SEED if cfg.SEED >= 0 else None
    tfm_weak = TrainTransform(cfg, rng=random.Random(seed or 0))
    tfm_strong = TrainTransform(strong_cfg, rng=random.Random((seed or 0) + 1))
    sampler = build_sampler(sampler_name, data_source, batch_size=batch_size, n_domain=n_domain,
                            seed=seed)
    return BatchLoader(_WeakStrongWrapper(data_source, tfm_weak, tfm_strong, seed=seed, k=k),
                       sampler, batch_size=batch_size,
                       drop_last=len(data_source) >= batch_size,
                       num_threads=max(1, cfg.DATALOADER.NUM_WORKERS), extra_keys=("img2",))


def _require(ok, msg=""):
    """The JAX trainers' ``assert`` in check_cfg."""
    if not ok:
        raise AssertionError(msg)


def _softmax(z):
    return F.softmax(z.float(), dim=1)


def sigmoid_rampup_host(current, rampup_length):
    """ops.sigmoid_rampup of a host step, in float32 as the JAX step."""
    if rampup_length == 0:
        return 1.0
    f32 = np.float32
    t = f32(min(max(f32(current), f32(0.0)), f32(rampup_length))) / f32(rampup_length)
    return float(np.exp(f32(-5.0) * (f32(1.0) - t) ** 2, dtype=f32))


def linear_rampup_host(current, rampup_length):
    if rampup_length == 0:
        return 1.0
    f32 = np.float32
    return float(min(max(f32(current) / f32(rampup_length), f32(0.0)), f32(1.0)))


def ema_alpha_host(step, ema_alpha):
    """min(1 - 1 / (step + 1), EMA_ALPHA) in float32."""
    one = np.float32(1.0)
    return float(min(one - one / (np.float32(step) + one), np.float32(ema_alpha)))


class _SSLTrainer(NetTrainerXU):
    # the losses are row means over the global batch
    data_parallel = True

    def build_model(self, clip=None):
        super().build_model(clip)
        drawing = sorted({type(m).__name__ for m in self.nets["net"].modules()
                          if getattr(m, "draws_rows", False)})
        if mesh.distributed() and drawing:
            raise ValueError(f"{type(self).__name__} does not train across ranks on a network "
                             f"that draws random values for its rows ({', '.join(drawing)}): "
                             f"each rank would draw them from one generator state (ROADMAP A8)")

    def _keep(self, ns):
        self.model_state = dict(self.model_state, net=ns)


@TRAINER_REGISTRY.register()
class SupBaseline(_SSLTrainer):
    """CE on the labeled batch only (ssl/sup_baseline.py)."""

    def build_method(self):
        def step_core(bx, bu, step, draws):
            net = self.nets["net"]
            logits, ns = net(bx["img"], self.model_state["net"], True, draws=draws)
            loss = cross_entropy_logits(logits, bx["label"], bx.get("valid"))
            self.optim.step(grads_of(loss, [net])[0])
            self._keep(ns)
            return {"loss": loss, "acc": accuracy(logits.detach(), bx["label"], bx.get("valid"))}

        self.step_core = step_core


@TRAINER_REGISTRY.register()
class EntMin(_SSLTrainer):
    """Entropy minimization (ssl/entmin.py): CE(x) + LMDA * H(p_u); the u
    pass starts from the x pass's statistics."""

    def build_method(self):
        lmda = float(self.cfg.TRAINER.ENTMIN.LMDA)

        def step_core(bx, bu, step, draws):
            net = self.nets["net"]
            logits_x, ns = net(bx["img"], self.model_state["net"], True, draws=draws)
            loss_x = cross_entropy_logits(logits_x, bx["label"], bx.get("valid"))
            logits_u, ns = net(bu["img"], ns, True, draws=draws)
            prob_u = _softmax(logits_u)
            loss_u = masked_mean(-(prob_u * torch.log(prob_u + 1e-5)).sum(1), bu.get("valid"))
            loss = loss_x + lmda * loss_u
            self.optim.step(grads_of(loss, [net])[0])
            self._keep(ns)
            return {"loss": loss, "loss_x": loss_x,
                    "acc_x": accuracy(logits_x.detach(), bx["label"], bx.get("valid")),
                    "loss_u": loss_u}

        self.step_core = step_core


@TRAINER_REGISTRY.register()
class MeanTeacher(_SSLTrainer):
    """Mean Teacher (ssl/mean_teacher.py): the squared distance of the
    student's class probabilities on u to an EMA teacher's, weighted by a
    sigmoid ramp over the epoch; the teacher (``extra_nets``) and its
    statistics (``extra``) are the checkpoint's method_extra."""

    def init_extra(self):
        self.extra_nets["teacher"], self.extra["teacher_state"] = self.frozen_copy("net")

    def build_method(self):
        node = self.cfg.TRAINER.MEANTEACHER
        weight_u, ema_alpha, rampup = float(node.WEIGHT_U), float(node.EMA_ALPHA), int(node.RAMPUP)
        spe = max(self._num_batches(), 1)  # steps per epoch, taken before the optimizer

        def step_core(bx, bu, step, draws):
            net, teacher = self.nets["net"], self.extra_nets["teacher"]
            with torch.no_grad():  # train mode: its new statistics are kept
                t_logits, t_ns = teacher(bu["img"], self.extra["teacher_state"], True,
                                         draws=draws)
                target_u = _softmax(t_logits)
            logits_x, ns = net(bx["img"], self.model_state["net"], True, draws=draws)
            loss_x = cross_entropy_logits(logits_x, bx["label"], bx.get("valid"))
            logits_u, ns = net(bu["img"], ns, True, draws=draws)
            loss_u = masked_mean(((_softmax(logits_u) - target_u) ** 2).sum(1), bu.get("valid"))
            loss = loss_x + loss_u * (weight_u * sigmoid_rampup_host(step // spe, rampup))
            self.optim.step(grads_of(loss, [net])[0])
            alpha = ema_alpha_host(step, ema_alpha)
            with torch.no_grad():
                for t, p in zip(teacher.parameters(), net.parameters()):
                    t.copy_(alpha * t + (1.0 - alpha) * p)
            self.extra = {"teacher_state": t_ns}
            self._keep(ns)
            return {"loss": loss, "loss_x": loss_x,
                    "acc_x": accuracy(logits_x.detach(), bx["label"], bx.get("valid")),
                    "loss_u": loss_u}

        self.step_core = step_core


def _mix(lam, a, b):
    lam = lam.view((-1,) + (1,) * (a.dim() - 1))
    return lam * a + (1.0 - lam) * b


@TRAINER_REGISTRY.register()
class MixMatch(_SSLTrainer):
    """MixMatch (ssl/mixmatch.py): sharpened pseudo-labels averaged over the
    K views of u, a permutation of the pool [x; u], and per-row Beta mixup
    of x and of u against the permuted pool; loss_x and loss_u are plain
    means (no valid mask, as the JAX step), loss_u ramped linearly in the
    step.  The labeled batch takes view 0 of its (B, K, ...) views."""

    def check_cfg(self, cfg):
        _require(cfg.DATALOADER.K_TRANSFORMS > 1)

    def build_method(self):
        node = self.cfg.TRAINER.MIXMATCH
        weight_u, temp = float(node.WEIGHT_U), float(node.TEMP)
        beta, rampup = float(node.MIXUP_BETA), int(node.RAMPUP)
        n_cls = self.num_classes

        def step_core(bx, bu, step, draws):
            net = self.nets["net"]
            input_x, label_x = bx["img"][:, 0], create_onehot(bx["label"], n_cls)
            K = bu["img"].shape[1]
            views_u = [bu["img"][:, k] for k in range(K)]
            ns0, prob_sum = self.model_state["net"], 0.0
            with torch.no_grad():  # train mode: the statistics chain into the passes below
                for v in views_u:
                    logits_v, ns0 = net(v, ns0, True, draws=draws)
                    prob_sum = prob_sum + _softmax(logits_v)
                label_u = sharpen_prob(prob_sum / K, temp)
            input_u, label_u_all = torch.cat(views_u, 0), label_u.repeat(K, 1)
            # the global pool [x; u_1..u_K] in the JAX package's row order, and
            # this rank's rows of it (every row on one rank)
            bx_n, bu_n = input_x.shape[0], views_u[0].shape[0]
            views_g = [mesh.gather_rows(v) for v in views_u]
            Bx, Bu = bx_n * mesh.world_size(), views_g[0].shape[0]
            pool = torch.cat([mesh.gather_rows(input_x)] + views_g, 0)
            lpool = torch.cat([mesh.gather_rows(label_x)] + [mesh.gather_rows(label_u)] * K, 0)
            r, dev = mesh.rank(), input_x.device
            rows_x = r * bx_n + torch.arange(bx_n, device=dev)
            rows_u = torch.cat([k * Bu + r * bu_n + torch.arange(bu_n, device=dev)
                                for k in range(K)])
            perm = draws.permutation(pool.shape[0])
            pool, lpool = pool[perm], lpool[perm]
            lam_x = draws.beta(beta, beta, (Bx,))
            lam_u = draws.beta(beta, beta, (K * Bu,))
            lam_x, lam_u = torch.maximum(lam_x, 1.0 - lam_x), torch.maximum(lam_u, 1.0 - lam_u)
            px, lpx, lam_x = pool[:Bx][rows_x], lpool[:Bx][rows_x], lam_x[rows_x]
            pu, lpu, lam_u = pool[Bx:][rows_u], lpool[Bx:][rows_u], lam_u[rows_u]
            mixed_x, mixed_lx = _mix(lam_x, input_x, px), _mix(lam_x, label_x, lpx)
            mixed_u, mixed_lu = _mix(lam_u, input_u, pu), _mix(lam_u, label_u_all, lpu)

            logits_x, ns = net(mixed_x, ns0, True, draws=draws)
            loss_x = masked_mean(-(mixed_lx * torch.log(_softmax(logits_x) + 1e-5)).sum(1), None)
            logits_u, ns = net(mixed_u, ns, True, draws=draws)
            loss_u = masked_mean((mixed_lu - _softmax(logits_u)) ** 2, None)
            loss = loss_x + loss_u * (weight_u * linear_rampup_host(step, rampup))
            self.optim.step(grads_of(loss, [net])[0])
            self._keep(ns)
            return {"loss": loss, "loss_x": loss_x, "loss_u": loss_u}

        self.step_core = step_core


@TRAINER_REGISTRY.register()
class FixMatch(_SSLTrainer):
    """FixMatch (ssl/fixmatch.py): pseudo-labels from the weak views of [x;
    u] where the top class probability reaches CONF_THRE (and the row is
    valid) supervise the strong views; the weak pass's statistics feed the
    training passes.  The loaders give each item's weak ("img") and strong
    ("img2", TRAINER.FIXMATCH.STRONG_TRANSFORMS) views (``two_view_loader``).
    The pseudo-labels' accuracy on u (raw and over the kept rows) and the
    kept share are metrics, as device tensors."""

    def check_cfg(self, cfg):
        _require(len(cfg.TRAINER.FIXMATCH.STRONG_TRANSFORMS) > 0)

    def build_data_loader(self):
        super().build_data_loader()
        cfg, ds = self.cfg, self.dm.dataset
        x, u = cfg.DATALOADER.TRAIN_X, cfg.DATALOADER.TRAIN_U
        strong = cfg.TRAINER.FIXMATCH.STRONG_TRANSFORMS
        # both loaders sample as TRAIN_X says (ssl.py:294-306)
        self.train_loader_x = two_view_loader(cfg, strong, ds.train_x, x.SAMPLER, x.BATCH_SIZE)
        if ds.train_u:
            self.train_loader_u = two_view_loader(cfg, strong, ds.train_u, x.SAMPLER,
                                                  u.BATCH_SIZE)

    def build_method(self):
        node = self.cfg.TRAINER.FIXMATCH
        weight_u, conf_thre = float(node.WEIGHT_U), float(node.CONF_THRE)

        def step_core(bx, bu, step, draws):
            net = self.nets["net"]
            n_x = bx["img"].shape[0]
            vx, vu = bx.get("valid"), bu.get("valid")
            valid_xu = None
            if vx is not None or vu is not None:  # pad rows are never pseudo-labeled
                def _v(ref, n):
                    return ref.float() if ref is not None else torch.ones(n, device=self.device)

                valid_xu = torch.cat([_v(vx, n_x), _v(vu, bu["img"].shape[0])])
            with torch.no_grad():  # train mode: its statistics feed the passes below
                logits_w, ns_w = net(torch.cat([bx["img"], bu["img"]]), self.model_state["net"],
                                     True, draws=draws)
                prob_w = _softmax(logits_w)
                max_prob, label_u_pred = prob_w.max(1).values, prob_w.argmax(1)
                mask_u = (max_prob >= conf_thre).float()
                if valid_xu is not None:
                    mask_u = mask_u * valid_xu
                eq = (label_u_pred[n_x:] == bu["label"]).float()
                mask_uu = mask_u[n_x:]
                acc_thre = (eq * mask_uu).sum() / (mesh.all_reduce_sum(mask_uu.sum()) + 1e-5)
                acc_raw, keep_rate = masked_mean(eq, vu), masked_mean(mask_uu, vu)
            logits_x, ns = net(bx["img"], ns_w, True, draws=draws)
            loss_x = cross_entropy_logits(logits_x, bx["label"], vx)
            logits_u2, ns = net(torch.cat([bx["img2"], bu["img2"]]), ns, True, draws=draws)
            logp = F.log_softmax(logits_u2.float(), dim=1)
            nll = -logp.gather(1, label_u_pred[:, None])[:, 0]
            loss_u = masked_mean(nll * mask_u, valid_xu)
            loss = loss_x + loss_u * weight_u
            self.optim.step(grads_of(loss, [net])[0])
            self._keep(ns)
            return {"loss": loss, "loss_x": loss_x,
                    "acc_x": accuracy(logits_x.detach(), bx["label"], vx), "loss_u": loss_u,
                    "y_u_pred_acc_raw": acc_raw, "y_u_pred_acc_thre": acc_thre,
                    "y_u_pred_keep": keep_rate}

        self.step_core = step_core
