"""The domain adaptation trainers (counterpart of fsvlm_tpu.trainers.zoo.da):
SourceOnly, DANN, ADDA, AdaBN, MCD, MME, SE, M3SDA, CDAC, DAEL
(Dassl.pytorch/dassl/engine/da/*.py).

Each ``step_core(bx, bu, step, draws)`` runs the JAX step's forwards,
gradients and group updates in its order, in place, and keeps the
BatchNorm statistics that the JAX step keeps: the gradient-free forwards
in train mode (MCD's and M3SDA's step B, SE's teacher, DAEL's pseudo-label
pass) advance the statistics they are chained into; ADDA's source model
runs in eval mode, and its third critic pass advances the critic's
statistics.  Where a method steps a group several times per iteration
(MCD, MME, M3SDA, CDAC) every update reads the iteration's learning rate.
The per-domain banks (M3SDA's classifier pairs, DAEL's experts) are
stacked and gathered by the batch's domain as a device index: no host
sync.  The step's scalars that depend on the iteration alone (DANN's
lambda, SE's EMA weight) are computed on the host in float32, as the JAX
step computes them; every random value comes from ``draws`` (the
backbone's dropout), forward by forward.
"""


import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...engine.optim import build_optimizer
from ...engine.trainer import TRAINER_REGISTRY
from ...models.backbones.common import Linear, linear
from ...parallel import mesh
from .base import (NetTrainerXU, accuracy, cross_entropy_logits, grads_of, masked_mean,
                   masked_moments, masked_pair_mean, masked_row_mean)
from .dg import Experts
from .ops import Critic, Prototypes, bce_logits, create_onehot, grad_reverse, sigmoid_rampup
from .ssl import two_view_loader


def _require(ok, msg=""):
    """The JAX trainers' ``assert`` in check_cfg."""
    if not ok:
        raise AssertionError(msg)


class PairBank(nn.Module):
    """M3SDA's classifier pairs, one per source domain: ``c1`` and ``c2``,
    each K stacked linears (JAX's {"c1": {"w": (K, fdim, C), "b"}, "c2"})."""

    def __init__(self, rng, k, fdim, num_classes):
        super().__init__()
        self.c1 = Experts(rng, k, fdim, num_classes)
        self.c2 = Experts(rng, k, fdim, num_classes)

    def pair(self, dom, f):
        return self.c1.logits_one(dom, f), self.c2.logits_one(dom, f)


@TRAINER_REGISTRY.register()
class SourceOnly(NetTrainerXU):
    """CE on the labeled source batch only (da/source_only.py)."""

    def build_method(self):
        def step_core(bx, bu, step, draws):
            net = self.nets["net"]
            logits, ns = net(bx["img"], self.model_state["net"], True, draws=draws)
            loss = cross_entropy_logits(logits, bx["label"], bx.get("valid"))
            self.optim.step(grads_of(loss, [net])[0])
            self.model_state = dict(self.model_state, net=ns)
            return {"loss": loss, "acc": accuracy(logits.detach(), bx["label"], bx.get("valid"))}

        self.step_core = step_core


@TRAINER_REGISTRY.register()
class DANN(NetTrainerXU):
    """Domain-adversarial training (da/dann.py): a binary domain critic on
    gradient-reversed features, lambda = 2 / (1 + e^(-10 p)) - 1."""

    param_groups = ["net", "critic"]

    def build_method(self):
        fdim = self.nets["net"].fdim
        self.nets["critic"] = Critic(np.random.RandomState(max(self.cfg.SEED, 0) + 7), fdim,
                                     [fdim, fdim])

        def step_core(bx, bu, step, draws):
            net, critic = self.nets["net"], self.nets["critic"]
            total = np.float32(self.max_epoch * max(self._num_batches(), 1))
            lmda = float(np.float32(2.0) / (np.float32(1.0) + np.exp(
                np.float32(-10.0) * (np.float32(step) / total))) - np.float32(1.0))
            st = self.model_state
            (logit_x, feat_x), ns_net = net(bx["img"], st["net"], True, True, draws=draws)
            (_, feat_u), ns_net = net(bu["img"], ns_net, True, True, draws=draws)
            loss_x = cross_entropy_logits(logit_x, bx["label"], bx.get("valid"))
            out_xd, ns_c = critic(grad_reverse(feat_x, lmda), st["critic"], True)
            out_ud, ns_c = critic(grad_reverse(feat_u, lmda), ns_c, True)
            loss_d = (bce_logits(out_xd, torch.ones_like(out_xd), bx.get("valid"))
                      + bce_logits(out_ud, torch.zeros_like(out_ud), bu.get("valid")))
            g_net, g_critic = grads_of(loss_x + loss_d, [net, critic])
            self.group_update("net", g_net)
            self.group_update("critic", g_critic)
            self.model_state = {"net": ns_net, "critic": ns_c}
            return {"loss": loss_x + loss_d, "loss_x": loss_x,
                    "acc_x": accuracy(logit_x.detach(), bx["label"], bx.get("valid")),
                    "loss_d": loss_d}

        self.step_core = step_core


@TRAINER_REGISTRY.register()
class ADDA(NetTrainerXU):
    """Adversarial discriminative DA (da/adda.py): a frozen source encoder in
    eval mode, a critic against the target encoder, which alone moves (the
    classifier goes back to its source weights after each update)."""

    param_groups = ["net", "critic"]

    def check_cfg(self, cfg):
        _require(cfg.MODEL.INIT_WEIGHTS,
                 "The weights of source model must be provided (MODEL.INIT_WEIGHTS)")

    def build_method(self):
        fdim = self.nets["net"].fdim
        self.nets["critic"] = Critic(np.random.RandomState(max(self.cfg.SEED, 0) + 7), fdim,
                                     [fdim, fdim // 2])

        def step_core(bx, bu, step, draws):
            net, critic, st = self.nets["net"], self.nets["critic"], self.model_state
            with torch.no_grad():
                (_, feat_x), _ = self.extra_nets["source"](
                    bx["img"], self.extra["source_state"], False, True)
            (_, feat_u), ns_net = net(bu["img"], st["net"], True, True, draws=draws)
            lx, ns_c = critic(feat_x, st["critic"], True)
            lu, ns_c = critic(feat_u.detach(), ns_c, True)
            loss_critic = (bce_logits(lx, torch.ones_like(lx), bx.get("valid"))
                           + bce_logits(lu, torch.zeros_like(lu), bu.get("valid")))
            self.group_update("critic", grads_of(loss_critic, [critic])[0])
            (_, fu), _ = net(bu["img"], st["net"], True, True, draws=draws)
            lu, ns_c = critic(fu, ns_c, True)  # train mode: advances the critic's statistics
            loss_model = bce_logits(lu, torch.ones_like(lu), bu.get("valid"))
            classifier = [p.detach().clone() for p in net.classifier.parameters()]
            self.group_update("net", grads_of(loss_model, [net])[0])
            with torch.no_grad():
                for p, keep in zip(net.classifier.parameters(), classifier):
                    p.copy_(keep)
            self.model_state = {"net": ns_net, "critic": ns_c}
            return {"loss": loss_critic + loss_model, "loss_critic": loss_critic,
                    "loss_model": loss_model}

        self.step_core = step_core

    def finalize_method(self):
        # after MODEL.INIT_WEIGHTS: copies, not aliases, of the net and its statistics
        self.extra_nets["source"], self.extra["source_state"] = self.frozen_copy("net")


def _reset_bn_stats(state):
    if set(state) == {"mean", "var"}:
        return {"mean": torch.zeros_like(state["mean"]), "var": torch.ones_like(state["var"])}
    return {k: _reset_bn_stats(v) if isinstance(v, dict) else v for k, v in state.items()}


@TRAINER_REGISTRY.register()
class AdaBN(NetTrainerXU):
    """Adaptive BatchNorm (da/adabn.py): the running statistics reset, then
    re-estimated from target forwards in train mode; no weight moves."""

    param_groups = []

    def check_cfg(self, cfg):
        _require(cfg.MODEL.INIT_WEIGHTS,
                 "The weights of source model must be provided (MODEL.INIT_WEIGHTS)")

    def finalize_method(self):
        self.model_state = _reset_bn_stats(self.model_state)

    def build_method(self):
        def step_core(bx, bu, step, draws):
            with torch.no_grad():
                _, ns = self.nets["net"](bu["img"], self.model_state["net"], True, draws=draws)
            self.model_state = dict(self.model_state, net=ns)
            return {"loss": torch.zeros((), device=self.device)}

        self.step_core = step_core


def _discrepancy(p1, p2, valid):
    """The row-masked L1 discrepancy of two probability tables."""
    return masked_row_mean((p1 - p2).abs(), valid)


def _softmax(z):
    return torch.softmax(z.float(), 1)


@TRAINER_REGISTRY.register()
class MCD(NetTrainerXU):
    """Maximum classifier discrepancy (da/mcd.py): a feature net F and two
    classifiers C1/C2; step A (CE through all three), step B (C1/C2 maximize
    the discrepancy on the target), N_STEP_F step-C updates of F."""

    feature_net = True
    param_groups = ["F", "C1", "C2"]

    def group_updates_per_step(self):
        return {"F": 1 + int(self.cfg.TRAINER.MCD.N_STEP_F), "C1": 2, "C2": 2}

    def build_method(self):
        cfg = self.cfg
        n_step_f = int(cfg.TRAINER.MCD.N_STEP_F)
        rng = np.random.RandomState(max(cfg.SEED, 0) + 7)
        fdim = self.nets["net"].fdim
        self.nets = {"F": self.nets["net"], "C1": Linear(rng, fdim, self.num_classes),
                     "C2": Linear(rng, fdim, self.num_classes)}

        def step_core(bx, bu, step, draws):
            F_net, C1, C2 = self.nets["F"], self.nets["C1"], self.nets["C2"]
            vx, vu = bx.get("valid"), bu.get("valid")
            f, ns = F_net(bx["img"], self.model_state["F"], True, draws=draws)
            loss_a = (cross_entropy_logits(linear(f, C1), bx["label"], vx)
                      + cross_entropy_logits(linear(f, C2), bx["label"], vx))
            for g, gr in zip(("F", "C1", "C2"), grads_of(loss_a, [F_net, C1, C2])):
                self.group_update(g, gr)
            with torch.no_grad():  # F frozen; train mode still advances the statistics
                feat_x, ns = F_net(bx["img"], ns, True, draws=draws)
                feat_u, ns = F_net(bu["img"], ns, True, draws=draws)
            loss_b = (cross_entropy_logits(linear(feat_x, C1), bx["label"], vx)
                      + cross_entropy_logits(linear(feat_x, C2), bx["label"], vx)
                      - _discrepancy(_softmax(linear(feat_u, C1)), _softmax(linear(feat_u, C2)),
                                     vu))
            for g, gr in zip(("C1", "C2"), grads_of(loss_b, [C1, C2])):
                self.group_update(g, gr)
            loss_c = torch.zeros((), device=self.device)
            for _ in range(n_step_f):
                fu, ns = F_net(bu["img"], ns, True, draws=draws)
                loss_c = _discrepancy(_softmax(linear(fu, C1)), _softmax(linear(fu, C2)), vu)
                self.group_update("F", grads_of(loss_c, [F_net])[0])
            self.model_state = {"F": ns}
            return {"loss": loss_a, "loss_step_A": loss_a, "loss_step_B": loss_b,
                    "loss_step_C": loss_c}

        self.step_core = step_core

    def infer(self, x):
        return linear(self.nets["F"](x, self.model_state["F"])[0], self.nets["C1"])


@TRAINER_REGISTRY.register()
class MME(NetTrainerXU):
    """Minimax entropy (da/mme.py): cosine prototypes; supervised CE, then
    the target entropy maximized by the prototypes and minimized by the
    features through gradient reversal; both groups step after each."""

    feature_net = True
    param_groups = ["net", "C"]

    def group_updates_per_step(self):
        return {"net": 2, "C": 2}

    def build_method(self):
        lmda = float(self.cfg.TRAINER.MME.LMDA)
        self.nets["C"] = Prototypes(np.random.RandomState(max(self.cfg.SEED, 0) + 7),
                                    self.nets["net"].fdim, self.num_classes)

        def step_core(bx, bu, step, draws):
            net, C = self.nets["net"], self.nets["C"]
            f, ns = net(bx["img"], self.model_state["net"], True, draws=draws)
            logit_x = C(f)
            loss_x = cross_entropy_logits(logit_x, bx["label"], bx.get("valid"))
            for g, gr in zip(("net", "C"), grads_of(loss_x, [net, C])):
                self.group_update(g, gr)
            f, ns = net(bu["img"], ns, True, draws=draws)
            prob_u = _softmax(C(f, reverse=True))
            ent = -(-prob_u * torch.log(prob_u + 1e-5)).sum(1)
            loss_u = masked_mean(ent, bu.get("valid")) * lmda
            for g, gr in zip(("net", "C"), grads_of(loss_u, [net, C])):
                self.group_update(g, gr)
            self.model_state = {"net": ns}
            return {"loss": loss_x, "loss_x": loss_x,
                    "acc_x": accuracy(logit_x.detach(), bx["label"], bx.get("valid")),
                    "loss_u": loss_u / lmda}

        self.step_core = step_core

    def infer(self, x):
        return self.nets["C"](self.nets["net"](x, self.model_state["net"])[0])


@TRAINER_REGISTRY.register()
class SE(NetTrainerXU):
    """Self-ensembling (da/se.py): an EMA teacher's prediction on the second
    view of the target pulls the student's on the first, under a confidence
    mask (CONF_THRE) or a sigmoid ramp; the teacher and its statistics live
    in ``extra`` / ``extra_nets`` (the checkpoint's method_extra)."""

    def check_cfg(self, cfg):
        _require(cfg.DATALOADER.K_TRANSFORMS == 2)

    def init_extra(self):
        self.extra_nets["teacher"], self.extra["teacher_state"] = self.frozen_copy("net")

    def build_method(self):
        node = self.cfg.TRAINER.SE
        ema_alpha, conf_thre = float(node.EMA_ALPHA), float(node.CONF_THRE)
        rampup = int(node.RAMPUP)

        def step_core(bx, bu, step, draws):
            net, teacher = self.nets["net"], self.extra_nets["teacher"]
            with torch.no_grad():  # train mode: its new statistics are kept
                t_logits, t_ns = teacher(bu["img"][:, 1], self.extra["teacher_state"], True,
                                         draws=draws)
                t_prob = _softmax(t_logits)
            logit_x, ns = net(bx["img"][:, 0], self.model_state["net"], True, draws=draws)
            loss_x = cross_entropy_logits(logit_x, bx["label"], bx.get("valid"))
            logit_u, ns = net(bu["img"][:, 0], ns, True, draws=draws)
            per = ((_softmax(logit_u) - t_prob) ** 2).sum(1)
            if conf_thre:
                loss_u = masked_mean(per * (t_prob.max(1).values > conf_thre).float(),
                                     bu.get("valid"))
            else:
                loss_u = masked_mean(per, bu.get("valid")) * sigmoid_rampup(step, rampup)
            loss = loss_x + loss_u
            self.optim.step(grads_of(loss, [net])[0])
            # min(1 - 1 / (step + 1), EMA_ALPHA), in float32 as the JAX step
            one = np.float32(1.0)
            alpha = float(min(one - one / (np.float32(step) + one), np.float32(ema_alpha)))
            with torch.no_grad():
                for t, p in zip(teacher.parameters(), net.parameters()):
                    t.copy_(alpha * t + (1.0 - alpha) * p)
            self.extra = {"teacher_state": t_ns}
            self.model_state = dict(self.model_state, net=ns)
            return {"loss": loss, "loss_x": loss_x,
                    "acc_x": accuracy(logit_x.detach(), bx["label"], bx.get("valid")),
                    "loss_u": loss_u}

        self.step_core = step_core


def _euclidean(a, b):
    return torch.sqrt(((a - b) ** 2).sum() + 1e-12)


def _moment_distance(feats, feat_u, valid_u, valid_blocks=None):
    """M3SDA's first and second moment distance: every source chunk against
    the target and every pair of chunks, the variances unbiased (torch's
    ``var`` default in the reference; the target's row-masked, the chunks'
    by ``valid_blocks``, their pad rows').  Across ranks the moments are
    the global batch's and the distance, whole on every rank, counts 1/R
    (``mesh.replicated_term``)."""
    def pairwise(xs, u):
        dist = [_euclidean(x, u) for x in xs]
        dist += [_euclidean(xs[i], xs[j]) for i in range(len(xs) - 1)
                 for j in range(i + 1, len(xs))]
        return sum(dist) / len(dist)

    mu_u, var_u = masked_moments(feat_u, valid_u, ddof=1)
    moments = [masked_moments(f, valid_blocks, ddof=1) for f in feats]
    d1 = pairwise([mu for mu, _ in moments], mu_u)
    d2 = pairwise([var for _, var in moments], var_u)
    return mesh.replicated_term((d1 + d2) / 2.0)


@TRAINER_REGISTRY.register()
class M3SDA(NetTrainerXU):
    """Moment matching for multi-source DA (da/m3sda.py): a classifier pair
    per source domain (stacked), the moment distance, and MCD's three
    steps.  ``infer`` is the mean of every domain's c1 (the JAX package's
    documented divergence: the reference's M3SDA has no eval path)."""

    feature_net = True
    param_groups = ["F", "C"]

    def group_updates_per_step(self):
        return {"F": 1 + int(self.cfg.TRAINER.M3SDA.N_STEP_F), "C": 2}

    def check_cfg(self, cfg):
        _require(cfg.DATALOADER.TRAIN_X.SAMPLER == "RandomDomainSampler")
        _require(not cfg.DATALOADER.TRAIN_U.SAME_AS_X)

    def build_method(self):
        cfg = self.cfg
        _, nd = self.domain_split()
        n_step_f = int(cfg.TRAINER.M3SDA.N_STEP_F)
        lmda = float(cfg.TRAINER.M3SDA.LMDA)
        rng = np.random.RandomState(max(cfg.SEED, 0) + 7)
        self.nets = {"F": self.nets["net"],
                     "C": PairBank(rng, self.num_source_domains, self.nets["net"].fdim,
                                   self.num_classes)}

        def step_core(bx, bu, step, draws):
            F_net, C = self.nets["F"], self.nets["C"]
            xs, ys = self.blocks(bx["img"]), self.blocks(bx["label"])
            ds = [blk[0] for blk in self.blocks(bx["domain"])]  # each block's domain
            wb = self.block_mask(bx["img"].device)
            vu = bu.get("valid")
            # step A
            loss_x, feats, ns = 0.0, [], self.model_state["F"]
            for x, y, d in zip(xs, ys, ds):
                f, ns = self.block_forward(F_net, x, ns, draws)
                z1, z2 = C.pair(d, f)
                loss_x = loss_x + (cross_entropy_logits(z1, y, wb)
                                   + cross_entropy_logits(z2, y, wb))
                feats.append(f)
            fu, ns = F_net(bu["img"], ns, True, draws=draws)
            loss_a = loss_x / nd + _moment_distance(feats, fu, vu, wb) * lmda
            g_f, g_c = grads_of(loss_a, [F_net, C])
            self.group_update("F", g_f)
            self.group_update("C", g_c)
            # step B: the classifiers maximize the discrepancy, features frozen
            with torch.no_grad():
                feat_u, ns = F_net(bu["img"], ns, True, draws=draws)
                feats = []
                for x in xs:
                    f, ns = self.block_forward(F_net, x, ns, draws)
                    feats.append(f)
            loss_x = loss_dis = 0.0
            for f, y, d in zip(feats, ys, ds):
                z1, z2 = C.pair(d, f)
                loss_x = loss_x + (cross_entropy_logits(z1, y, wb)
                                   + cross_entropy_logits(z2, y, wb))
                z1, z2 = C.pair(d, feat_u)
                loss_dis = loss_dis + _discrepancy(_softmax(z1), _softmax(z2), vu)
            loss_b = loss_x / nd - loss_dis / nd
            self.group_update("C", grads_of(loss_b, [C])[0])
            # step C: the features minimize it
            loss_c = torch.zeros((), device=self.device)
            for _ in range(n_step_f):
                fu, ns = F_net(bu["img"], ns, True, draws=draws)
                loss_dis = 0.0
                for d in ds:
                    z1, z2 = C.pair(d, fu)
                    loss_dis = loss_dis + _discrepancy(_softmax(z1), _softmax(z2), vu)
                loss_c = loss_dis / nd
                self.group_update("F", grads_of(loss_c, [F_net])[0])
            self.model_state = {"F": ns}
            return {"loss": loss_a, "loss_step_A": loss_a, "loss_step_B": loss_b,
                    "loss_step_C": loss_c}

        self.step_core = step_core

    def infer(self, x):
        f, _ = self.nets["F"](x, self.model_state["F"])
        return self.nets["C"].c1.logits_all(f).mean(1)


def topk_similarity(feat, k, cols=None):
    """CDAC's s_ij = 1 iff row i of ``feat`` and row j of ``cols`` (default
    ``feat``: across ranks the global batch) have the same top-k feature
    indices; among equal values the lower index first (jax.lax.top_k's
    rule, by a stable descending sort: ReLU features hold many exact
    zeros)."""
    def top(f):
        idx = torch.sort(f.detach().float(), dim=1, descending=True, stable=True).indices[:, :k]
        return torch.sort(idx, dim=1).values

    idx = top(feat)
    idx_c = idx if cols is None else top(cols)
    return (idx[:, None, :] == idx_c[None, :, :]).all(-1).float()


class CDACSchedule:
    """CDAC's LambdaLR, lr (1 + 10 t / T)^-0.75 at iteration t of T, for a
    group stepped twice per iteration (t = count // 2), times ``mult``."""

    def __init__(self, lr, max_iter, steps_per_epoch, mult=1.0):
        self.lr, self.max_iter, self.spe, self.mult = lr, max_iter, steps_per_epoch, mult

    def anneal(self, t):
        return (1.0 + (t / self.max_iter) * 10.0) ** (-0.75)

    def __call__(self, count):
        return (self.lr * self.mult) * self.anneal((torch.as_tensor(count) // 2).float())

    def lr_at_epoch(self, epoch):
        return float(self.lr * self.anneal(float(epoch * self.spe)))


@TRAINER_REGISTRY.register()
class CDAC(NetTrainerXU):
    """Cross-domain adaptive clustering (da/cdac.py): a supervised update,
    then one on adversarial adaptive clustering (pairwise similarity of the
    top-k feature indices through reversed prototypes), confident
    pseudo-labels on the second strong view and a ramped consistency; each
    group's LR anneals per iteration, the prototypes' times CLASS_LR_MULTI."""

    feature_net = True
    param_groups = ["F", "C"]

    def check_cfg(self, cfg):
        _require(len(cfg.TRAINER.CDAC.STRONG_TRANSFORMS) > 0)
        _require(cfg.DATALOADER.K_TRANSFORMS == 2)

    def build_data_loader(self):
        super().build_data_loader()
        cfg, ds = self.cfg, self.dm.dataset
        x, u = cfg.DATALOADER.TRAIN_X, cfg.DATALOADER.TRAIN_U
        strong = cfg.TRAINER.CDAC.STRONG_TRANSFORMS
        self.train_loader_x = two_view_loader(cfg, strong, ds.train_x, x.SAMPLER, x.BATCH_SIZE, k=2)
        if ds.train_u:
            self.train_loader_u = two_view_loader(cfg, strong, ds.train_u, u.SAMPLER,
                                                  u.BATCH_SIZE, k=2)

    def _build_optimizer(self, steps_per_epoch=None):
        cfg = self.cfg
        self.steps_per_epoch = steps_per_epoch or max(self._num_batches(), 1)
        max_iter = float(self.max_epoch * self.steps_per_epoch)
        self.lr_schedule = CDACSchedule(cfg.OPTIM.LR, max_iter, self.steps_per_epoch)
        mult = {"F": 1.0, "C": float(cfg.TRAINER.CDAC.CLASS_LR_MULTI)}
        self.optims = {g: build_optimizer(cfg, self.nets[g].parameters(), self.steps_per_epoch,
                                          schedule_override=CDACSchedule(
                                              cfg.OPTIM.LR, max_iter, self.steps_per_epoch,
                                              mult[g]))[0]
                       for g in self.param_groups}
        self.optim = None
        print(f"# params to be updated: {sum(p.numel() for p in self.params.values()):,}")
        self.finalize_method()

    def build_method(self):
        cfg = self.cfg
        node = cfg.TRAINER.CDAC
        rampup_coef, rampup_iters = float(node.RAMPUP_COEF), int(node.RAMPUP_ITRS)
        topk, p_thresh = int(node.TOPK_MATCH), float(node.P_THRESH)
        self.nets = {"F": self.nets["net"],
                     "C": Prototypes(np.random.RandomState(max(cfg.SEED, 0) + 7),
                                     self.nets["net"].fdim, self.num_classes)}

        def step_core(bx, bu, step, draws):
            F_net, C = self.nets["F"], self.nets["C"]
            vu = bu.get("valid")
            f, ns = F_net(bx["img"][:, 0], self.model_state["F"], True, draws=draws)
            logit_x = C(f)
            loss_x = cross_entropy_logits(logit_x, bx["label"], bx.get("valid"))
            g_f, g_c = grads_of(loss_x, [F_net, C])
            self.group_update("F", g_f)
            self.group_update("C", g_c)

            fu, ns = F_net(bu["img"][:, 0], ns, True, draws=draws)
            fus, ns = F_net(bu["img2"][:, 0], ns, True, draws=draws)
            fus2, ns = F_net(bu["img2"][:, 1], ns, True, draws=draws)
            # Eq. 3: adversarial adaptive clustering through the reversed
            # prototypes: this rank's rows against the global batch's
            p_us = mesh.global_rows(_softmax(C(fus, reverse=True)), grad=True)
            P = _softmax(C(fu, reverse=True)) @ p_us.T
            sim = topk_similarity(fu, topk, mesh.global_rows(fu) if mesh.distributed() else None)
            bce = -(sim * torch.log(P + 1e-7) + (1.0 - sim) * torch.log(1.0 - P + 1e-7))
            aac_loss = -masked_pair_mean(bce, vu)
            # Eq. 4: pseudo-labels on the second strong view
            lus, lus2 = C(fus), C(fus2)
            prob_u = _softmax(C(fu)).detach()
            max_probs, max_idx = prob_u.max(1).values, prob_u.argmax(1)
            mask = (max_probs >= p_thresh).float()
            if vu is not None:  # padding rows are never pseudo-labeled
                mask = mask * vu.float()
            nll = -F.log_softmax(lus2.float(), 1).gather(1, max_idx[:, None])[:, 0]
            pl_loss = masked_mean(nll * mask, vu)
            # Eq. 8: consistency, ramped
            cons_loss = (rampup_coef * sigmoid_rampup(step, rampup_iters)
                         * masked_row_mean((_softmax(lus) - _softmax(lus2)) ** 2, vu))
            loss_u = aac_loss + pl_loss + cons_loss
            g_f, g_c = grads_of(loss_u, [F_net, C])
            self.group_update("F", g_f)
            self.group_update("C", g_c)
            self.model_state = {"F": ns}
            eq = (max_idx == bu["label"]).float()
            return {"loss": loss_x + loss_u, "loss_x": loss_x,
                    "acc_x": accuracy(logit_x.detach(), bx["label"], bx.get("valid")),
                    "loss_u": loss_u, "aac_loss": aac_loss, "pl_loss": pl_loss,
                    "cons_loss": cons_loss, "p_u_pred_acc": masked_mean(eq, vu),
                    "p_u_pred_acc_thre": (eq * mask).sum() / (mesh.all_reduce_sum(mask.sum())
                                                              + 1e-5),
                    "p_u_pred_keep": masked_mean(mask, vu)}

        self.step_core = step_core

    def infer(self, x):
        return self.nets["C"](self.nets["F"](x, self.model_state["F"])[0])


@TRAINER_REGISTRY.register()
class DAEL(NetTrainerXU):
    """Domain-adaptive ensemble learning (da/dael.py): one expert per source
    domain, consistency with the other batch experts on the strong view,
    pseudo-labels on the target from the most confident expert."""

    feature_net = True
    param_groups = ["F", "E"]

    def check_cfg(self, cfg):
        _require(cfg.DATALOADER.TRAIN_X.SAMPLER == "RandomDomainSampler")
        _require(not cfg.DATALOADER.TRAIN_U.SAME_AS_X)
        _require(len(cfg.TRAINER.DAEL.STRONG_TRANSFORMS) > 0)

    def build_data_loader(self):
        super().build_data_loader()
        cfg, ds = self.cfg, self.dm.dataset
        x, u = cfg.DATALOADER.TRAIN_X, cfg.DATALOADER.TRAIN_U
        strong = cfg.TRAINER.DAEL.STRONG_TRANSFORMS
        self.train_loader_x = two_view_loader(cfg, strong, ds.train_x, x.SAMPLER, x.BATCH_SIZE,
                                              x.N_DOMAIN)
        if ds.train_u:
            self.train_loader_u = two_view_loader(cfg, strong, ds.train_u, u.SAMPLER, u.BATCH_SIZE)

    def build_method(self):
        cfg = self.cfg
        _, nd = self.domain_split()
        weight_u, conf_thre = float(cfg.TRAINER.DAEL.WEIGHT_U), float(cfg.TRAINER.DAEL.CONF_THRE)
        K, n_cls = self.num_source_domains, self.num_classes
        rng = np.random.RandomState(max(cfg.SEED, 0) + 7)
        self.nets = {"F": self.nets["net"], "E": Experts(rng, K, self.nets["net"].fdim, n_cls)}

        def step_core(bx, bu, step, draws):
            F_net, E = self.nets["F"], self.nets["E"]
            xs, x2s = self.blocks(bx["img"]), self.blocks(bx["img2"])
            ys = [create_onehot(y, n_cls) for y in self.blocks(bx["label"])]
            ds = [blk[0] for blk in self.blocks(bx["domain"])]  # each block's domain
            wb = self.block_mask(bx["img"].device)
            vu = bu.get("valid")
            with torch.no_grad():  # pseudo-labels from the most confident expert
                feat_u, ns = F_net(bu["img"], self.model_state["F"], True, draws=draws)
                pred_u = E.all(feat_u)
                experts_max_p, experts_max_idx = pred_u.max(2).values, pred_u.argmax(2)
                max_expert_p, max_expert_idx = experts_max_p.max(1).values, experts_max_p.argmax(1)
                pseudo_u = create_onehot(
                    experts_max_idx.gather(1, max_expert_idx[:, None])[:, 0], n_cls)
                mask_u = (max_expert_p >= conf_thre).float()
                if vu is not None:
                    mask_u = mask_u * vu.float()
            feats, feats2 = [], []
            for x in xs:
                f, ns = self.block_forward(F_net, x, ns, draws)
                feats.append(f)
            for x in x2s:
                f, ns = self.block_forward(F_net, x, ns, draws)
                feats2.append(f)
            feat_u2, ns = F_net(bu["img2"], ns, True, draws=draws)
            # the other experts present in the batch (da/dael.py:131)
            present = F.one_hot(torch.stack(ds), K).float().sum(0)
            loss_x = loss_cr = acc_x = 0.0
            for f_i, f2_i, y_i, d_i in zip(feats, feats2, ys, ds):
                pred_i = E.one(d_i, f_i)
                loss_x = loss_x + masked_mean((-y_i * torch.log(pred_i + 1e-5)).sum(1), wb)
                acc_x = acc_x + 100.0 * masked_mean((pred_i.argmax(1) == y_i.argmax(1)).float(),
                                                    wb)
                w_others = present - F.one_hot(d_i, K).float()
                w_others = w_others / w_others.sum().clamp_min(1.0)
                cr_pred = torch.einsum("bkc,k->bc", E.all(f2_i), w_others)
                loss_cr = loss_cr + masked_mean(((cr_pred - pred_i.detach()) ** 2).sum(1), wb)
            loss_x, loss_cr = loss_x / nd, loss_cr / nd
            l_u = (-pseudo_u * torch.log(E.all(feat_u2).mean(1) + 1e-5)).sum(1)
            loss_u = masked_mean(l_u * mask_u, vu)
            loss = loss_x + loss_cr + loss_u * weight_u
            g_f, g_e = grads_of(loss, [F_net, E])
            self.group_update("F", g_f)
            self.group_update("E", g_e)
            self.model_state = {"F": ns}
            return {"loss": loss, "loss_x": loss_x, "acc_x": acc_x.detach() / nd,
                    "loss_cr": loss_cr, "loss_u": loss_u}

        self.step_core = step_core

    def infer(self, x):
        f, _ = self.nets["F"](x, self.model_state["F"])
        return self.nets["E"].all(f).mean(1)
