"""The domain generalization trainers (counterpart of
fsvlm_tpu.trainers.zoo.dg): Vanilla, CrossGrad, DDAIG, DomainMix, DAELDG
(Dassl.pytorch/dassl/engine/dg/*.py).

Each step runs its forwards, gradients and group updates in the JAX step's
order, and keeps the BatchNorm statistics that the JAX step keeps:
CrossGrad chains the statistics of its two input-gradient passes into the
F and D losses; DDAIG's G update runs F and D in train mode and drops
their statistics, keeps G's from the perturbation pass and perturbs again
with the updated G.  CrossGrad's input gradients are torch.autograd.grad
with respect to the image batch, clipped to +-0.1.  DomainMix's
cross-domain partner is drawn per row with replacement (a masked
categorical, as the JAX package: the reference draws without replacement
when it can; ROADMAP C.2).  Every random value comes from the step's
``draws``, forward by forward in the JAX step's order.
"""


import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...engine.trainer import TRAINER_REGISTRY
from ...models.backbones.common import as_param, linear_init
from ...models.networks import build_network
from ...models.simple_net import SimpleNet
from ...parallel import mesh
from .base import NetTrainerX, accuracy, cross_entropy_logits, grads_of, masked_mean
from .ops import create_onehot
from .ssl import two_view_loader


@TRAINER_REGISTRY.register()
class Vanilla(NetTrainerX):
    """Empirical risk minimization over the merged source domains
    (dg/vanilla.py)."""

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
class CrossGrad(NetTrainerX):
    """Cross-gradient training (dg/crossgrad.py): the label net F and the
    domain net D perturb each other's inputs with clipped input gradients."""

    param_groups = ["F", "D"]

    def build_method(self):
        cfg = self.cfg
        node = cfg.TRAINER.CROSSGRAD
        eps_f, eps_d = float(node.EPS_F), float(node.EPS_D)
        alpha_f, alpha_d = float(node.ALPHA_F), float(node.ALPHA_D)
        self.nets = {"F": self.nets["net"],
                     "D": SimpleNet(cfg, cfg.MODEL, self.num_source_domains,
                                    seed=max(cfg.SEED, 0) + 13)}

        def input_grad(net, state, x, target, valid, draws):
            x = x.detach().requires_grad_(True)
            logits, ns = net(x, state, True, draws=draws)
            (g,) = torch.autograd.grad(cross_entropy_logits(logits, target, valid), x)
            return g, ns

        def step_core(bx, bu, step, draws):
            x, y, d, vx = bx["img"], bx["label"], bx["domain"], bx.get("valid")
            F_net, D_net = self.nets["F"], self.nets["D"]
            grad_d, ns_d = input_grad(D_net, self.model_state["D"], x, d, vx, draws)
            input_d = x + eps_f * torch.clamp(grad_d, -0.1, 0.1)
            grad_f, ns_f = input_grad(F_net, self.model_state["F"], x, y, vx, draws)
            input_f = x + eps_d * torch.clamp(grad_f, -0.1, 0.1)

            l1, ns = F_net(x, ns_f, True, draws=draws)
            l2, ns_f = F_net(input_d, ns, True, draws=draws)
            loss_f = ((1 - alpha_f) * cross_entropy_logits(l1, y, vx)
                      + alpha_f * cross_entropy_logits(l2, y, vx))
            g_f = grads_of(loss_f, [F_net])[0]
            l1, ns = D_net(x, ns_d, True, draws=draws)
            l2, ns_d = D_net(input_f, ns, True, draws=draws)
            loss_d = ((1 - alpha_d) * cross_entropy_logits(l1, d, vx)
                      + alpha_d * cross_entropy_logits(l2, d, vx))
            g_d = grads_of(loss_d, [D_net])[0]
            self.group_update("F", g_f)
            self.group_update("D", g_d)
            self.model_state = {"F": ns_f, "D": ns_d}
            return {"loss": loss_f + loss_d, "loss_f": loss_f, "loss_d": loss_d}

        self.step_core = step_core

    def infer(self, x):
        return self.nets["F"](x, self.model_state["F"])[0]


@TRAINER_REGISTRY.register()
class DDAIG(NetTrainerX):
    """Deep domain-adversarial image generation (dg/ddaig.py): G perturbs
    the inputs to fool D while keeping F's prediction; F trains on clean
    and, after WARMUP epochs, perturbed images."""

    param_groups = ["F", "D", "G"]

    def build_method(self):
        cfg = self.cfg
        node = cfg.TRAINER.DDAIG
        lmda, clamp = float(node.LMDA), bool(node.CLAMP)
        clamp_min, clamp_max = float(node.CLAMP_MIN), float(node.CLAMP_MAX)
        warmup, alpha = int(node.WARMUP), float(node.ALPHA)
        seed = max(cfg.SEED, 0)
        self.nets = {"F": self.nets["net"],
                     "D": SimpleNet(cfg, cfg.MODEL, self.num_source_domains, seed=seed + 13),
                     "G": build_network(node.G_ARCH or "fcn_3x32_gctx", verbose=cfg.VERBOSE,
                                        seed=seed + 29)}

        def perturb(state_g, x):
            # G in train mode for the update and the perturbation alike
            # (set_model_mode("train"), ddaig.py:60-79): the STN's BatchNorms
            # use batch statistics and their running ones advance
            x_p, ns = self.nets["G"](x, state_g, lmda=lmda, train=True)
            return (torch.clamp(x_p, clamp_min, clamp_max) if clamp else x_p), ns

        def step_core(bx, bu, step, draws):
            x, y, d, vx = bx["img"], bx["label"], bx["domain"], bx.get("valid")
            F_net, D_net, G_net = self.nets["F"], self.nets["D"], self.nets["G"]
            st = self.model_state
            epoch = step // self.steps_per_epoch

            # G: keep the label, lose the domain (F's and D's statistics dropped)
            x_p, ns_g = perturb(st["G"], x)
            lf, _ = F_net(x_p, st["F"], True, draws=draws)
            ld, _ = D_net(x_p, st["D"], True, draws=draws)
            loss_g = cross_entropy_logits(lf, y, vx) - cross_entropy_logits(ld, d, vx)
            self.group_update("G", grads_of(loss_g, [G_net])[0])
            with torch.no_grad():
                x_p, ns_g = perturb(ns_g, x)

            # F on clean (+ perturbed after warmup)
            l1, ns = F_net(x, st["F"], True, draws=draws)
            loss_f = cross_entropy_logits(l1, y, vx)
            l2, ns_f = F_net(x_p, ns, True, draws=draws)
            if epoch + 1 > warmup:
                loss_f = (1.0 - alpha) * loss_f + alpha * cross_entropy_logits(l2, y, vx)
            self.group_update("F", grads_of(loss_f, [F_net])[0])

            # D on clean
            l1, ns_d = D_net(x, st["D"], True, draws=draws)
            loss_d = cross_entropy_logits(l1, d, vx)
            self.group_update("D", grads_of(loss_d, [D_net])[0])
            self.model_state = {"F": ns_f, "D": ns_d, "G": ns_g}
            return {"loss": loss_f, "loss_g": loss_g, "loss_f": loss_f, "loss_d": loss_d}

        self.step_core = step_core

    def infer(self, x):
        return self.nets["F"](x, self.model_state["F"])[0]


@TRAINER_REGISTRY.register()
class DomainMix(NetTrainerX):
    """DomainMix (dg/domain_mix.py): mixup with each sample's partner from
    another domain (crossdomain) or anywhere (random)."""

    def build_method(self):
        node = self.cfg.TRAINER.DOMAINMIX
        mix_type = str(node.TYPE)
        if mix_type not in ("crossdomain", "random"):
            raise NotImplementedError(f"Chooses ('random', 'crossdomain'), but got {mix_type}.")
        alpha, beta = float(node.ALPHA), float(node.BETA)

        def step_core(bx, bu, step, draws):
            x, y, d, vx = bx["img"], bx["label"], bx["domain"], bx.get("valid")
            lam = (draws.beta(alpha, beta, ()) if alpha > 0
                   else torch.ones((), device=x.device))
            # each row's partner among the global batch's rows (``mesh``)
            if mix_type == "crossdomain":
                d_all = mesh.global_rows(d)
                other = (d_all[None, :] != d_all[:, None]).float()
                has_other = other.sum(1, keepdim=True) > 0
                w = torch.where(has_other, other, torch.ones_like(other))
                perm = mesh.draw_rows(lambda n: draws.categorical(torch.log(w + 1e-9)), len(d))
            else:
                perm = mesh.draw_rows(draws.permutation, x.shape[0])
            x_mix = lam * x + (1.0 - lam) * mesh.global_rows(x)[perm]
            net = self.nets["net"]
            logits, ns = net(x_mix, self.model_state["net"], True, draws=draws)
            loss = (lam * cross_entropy_logits(logits, y, vx)
                    + (1.0 - lam) * cross_entropy_logits(logits, mesh.global_rows(y)[perm], vx))
            self.optim.step(grads_of(loss, [net])[0])
            self.model_state = dict(self.model_state, net=ns)
            return {"loss": loss, "acc": accuracy(logits.detach(), y, vx)}

        self.step_core = step_core


class Experts(nn.Module):
    """K domain experts, stacked (DAELDG's and DAEL's experts, M3SDA's
    classifier pairs): ``w`` (K, classes, fdim), ``b``
    (K, classes); drawn as the JAX package's (K linear inits for the
    weights, then K for the biases, from one RandomState)."""

    layouts = {"w": "kio"}

    def __init__(self, rng, k, fdim, n_cls):
        super().__init__()
        self.w = as_param(np.stack([linear_init(rng, fdim, n_cls)["w"] for _ in range(k)]),
                          "kio")
        self.b = as_param(np.stack([linear_init(rng, fdim, n_cls)["b"] for _ in range(k)]))

    def logits_all(self, f):
        """Every expert's logits: (B, K, classes)."""
        return torch.einsum("bf,kcf->bkc", f, self.w) + self.b[None]

    def logits_one(self, dom, f):
        """Expert ``dom``'s logits (a device scalar: gathered, no host sync)."""
        i = dom.view(1)
        return F.linear(f, torch.index_select(self.w, 0, i)[0], torch.index_select(self.b, 0, i)[0])

    def all(self, f):
        """Every expert's softmax: (B, K, classes)."""
        return torch.softmax(self.logits_all(f).float(), -1)

    def one(self, dom, f):
        """Expert ``dom``'s softmax on f: (B, classes)."""
        return torch.softmax(self.logits_one(dom, f).float(), -1)


@TRAINER_REGISTRY.register()
class DAELDG(NetTrainerX):
    """Domain-adaptive ensemble learning, DG variant (dg/daeldg.py): one
    expert per source domain on a shared feature net, with each expert's
    prediction on the weak view pulled toward the other batch experts' on
    the strong view."""

    feature_net = True
    param_groups = ["F", "E"]

    def check_cfg(self, cfg):
        assert cfg.DATALOADER.TRAIN_X.SAMPLER == "RandomDomainSampler"
        assert len(cfg.TRAINER.DAELDG.STRONG_TRANSFORMS) > 0

    def build_data_loader(self):
        """train_x through the weak/strong wrapper (img: INPUT.TRANSFORMS,
        img2: TRAINER.DAELDG.STRONG_TRANSFORMS), RandomDomainSampler."""
        super().build_data_loader()
        x = self.cfg.DATALOADER.TRAIN_X
        self.train_loader_x = two_view_loader(self.cfg, self.cfg.TRAINER.DAELDG.STRONG_TRANSFORMS,
                                              self.dm.dataset.train_x, x.SAMPLER, x.BATCH_SIZE,
                                              x.N_DOMAIN)

    def build_method(self):
        _, nd = self.domain_split()
        K, n_cls = self.num_source_domains, self.num_classes
        rng = np.random.RandomState(max(self.cfg.SEED, 0) + 7)
        self.nets = {"F": self.nets["net"], "E": Experts(rng, K, self.nets["net"].fdim, n_cls)}

        def step_core(bx, bu, step, draws):
            F_net, E = self.nets["F"], self.nets["E"]
            xs, x2s = self.blocks(bx["img"]), self.blocks(bx["img2"])
            ys = [create_onehot(yy, n_cls) for yy in self.blocks(bx["label"])]
            ds = [blk[0] for blk in self.blocks(bx["domain"])]  # each block's domain
            wb = self.block_mask(bx["img"].device)
            ns = self.model_state["F"]
            feats, feats2 = [], []
            for xx in xs:
                f, ns = self.block_forward(F_net, xx, ns, draws)
                feats.append(f)
            for xx in x2s:
                f, ns = self.block_forward(F_net, xx, ns, draws)
                feats2.append(f)
            present = F.one_hot(torch.stack(ds), K).float().sum(0)
            loss_x = loss_cr = acc = 0.0
            for f_i, f2_i, y_i, d_i in zip(feats, feats2, ys, ds):
                pred_i = E.one(d_i, f_i)
                loss_x = loss_x + masked_mean((-y_i * torch.log(pred_i + 1e-5)).sum(1), wb)
                acc = acc + 100.0 * masked_mean((pred_i.argmax(1) == y_i.argmax(1)).float(), wb)
                # the other experts present in the batch (dg/daeldg.py as da/dael.py:131)
                w_others = present - F.one_hot(d_i, K).float()
                w_others = w_others / w_others.sum().clamp_min(1.0)
                cr_pred = torch.einsum("bkc,k->bc", E.all(f2_i), w_others)
                loss_cr = loss_cr + masked_mean(((cr_pred - pred_i.detach()) ** 2).sum(1), wb)
            loss_x, loss_cr = loss_x / nd, loss_cr / nd
            loss = loss_x + loss_cr
            grads = torch.autograd.grad(loss, list(F_net.parameters()) + list(E.parameters()))
            n_f = len(list(F_net.parameters()))
            self.group_update("F", grads[:n_f])
            self.group_update("E", grads[n_f:])
            self.model_state = dict(self.model_state, F=ns)
            return {"loss": loss, "loss_x": loss_x, "acc": acc.detach() / nd, "loss_cr": loss_cr}

        self.step_core = step_core

    def infer(self, x):
        f, _ = self.nets["F"](x, self.model_state["F"])
        return self.nets["E"].all(f).mean(1)
