"""Shared zoo ops (counterpart of fsvlm_tpu.trainers.zoo.ops): ramps,
sharpening, one-hot, mixup, EMA, the BCE helpers, the MLP-head critic and
the prototype classifier (as modules named as the JAX trees), and the
gradient reversal layer (dassl/modeling/ops utils.py, mixup.py,
reverse_grad.py).  A ramp takes
the global step as an int or a device tensor; mixup's weights come from a
``models.draws`` source.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...models.backbones.common import BatchNorm, Linear, as_param, batch_norm, linear, linear_init
from ...parallel import mesh


def sigmoid_rampup(current, rampup_length):
    """exp(-5 (1 - t)^2), t = clip(current / len, 0, 1) (dassl utils.py)."""
    if rampup_length == 0:
        return torch.tensor(1.0)
    t = torch.clamp(torch.as_tensor(current, dtype=torch.float32), 0.0, rampup_length)
    return torch.exp(-5.0 * (1.0 - t / rampup_length) ** 2)


def linear_rampup(current, rampup_length):
    if rampup_length == 0:
        return torch.tensor(1.0)
    return torch.clamp(torch.as_tensor(current, dtype=torch.float32) / rampup_length, 0.0, 1.0)


def sharpen_prob(p, temperature):
    """p ** T renormalized (dassl utils.py:5-13 takes the config value as the
    exponent)."""
    sharp = p ** temperature
    return sharp / sharp.sum(-1, keepdim=True)


def create_onehot(labels, num_classes):
    return F.one_hot(labels.long(), num_classes).float()


def mixup_pair(draws, x1, x2, y1, y2, beta, preserve_order=True):
    """dassl ops/mixup.py: one lam ~ Beta(beta, beta) per row."""
    b = x1.shape[0]
    lam = draws.beta(beta, beta, (b,))
    if preserve_order:
        lam = torch.maximum(lam, 1.0 - lam)
    lam_x = lam.view((b,) + (1,) * (x1.ndim - 1))
    lam_y = lam.view((b,) + (1,) * (y1.ndim - 1))
    return lam_x * x1 + (1.0 - lam_x) * x2, lam_y * y1 + (1.0 - lam_y) * y2


@torch.no_grad()
def ema_update(student, teacher, alpha):
    """teacher <- alpha * teacher + (1 - alpha) * student, tensor by tensor
    (lists or dicts of tensors); returns the new teacher."""
    if isinstance(teacher, dict):
        return {k: ema_update(student[k], v, alpha) for k, v in teacher.items()}
    return alpha * teacher + (1.0 - alpha) * student


def optax_sigmoid_bce(logits, labels):
    lg = logits.float()
    return torch.clamp(lg, min=0.0) - lg * labels + torch.log1p(torch.exp(-torch.abs(lg)))


def bce_logits(logits, targets, valid=None):
    """BCEWithLogitsLoss (mean), rows weighted by ``valid``, over the global
    batch across ranks (``parallel.mesh``)."""
    per = optax_sigmoid_bce(logits, targets)
    return mesh.global_mean(per.reshape(per.shape[0], -1).mean(1), valid)


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


class Critic(nn.Module):
    """dassl's mlp head (dassl/modeling/head/mlp.py: Linear -> BN1d ->
    leaky relu per hidden layer) and a linear ``out`` to one logit: DANN's
    and ADDA's domain critic, drawn as the JAX package's mlp_head_init then
    linear_init; ``forward(x, state, train)`` -> (logits, new statistics)."""

    def __init__(self, rng, fdim, hidden):
        super().__init__()
        cin = fdim
        self.n = len(hidden)
        for i, width in enumerate(hidden):
            self.add_module(f"fc{i}", Linear(rng, cin, width))
            self.add_module(f"bn{i}", BatchNorm(width))
            cin = width
        self.out = Linear(rng, cin, 1)

    def init_state(self):
        return {f"bn{i}": getattr(self, f"bn{i}").init_state() for i in range(self.n)}

    def forward(self, x, state, train=True):
        ns = {}
        for i in range(self.n):
            x, ns[f"bn{i}"] = batch_norm(linear(x, getattr(self, f"fc{i}")),
                                         getattr(self, f"bn{i}"), state[f"bn{i}"], train)
            x = leaky_relu(x)
        return linear(x, self.out), ns


class Prototypes(nn.Module):
    """MME's and CDAC's cosine classifier: a bias-free linear ``w`` over
    L2-normalized features, at temperature 0.05 (its init draws a linear's
    weight and bias and keeps the weight, as the JAX package)."""

    layouts = {"w": "io"}

    def __init__(self, rng, fdim, num_classes):
        super().__init__()
        self.w = as_param(linear_init(rng, fdim, num_classes)["w"], "io")

    def forward(self, x, reverse=False, temp=0.05):
        if reverse:
            x = grad_reverse(x, 1.0)
        x = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
        return F.linear(x, self.w) / temp


class _GradReverse(torch.autograd.Function):
    """Identity forward, -lmda * g backward (dassl ops/reverse_grad.py)."""

    @staticmethod
    def forward(ctx, x, lmda):
        ctx.lmda = lmda
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lmda * g, None


def grad_reverse(x, lmda):
    """The gradient reversal layer; ``lmda`` a float or a device scalar."""
    return _GradReverse.apply(x, lmda)
