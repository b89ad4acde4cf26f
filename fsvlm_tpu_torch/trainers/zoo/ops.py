"""Shared zoo ops (counterpart of fsvlm_tpu.trainers.zoo.ops): ramps,
sharpening, one-hot, mixup, EMA, the BCE helpers, the functional MLP head
and prototype classifier, and the gradient reversal layer
(dassl/modeling/ops utils.py, mixup.py, reverse_grad.py).  A ramp takes
the global step as an int or a device tensor; mixup's weights come from a
``models.draws`` source.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ...models.backbones.common import batch_norm, linear_init


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
    """BCEWithLogitsLoss (mean), rows weighted by ``valid``."""
    per = optax_sigmoid_bce(logits, targets)
    per = per.reshape(per.shape[0], -1).mean(1)
    if valid is None:
        return per.mean()
    w = valid.to(per.dtype)
    return (per * w).sum() / w.sum().clamp_min(1.0)


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def mlp_head_init(rng, in_features, hidden_layers, bn=True):
    """The functional dassl mlp head (dassl/modeling/head/mlp.py): [Linear
    -> BN1d -> activation] per hidden layer, drawn as the JAX package draws
    it.  Returns (params, state, out_features); weights (out, in)."""
    params, state = {}, {}
    cin = in_features
    for i, width in enumerate(hidden_layers):
        p = linear_init(rng, cin, width)
        params[f"fc{i}"] = {"w": _t(p["w"].T), "b": _t(p["b"])}
        if bn:
            params[f"bn{i}"] = {"scale": torch.ones(width), "bias": torch.zeros(width)}
            state[f"bn{i}"] = {"mean": torch.zeros(width), "var": torch.ones(width)}
        cin = width
    return params, state, cin


class _BN:
    def __init__(self, p):
        self.scale, self.bias = p["scale"], p["bias"]


def mlp_head_apply(x, params, state, train, n_layers, act=leaky_relu):
    new_state = {}
    for i in range(n_layers):
        x = F.linear(x, params[f"fc{i}"]["w"], params[f"fc{i}"]["b"])
        if f"bn{i}" in params:
            x, new_state[f"bn{i}"] = batch_norm(x, _BN(params[f"bn{i}"]), state[f"bn{i}"], train)
        x = act(x)
    return x, new_state


def prototypes_init(rng, fdim, num_classes):
    """MME/CDAC's cosine prototype classifier: a bias-free linear (out, in)
    over L2-normalized features, temperature 0.05."""
    return {"w": _t(linear_init(rng, fdim, num_classes)["w"].T)}


def prototypes_apply(x, params, temp=0.05, reverse=False, lmda=1.0):
    if reverse:
        x = grad_reverse(x, lmda)
    x = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    return F.linear(x, params["w"]) / temp


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
