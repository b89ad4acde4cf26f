"""Modeling ops of the zoo (counterpart of fsvlm_tpu.models.modeling_ops,
:22-359): MixStyle, EFDMix, MMD, Sinkhorn OT, energy distance,
label-smoothed CE, TransNorm, DSBN, the squeeze-excite attention and the
dynamic conv.

Plain functions on NCHW tensors (channels on axis 1; the JAX package's are
NHWC).  Their random values come from a ``models.draws`` source, in the
JAX package's order: the gate, the Beta weights, then the partner
permutation.  The normalizers take and return their running statistics.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones.common import Conv, Linear, conv, linear

# ------------------------------------------------------------- style mixing


def mix_perm(draws, B, mix):
    """Partner permutation: 'random' shuffles; 'crossdomain' reverses the
    batch (assumed [domain A | domain B]) and shuffles within each half
    (modeling_ops.py:22-35)."""
    if mix == "random":
        return draws.permutation(B)
    if mix == "crossdomain":
        half = B // 2
        perm = torch.arange(B - 1, -1, -1, device=draws.device)
        return torch.cat([perm[:half][draws.permutation(half)],
                          perm[half:][draws.permutation(B - half)]])
    raise NotImplementedError(mix)


def mixstyle(draws, x, p=0.5, alpha=0.1, eps=1e-6, mix="random", train=True):
    """MixStyle (ops/mixstyle.py:53-124): mix per-sample channel statistics
    with Beta(alpha, alpha) weights; the whole batch is mixed, or passed
    through, with probability p."""
    if not train:
        return x
    B = x.shape[0]
    gate = draws.uniform(())
    lmda = draws.beta(alpha, alpha, (B,)).to(x.dtype).view(B, 1, 1, 1)
    perm = mix_perm(draws, B, mix)
    mu = x.mean(dim=(2, 3), keepdim=True).detach()
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False).detach()
    sig = torch.sqrt(var + eps)
    x_normed = (x - mu) / sig
    mu_mix = mu * lmda + mu[perm] * (1 - lmda)
    sig_mix = sig * lmda + sig[perm] * (1 - lmda)
    return torch.where(gate <= p, x_normed * sig_mix + mu_mix, x)


def efdmix(draws, x, p=0.5, alpha=0.1, mix="random", train=True):
    """EFDMix (ops/efdmix.py:53-118): sorted-value interpolation per (B, C).
    The sort is stable, as jnp.argsort's, so that tied values (ReLU's
    zeros) take the same partner values as in the JAX package."""
    if not train:
        return x
    B, C, H, W = x.shape
    gate = draws.uniform(())
    lmda = draws.beta(alpha, alpha, (B,)).to(x.dtype).view(B, 1, 1)
    perm = mix_perm(draws, B, mix)
    x_view = x.reshape(B, C, H * W)
    value_x, index_x = torch.sort(x_view, dim=-1, stable=True)
    inverse_index = torch.argsort(index_x, dim=-1)
    x_view_copy = torch.gather(value_x[perm], -1, inverse_index)
    new_x = x_view + (x_view_copy - x_view.detach()) * (1 - lmda)
    return torch.where(gate <= p, new_x.reshape(B, C, H, W), x)


# --------------------------------------------------------------------- MMD

def _remove_self_distance(distmat):
    n = distmat.shape[0]
    mask = ~torch.eye(n, dtype=torch.bool, device=distmat.device)
    return distmat[mask].reshape(n, n - 1)


def _euclidean_squared_distance(x, y):
    return (x ** 2).sum(1, keepdim=True) + (y ** 2).sum(1)[None] - 2 * x @ y.T


def _rbf_mixture(exponent, sigmas=(1, 5, 10)):
    K = 0.0
    for sigma in sigmas:
        K = K + torch.exp(-exponent / (2.0 * sigma ** 2))
    return K


def _l2_normalize(x):
    return x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)


def maximum_mean_discrepancy(x, y, kernel_type="rbf", normalize=False):
    """MMD^2(x, y) with linear/poly/rbf kernels (ops/mmd.py)."""
    if normalize:
        x, y = _l2_normalize(x), _l2_normalize(y)
    if kernel_type == "linear":
        k_xx = _remove_self_distance(x @ x.T)
        k_yy = _remove_self_distance(y @ y.T)
        k_xy = x @ y.T
    elif kernel_type == "poly":
        alpha, c, d = 1.0, 2.0, 2
        k_xx = (alpha * _remove_self_distance(x @ x.T) + c) ** d
        k_yy = (alpha * _remove_self_distance(y @ y.T) + c) ** d
        k_xy = (alpha * (x @ y.T) + c) ** d
    elif kernel_type == "rbf":
        k_xx = _rbf_mixture(_remove_self_distance(_euclidean_squared_distance(x, x)))
        k_yy = _rbf_mixture(_remove_self_distance(_euclidean_squared_distance(y, y)))
        k_xy = _rbf_mixture(_euclidean_squared_distance(x, y))
    else:
        raise NotImplementedError(kernel_type)
    return k_xx.mean() + k_yy.mean() - 2 * k_xy.mean()


# -------------------------------------------------------- optimal transport

def _ot_distance(b1, b2, dist_metric="cosine"):
    if dist_metric == "cosine":
        return 1.0 - _l2_normalize(b1) @ _l2_normalize(b2).T
    if dist_metric in ("euclidean", "fast_euclidean"):
        return _euclidean_squared_distance(b1, b2)
    raise ValueError(f"Unknown cost function: {dist_metric}")


def _sinkhorn_plan(C, eps, max_iter):
    """Entropic OT plan by log-domain Sinkhorn, all ``max_iter`` iterations
    (the JAX package's fixed trip count, modeling_ops.py:136-159)."""
    nx, ny = C.shape
    log_mu = torch.log(torch.full((nx,), 1.0 / nx, dtype=C.dtype, device=C.device) + 1e-8)
    log_nu = torch.log(torch.full((ny,), 1.0 / ny, dtype=C.dtype, device=C.device) + 1e-8)
    u = torch.zeros(nx, dtype=C.dtype, device=C.device)
    v = torch.zeros(ny, dtype=C.dtype, device=C.device)

    def M(u, v):
        return (-C + u[:, None] + v[None, :]) / eps

    for _ in range(max_iter):
        u = eps * (log_mu - torch.logsumexp(M(u, v), dim=1)) + u
        v = eps * (log_nu - torch.logsumexp(M(u, v).T, dim=1)) + v
    return torch.exp(M(u, v))


def _ot_cost(a, b, dist_metric, eps, max_iter, bp_to_sinkhorn):
    C = _ot_distance(a, b, dist_metric)
    pi = _sinkhorn_plan(C, eps, max_iter)
    if not bp_to_sinkhorn:
        pi = pi.detach()
    return (pi * C).sum()


def sinkhorn_divergence(x, y, dist_metric="cosine", eps=0.01, max_iter=5,
                        bp_to_sinkhorn=False):
    """2 W(x, y) - W(x, x) - W(y, y) (ops/optimal_transport.py:36-67)."""
    def cost(a, b):
        return _ot_cost(a, b, dist_metric, eps, max_iter, bp_to_sinkhorn)

    return 2 * cost(x, y) - cost(x, x) - cost(y, y)


def minibatch_energy_distance(x, y, dist_metric="cosine", eps=0.01, max_iter=5,
                              bp_to_sinkhorn=False):
    """MED over split halves (ops/optimal_transport.py:104-147)."""
    x1, x2 = torch.chunk(x, 2, dim=0)
    y1, y2 = torch.chunk(y, 2, dim=0)

    def cost(a, b):
        return _ot_cost(a, b, dist_metric, eps, max_iter, bp_to_sinkhorn)

    return (cost(x1, y1) + cost(x1, y2) + cost(x2, y1) + cost(x2, y2)
            - 2 * cost(x1, x2) - 2 * cost(y1, y2))


# ------------------------------------------------------------------ losses

def cross_entropy_smooth(logits, labels, label_smooth=0.0, reduction="mean"):
    """CE with label smoothing (ops/cross_entropy.py)."""
    n_cls = logits.shape[1]
    logp = F.log_softmax(logits.float(), dim=1)
    target = F.one_hot(labels.long(), n_cls).to(logp.dtype)
    target = (1.0 - label_smooth) * target + label_smooth / n_cls
    loss = -(target * logp).sum(1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(reduction)


# -------------------------------------------------------------- normalizers

def _stat_axes(x):
    return tuple(i for i in range(x.ndim) if i != 1)


def _per_channel(v, x):
    """(C,) -> broadcastable against x's axis 1."""
    return v.view(1, -1, *([1] * (x.ndim - 2)))


def transnorm_init(c):
    """TransNorm (ops/transnorm.py): affine params and separate source and
    target running statistics, as (params, state) dicts of tensors."""
    params = {"scale": torch.ones(c), "bias": torch.zeros(c)}
    state = {"mean_s": torch.zeros(c), "var_s": torch.ones(c),
             "mean_t": torch.zeros(c), "var_t": torch.ones(c)}
    return params, state


def _tn_alpha(mean_s, var_s, mean_t, var_t, eps):
    C = mean_s.shape[-1]
    ratio_s = mean_s / torch.sqrt(var_s + eps)
    ratio_t = mean_t / torch.sqrt(var_t + eps)
    dist_inv = 1.0 / (1.0 + torch.abs(ratio_s - ratio_t))
    return C * dist_inv / dist_inv.sum()


def transnorm_apply(x, params, state, train, momentum=0.1, eps=1e-5, adaptive_alpha=True):
    """x: (B, C, ...), in train the batch [source half | target half].  The
    running update keeps momentum * old + (1 - momentum) * new, inverted
    against torch BN, as the reference and the JAX package do.  Returns
    (y, new state)."""
    axes = _stat_axes(x)
    scale, bias = _per_channel(params["scale"], x), _per_channel(params["bias"], x)

    def norm(v, mean, var):
        return (v - _per_channel(mean, v)) / torch.sqrt(_per_channel(var, v) + eps) * scale + bias

    if not train:
        y = norm(x, state["mean_t"], state["var_t"])
        if adaptive_alpha:
            alpha = _tn_alpha(state["mean_s"], state["var_s"], state["mean_t"], state["var_t"], eps)
            y = (1 + _per_channel(alpha, y).detach()) * y
        return y, state
    xs, xt = torch.chunk(x, 2, dim=0)
    mean_s, var_s = xs.float().mean(axes), xs.float().var(axes, unbiased=False)
    mean_t, var_t = xt.float().mean(axes), xt.float().var(axes, unbiased=False)
    new_state = {k: momentum * state[k] + (1 - momentum) * v.detach() for k, v in
                 (("mean_s", mean_s), ("var_s", var_s), ("mean_t", mean_t), ("var_t", var_t))}
    y = torch.cat([norm(xs, mean_s, var_s), norm(xt, mean_t, var_t)], 0)
    if adaptive_alpha:
        alpha = _tn_alpha(mean_s, var_s, mean_t, var_t, eps)
        y = (1 + _per_channel(alpha, y).detach()) * y
    return y, new_state


def dsbn_init(c, n_domain):
    """Domain-specific BN (ops/dsbn.py): one BN per domain, stacked."""
    params = {"scale": torch.ones(n_domain, c), "bias": torch.zeros(n_domain, c)}
    state = {"mean": torch.zeros(n_domain, c), "var": torch.ones(n_domain, c)}
    return params, state


def dsbn_apply(x, params, state, domain_idx, train, momentum=0.1, eps=1e-5):
    """Domain ``domain_idx``'s BN; only its running statistics update.
    Returns (y, new state)."""
    scale, bias = params["scale"][domain_idx], params["bias"][domain_idx]
    if train:
        axes = _stat_axes(x)
        xf = x.float()
        mean, var = xf.mean(axes), xf.var(axes, unbiased=False)
        n = int(np.prod([x.shape[i] for i in axes]))
        unbiased = var * (n / max(n - 1, 1))
        new_mean, new_var = state["mean"].clone(), state["var"].clone()
        new_mean[domain_idx] = (1 - momentum) * state["mean"][domain_idx] + momentum * mean.detach()
        new_var[domain_idx] = (1 - momentum) * state["var"][domain_idx] + momentum * unbiased.detach()
        new_state = {"mean": new_mean, "var": new_var}
    else:
        mean, var = state["mean"][domain_idx], state["var"][domain_idx]
        new_state = state
    y = (x.float() - _per_channel(mean, x)) * torch.rsqrt(_per_channel(var, x) + eps)
    return (y * _per_channel(scale, x) + _per_channel(bias, x)).to(x.dtype), new_state


# --------------------------------------------------- dynamic-conv attention

class Attention(nn.Module):
    """Squeeze-excite attention (ops/attention.py, DDG): fc1, fc2."""

    def __init__(self, rng, in_channels, out_features, squeeze=None):
        super().__init__()
        squeeze = squeeze or in_channels // 16
        assert squeeze > 0
        self.fc1 = Linear(rng, in_channels, squeeze)
        self.fc2 = Linear(rng, squeeze, out_features)


def attention_apply(x, att):
    """x: NCHW -> softmax weights (B, out_features)."""
    h = F.relu(linear(x.mean(dim=(2, 3)), att.fc1))
    return torch.softmax(linear(h, att.fc2).float(), -1)


class Conv2dDynamic(nn.Module):
    """Conv2dDynamic (ops/conv.py, DDG): a base conv blended with a grouped
    and a 1x1 template by attention weights; ``attention_in_channels`` when
    the attention reads another tensor than the conv's input (the dynamic
    ResNet blocks read the block's input)."""

    def __init__(self, rng, cin, cout, kernel_size, squeeze=None, attention_in_channels=None):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("Kernel_size must be odd now because the templates "
                             "we used are odd (kernel_size=1).")
        k = kernel_size
        self.conv = Conv(rng, k, k, cin, cout, bias=True)
        self.conv_11 = Conv(rng, 1, 1, cin, cout, bias=True)
        self.att = Attention(rng, attention_in_channels or cin, 2, squeeze=squeeze)
        self.groups = min(cin, cout)
        w_nn = (rng.standard_normal((k, k, cin // self.groups, cout))
                * np.sqrt(2.0 / (k * k * cout))).astype(np.float32)
        self.conv_nn = Conv(None, k, k, cin, cout, bias=True, w=w_nn)


def conv2d_dynamic_apply(x, dc, stride=1, attention_x=None):
    """y = conv(x) + w0 * conv_nn(x) + w1 * conv_11(x) (ops/conv.py:70-95)."""
    w = attention_apply(attention_x if attention_x is not None else x, dc.att).to(x.dtype)
    pad = dc.conv.w.shape[-1] // 2
    y = conv(x, dc.conv, stride, pad)
    y_nn = conv(x, dc.conv_nn, stride, pad, groups=dc.groups)
    y_11 = conv(x, dc.conv_11, stride, 0)
    return y + y_nn * w[:, 0, None, None, None] + y_11 * w[:, 1, None, None, None]

