"""Primitives of the backbone zoo (counterpart of
fsvlm_tpu.models.backbones.common).

NCHW activations and OIHW conv weights, as torch lays them out; the JAX
package's NHWC/HWIO pytrees meet them only in ``models/convert.py``.  Each
leaf module names its tensors as the JAX tree does ("w", "b", "scale",
"bias") and says in ``layouts`` how the JAX tree stores a tensor that is
laid out otherwise there, so that a parameter's dotted name is its path in
the JAX tree.  Weights are drawn from a ``numpy.random.RandomState`` in the
JAX package's order and shapes and transposed once, so that a seed gives
the JAX package's initial weights.

BatchNorm is functional: ``batch_norm`` takes the running statistics as
tensors and returns new ones (fp32 statistics; it normalizes with the
biased variance and updates the running variance with the unbiased one, at
momentum 0.1, common.py:54-74), and mutates nothing, so that a trainer
keeps or drops each forward's statistics as the JAX step does.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import mesh

# how the JAX tree stores a tensor, against the port's layout
TO_PORT = {
    "hwio": lambda a: a.transpose(3, 2, 0, 1),  # conv (kh, kw, cin, cout) -> OIHW
    "io": lambda a: a.T,  # linear (in, out) -> (out, in)
    "kio": lambda a: a.transpose(0, 2, 1),  # stacked linears (k, in, out) -> (k, out, in)
}
TO_JAX = {
    "hwio": lambda a: a.transpose(2, 3, 1, 0),
    "io": lambda a: a.T,
    "kio": lambda a: a.transpose(0, 2, 1),
}


def as_param(array, layout=None):
    """A parameter from a numpy array in the JAX layout ``layout``."""
    if layout is not None:
        array = TO_PORT[layout](array)
    return nn.Parameter(torch.from_numpy(np.ascontiguousarray(array, np.float32)))


def conv_init(rng, kh, kw, cin, cout):
    """Kaiming-normal (fan_out, relu), torchvision's conv init, as HWIO."""
    std = float(np.sqrt(2.0 / (kh * kw * cout)))
    return (rng.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32)


class Conv(nn.Module):
    """A conv weight ``w`` (OIHW) and, with ``bias``, a zero bias ``b``;
    ``w`` is given as HWIO (default: ``conv_init``)."""

    layouts = {"w": "hwio"}

    def __init__(self, rng, kh, kw, cin, cout, bias=False, w=None):
        super().__init__()
        self.w = as_param(conv_init(rng, kh, kw, cin, cout) if w is None else w, "hwio")
        self.b = as_param(np.zeros(cout, np.float32)) if bias else None


def conv(x, c, stride=1, padding=0, groups=1):
    """torch's Conv2d(padding=p): symmetric explicit padding (common.py:28-42)."""
    return F.conv2d(x, c.w, c.b, stride, padding, 1, groups)


def linear_init(rng, cin, cout):
    """torch nn.Linear's default: U(-1/sqrt(cin), 1/sqrt(cin)), w as (in, out)
    then b, as the JAX package draws them."""
    bound = 1.0 / np.sqrt(cin)
    return {"w": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


class Linear(nn.Module):
    """``w`` (out, in) and ``b``, drawn by ``linear_init`` unless given as
    {"w": (in, out), "b"}."""

    layouts = {"w": "io"}

    def __init__(self, rng, cin, cout, init=None):
        super().__init__()
        p = linear_init(rng, cin, cout) if init is None else init
        self.w = as_param(p["w"], "io")
        self.b = as_param(p["b"])


def linear(x, lin):
    return F.linear(x, lin.w, lin.b)


class BatchNorm(nn.Module):
    """BatchNorm's affine ``scale`` and ``bias``; ``init_state()`` its
    running statistics (zero mean, unit variance)."""

    def __init__(self, c, zero_scale=False):
        super().__init__()
        self.c = c
        self.scale = as_param(np.zeros(c, np.float32) if zero_scale else np.ones(c, np.float32))
        self.bias = as_param(np.zeros(c, np.float32))

    def init_state(self):
        return {"mean": torch.zeros(self.c), "var": torch.ones(self.c)}


def batch_norm(x, bn, s, train, momentum=0.1, eps=1e-5):
    """(y, new running statistics) of BatchNorm over every axis but 1;
    ``s`` is left as it is.  Across ranks (``parallel.mesh``) the batch
    moments are those of every rank's rows together."""
    if not train:
        return F.batch_norm(x, s["mean"], s["var"], bn.scale, bn.bias, False, 0.0, eps), s
    if mesh.distributed():
        return _batch_norm_global(x, bn, s, momentum, eps)
    mean, var = s["mean"].clone(), s["var"].clone()
    y = F.batch_norm(x, mean, var, bn.scale, bn.bias, True, momentum, eps)
    return y, {"mean": mean, "var": var}


def _batch_norm_global(x, bn, s, momentum, eps):
    """Train-mode BatchNorm with the moments of the global batch: the sums
    over every rank's rows (differentiable), in fp32."""
    axes = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float()
    n = float(xf.numel() // xf.shape[1] * mesh.world_size())
    mean = mesh.all_reduce_sum(xf.sum(axes)) / n
    d = xf - mean.view(shape)
    var = mesh.all_reduce_sum((d * d).sum(axes)) / n
    y = d * torch.rsqrt(var + eps).view(shape) * bn.scale.view(shape) + bn.bias.view(shape)
    new = {"mean": (1 - momentum) * s["mean"] + momentum * mean.detach(),
           "var": (1 - momentum) * s["var"] + momentum * var.detach() * (n / max(n - 1, 1))}
    return y.to(x.dtype), new


def max_pool(x, window=3, stride=2, padding=1):
    """torch MaxPool2d: symmetric padding that never wins the max."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool_global(x):
    return x.mean(dim=(2, 3))


def flatten_nhwc(x):
    """(B, C, H, W) -> (B, H*W*C) in the JAX package's NHWC order, so that a
    layer that reads the flat features takes the JAX weight transposed."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def relu(x):
    return F.relu(x)
