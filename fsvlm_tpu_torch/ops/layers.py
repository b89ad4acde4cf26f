"""Elementwise / normalization primitives with CLIP's precision semantics
(counterpart of fsvlm_tpu.ops.layers).

CLIP's LayerNorm computes in fp32 whatever the activation dtype
(reference: PromptSRC/clip/model.py:153-159); QuickGELU is x*sigmoid(1.702x)
(model.py:162-164).  Both are ``torch.autograd.Function``s with the
memory-lean backward of the JAX package's custom VJPs (:23-84): LayerNorm
saves x in its own dtype plus the fp32 mean and rstd and recomputes x-hat,
QuickGELU saves only x and recomputes the sigmoid.  Both backwards are
torch ops, so a backward under ``create_graph`` (PLIP's gradient penalty)
differentiates them again, as JAX's reverse-over-reverse differentiates
its custom VJPs.  Linear weights are
stored (in_features, out_features), the JAX package's layout, so the
forward is ``x @ w``, or ``ops.quant.int8_linear`` for an int8 record.
"""

import torch
from torch import nn

from .. import resolve_device
from .quant import Int8Weight, int8_linear


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = torch.native_layer_norm(x.float(), (x.shape[-1],), scale.float(),
                                                bias.float(), eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.eps = eps
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        if torch.is_grad_enabled():
            # a backward that is itself differentiated: the saved statistics
            # were computed without a graph, so recompute them from x, as
            # _layer_norm_fwd_math (JAX :13-20), whose residuals JAX
            # differentiates too
            x32 = x.float()
            mean = x32.mean(dim=-1, keepdim=True)
            var = x32.var(dim=-1, unbiased=False, keepdim=True)
            rstd = torch.reciprocal(torch.sqrt(var + ctx.eps))
        xhat = (x.float() - mean) * rstd
        g32 = g.float()
        dx = dscale = dbias = None
        if ctx.needs_input_grad[0]:
            dxhat = g32 * scale.float()
            m1 = dxhat.mean(dim=-1, keepdim=True)
            m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
            dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
        red = tuple(range(x.dim() - 1))  # every leading axis, for the (D,) grads
        if ctx.needs_input_grad[1]:
            dscale = (g32 * xhat).sum(dim=red).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = g32.sum(dim=red).to(scale.dtype)
        return dx, dscale, dbias, None


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis: fp32 statistics (population variance),
    output in the input dtype."""
    return _LayerNorm.apply(x, scale, bias, eps)


def _sigmoid_1702(x):
    return torch.reciprocal(1.0 + torch.exp(-1.702 * x))


class _QuickGELU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * _sigmoid_1702(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        s = _sigmoid_1702(x)
        return g * (s + 1.702 * x * s * (1.0 - s))


def quick_gelu(x):
    """x * sigmoid(1.702 x) in the input dtype (OpenAI CLIP's GELU)."""
    return _QuickGELU.apply(x)


def linear(x, w, b=None):
    """y = x @ w + b with ``w`` stored (in, out), cast to ``x.dtype``; an
    int8 record (``ops.quant.Int8Weight``) takes ``int8_linear``, as the
    JAX package's ``linear`` dispatches on its quantization record."""
    if isinstance(w, Int8Weight):
        return int8_linear(x, w, b)
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def frozen_param(shape, dtype, device=None):
    """An uninitialized parameter outside autograd (the towers are frozen;
    fill with ``models.clip.convert.load_jax_params``) on ``device``
    (default cuda)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=resolve_device(device)),
                        requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, width, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = frozen_param((width,), dtype, device)
        self.bias = frozen_param((width,), dtype, device)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias)
