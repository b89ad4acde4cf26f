"""Elementwise / normalization primitives with CLIP's precision semantics
(forward only; counterpart of fsvlm_tpu.ops.layers).

CLIP's LayerNorm computes in fp32 whatever the activation dtype
(reference: PromptSRC/clip/model.py:153-159); QuickGELU is x*sigmoid(1.702x)
(model.py:162-164).  Linear weights are stored (in_features, out_features),
the JAX package's layout, so the forward is ``x @ w``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis: fp32 statistics (population variance),
    output in the input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def quick_gelu(x):
    """x * sigmoid(1.702 x) in the input dtype (OpenAI CLIP's GELU)."""
    return x * torch.reciprocal(1.0 + torch.exp(-1.702 * x))


def linear(x, w, b=None):
    """y = x @ w + b with ``w`` stored (in, out), cast to ``x.dtype``."""
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
