"""Multi-head self-attention (counterpart of fsvlm_tpu.ops.attention; no LoRA
deltas yet).

One fused QKV projection with the JAX layout ``w_qkv`` (D, 3D), q|k|v along
the output axis; heads are split as strided views (no copies) and handed to
``flash_attention.attention_dispatch``, which picks a family of hand-written
Hopper kernels per ``FSVLM_FORCE_PALLAS`` and head dim (the d = 64 kernels
by default, the blockwise ones under ``=1`` or at another head dim) on CUDA
tensors, and its plain version on CPU tensors.
"""

import torch
from torch import nn

from .. import resolve_device
from .flash_attention import attention_dispatch
from .layers import frozen_param, linear


def mha(x, w_qkv, b_qkv, w_out, b_out, n_heads, mask=None, impl=None):
    """x: (B, L, D); mask: optional (L, L) additive fp32.  Returns (B, L, D).

    ``impl="plain"`` forces the plain version of the routed attention (for
    comparisons only)."""
    B, L, D = x.shape
    head_dim = D // n_heads
    qkv = linear(x, w_qkv, b_qkv)  # (B, L, 3D)

    def heads(t):  # (B, L, D) slice of qkv -> (B, H, L, d) strided view
        return t.view(B, L, n_heads, head_dim).transpose(1, 2)

    q, k, v = qkv.split(D, dim=-1)
    out = attention_dispatch(heads(q), heads(k), heads(v), mask, impl=impl)
    ctx = out.transpose(1, 2).reshape(B, L, D)
    return linear(ctx, w_out, b_out)


def causal_mask(length, dtype=torch.float32, device=None):
    """Additive causal mask: -inf strictly above the diagonal
    (parity: CLIP.build_attention_mask, clip/model.py:592-598), on ``device``
    (default cuda)."""
    return torch.full((length, length), float("-inf"), dtype=dtype,
                      device=resolve_device(device)).triu(1)


class Attention(nn.Module):
    """Holder of one block's attention weights, named as the JAX pytree."""

    def __init__(self, width, n_heads, dtype=torch.float32, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.w_qkv = frozen_param((width, 3 * width), dtype, device)
        self.b_qkv = frozen_param((3 * width,), dtype, device)
        self.w_out = frozen_param((width, width), dtype, device)
        self.b_out = frozen_param((width,), dtype, device)

    def forward(self, x, mask=None, impl=None):
        return mha(x, self.w_qkv, self.b_qkv, self.w_out, self.b_out,
                   self.n_heads, mask=mask, impl=impl)
