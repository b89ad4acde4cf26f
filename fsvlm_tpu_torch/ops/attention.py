"""Multi-head self-attention with optional LoRA deltas (counterpart of
fsvlm_tpu.ops.attention).

One fused QKV projection with the JAX layout ``w_qkv`` (D, 3D), q|k|v along
the output axis; heads are split as strided views (no copies) and handed to
``flash_attention.attention_dispatch``, which picks a family of hand-written
Hopper kernels per ``FSVLM_FORCE_PALLAS`` and head dim (the d = 64 kernels
by default, the blockwise ones under ``=1`` or at another head dim) on CUDA
tensors, and its plain version on CPU tensors.

``FSVLM_ATTN_BLHD=1`` is JAX's layout experiment (:81-87): there JAX keeps
the heads minor and takes XLA's head-minor attention.  The port's kernels
already read the head-minor memory of qkv through strided views, so the
port keeps its route and the variable changes no math.

The LoRA deltas (JAX :22-112) are plain products, outside any kernel.  The
projections go through ``layers.linear``, so an int8 record (``ops.quant``)
takes the int8 product.
"""

import torch
from torch import nn

from .. import resolve_device
from .flash_attention import attention_dispatch
from .layers import frozen_param, linear


def _lora_input(t, keep, rate):
    """LoRA's inverted dropout on the branch input: t / (1 - rate) where
    ``keep``, 0 elsewhere, in t's dtype (JAX :50-60)."""
    if keep is None:
        return t
    return torch.where(keep, t / (1.0 - rate), 0.0).to(t.dtype)


def _lora(t, a, b, scale):
    """(t @ A) @ B * scale in t's dtype: A and B cast to it, and the fp32
    scale must not promote bf16 activations (JAX :69)."""
    return ((t @ a.to(t.dtype)) @ b.to(t.dtype) * scale).to(t.dtype)


def mha(x, w_qkv, b_qkv, w_out, b_out, n_heads, mask=None, impl=None, lora_delta=None,
        return_ctx_amax=False):
    """x: (B, L, D); mask: optional (L, L) additive fp32, or a (B, 1, 1, L)
    key bias.  Returns (B, L, D).

    lora_delta: optional {"q"|"k"|"v"|"o": (A (D, r), B (r, D), scale)}:
    x_in @ A @ B * scale is added to q, k and v, whose branch input is x,
    and to the output, whose branch input is the attention context before
    the out-projection (JAX :96-108).  With "keep": {name: bool (B, L, D)}
    and "rate": r in it, each branch input is dropped out (inverted, kept
    where True) by its own mask; the masks are drawn by the caller, from a
    generator or handed in (torch cannot draw JAX's threefry bits).

    ``impl="plain"`` forces the plain version of the routed attention (for
    comparisons only); ``impl="reference"`` takes ``reference_attention``,
    which autograd differentiates twice.

    ``return_ctx_amax``: also return max |ctx| in fp32, the out-projection's
    GEMM input (the int8 calibration hook, JAX :109-111)."""
    B, L, D = x.shape
    head_dim = D // n_heads
    deltas = lora_delta or {}
    keep, rate = deltas.get("keep") or {}, deltas.get("rate", 0.0)

    def add_lora(t, name, branch_input):
        if name not in deltas:
            return t
        return t + _lora(_lora_input(branch_input, keep.get(name), rate), *deltas[name])

    def heads(t):  # (B, L, D) -> (B, H, L, d) strided view
        return t.view(B, L, n_heads, head_dim).transpose(1, 2)

    qkv = linear(x, w_qkv, b_qkv)  # (B, L, 3D)
    q, k, v = (add_lora(t, name, x) for name, t in zip("qkv", qkv.split(D, dim=-1)))
    out = attention_dispatch(heads(q), heads(k), heads(v), mask, impl=impl)
    ctx = out.transpose(1, 2).reshape(B, L, D)
    y = add_lora(linear(ctx, w_out, b_out), "o", ctx)
    if return_ctx_amax:
        return y, ctx.float().abs().amax()
    return y


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

    def forward(self, x, mask=None, impl=None, lora_delta=None, return_ctx_amax=False):
        return mha(x, self.w_qkv, self.b_qkv, self.w_out, self.b_out, self.n_heads, mask=mask,
                   impl=impl, lora_delta=lora_delta, return_ctx_amax=return_ctx_amax)
