"""Residual attention transformer with functional prompt splicing
(counterpart of fsvlm_tpu.models.clip.transformer).

The JAX package stacks the blocks on a layer axis and drives them with
``lax.scan``; here they are an ``nn.ModuleList`` run by a Python loop.
Splicing semantics (parity with the reference, PromptSRC/clip/model.py:229-256):
- text: tokens [1 : 1+n_ctx) are replaced (SOT stays at 0);
- vision: the trailing n_ctx tokens are replaced;
- row i of the deep prompts is spliced before layer i where ``flags[i]``;
  layer 0 never splices (its prompts were injected at the embedding level).
"""

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import Attention
from ...ops.layers import LayerNorm, frozen_param, linear, quick_gelu


class MLP(nn.Module):
    def __init__(self, width, dtype=torch.float32, device=None):
        super().__init__()
        self.w_fc = frozen_param((width, 4 * width), dtype, device)
        self.b_fc = frozen_param((4 * width,), dtype, device)
        self.w_proj = frozen_param((4 * width, width), dtype, device)
        self.b_proj = frozen_param((width,), dtype, device)

    def forward(self, x):
        return linear(quick_gelu(linear(x, self.w_fc, self.b_fc)), self.w_proj, self.b_proj)


class ResidualAttentionBlock(nn.Module):
    """One pre-LN block; parameter names follow the JAX pytree
    {ln_1, attn{w_qkv,b_qkv,w_out,b_out}, ln_2, mlp{w_fc,b_fc,w_proj,b_proj}}."""

    def __init__(self, width, n_heads, dtype=torch.float32, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype, device)
        self.attn = Attention(width, n_heads, dtype, device)
        self.ln_2 = LayerNorm(width, dtype, device)
        self.mlp = MLP(width, dtype, device)

    def forward(self, x, mask=None, attn_impl=None, lora_delta=None):
        x = x + self.attn(self.ln_1(x), mask=mask, impl=attn_impl, lora_delta=lora_delta)
        return x + self.mlp(self.ln_2(x))


def _splice_text(x, prompt):
    """Replace x[:, 1:1+n_ctx] with prompt (n_ctx, D)."""
    n = prompt.shape[0]
    p = prompt.to(x.dtype).expand(x.shape[0], n, x.shape[-1])
    return torch.cat([x[:, :1], p, x[:, 1 + n:]], dim=1)


def _splice_vision(x, prompt):
    """Replace the trailing n_ctx tokens with prompt (n_ctx, D)."""
    n = prompt.shape[0]
    p = prompt.to(x.dtype).expand(x.shape[0], n, x.shape[-1])
    return torch.cat([x[:, : x.shape[1] - n], p], dim=1)


def transformer(blocks, x, *, mask=None, deep_prompts=None, splice_flags=None,
                splice_kind="text", attn_impl=None, remat=False, lora=None):
    """Run ``blocks`` (an nn.ModuleList of ResidualAttentionBlock) over x (B, L, D).

    deep_prompts: optional (n_layers, n_ctx, D); row i replaces the prompt
    tokens before layer i wherever ``splice_flags[i]`` (a sequence of bools).
    lora: optional {"proj": {name: (A (n_layers, D, r), B (n_layers, r, D))},
    "scale": float, "mask": n_layers 0/1 floats, "dropout": None or
    (draw, rate)}: layer i adds the deltas of A[i], B[i] at scale * mask[i]
    (JAX :156-164; a layer outside the mask computes its delta at scale 0,
    so its factors get a gradient of exactly 0).  ``draw(i, shape)`` gives
    layer i's keep masks {name: bool tensor of ``shape``}, one per
    projection.
    remat: checkpoint each layer (its splice and block), as the JAX
    package's ``jax.checkpoint`` of the scan body (:148-149): the backward
    recomputes the layer's forward, through the same attention kernels,
    instead of keeping its activations.  The blocks draw no random numbers:
    each layer's dropout masks are drawn before the layer, outside the
    checkpoint, and handed in, as JAX threads per-layer keys through its
    scan (:124-135), so the recomputation sees the same masks.
    ``torch.utils.checkpoint`` would not restore an explicit generator.
    """
    splice = _splice_text if splice_kind == "text" else _splice_vision
    if lora is not None:  # the factors in x's dtype once, not per layer and pass
        proj = {name: (a.to(x.dtype), b.to(x.dtype)) for name, (a, b) in lora["proj"].items()}

    def layer(block, h, prompt, delta):
        if prompt is not None:
            h = splice(h, prompt)
        return block(h, mask=mask, attn_impl=attn_impl, lora_delta=delta)

    for i, block in enumerate(blocks):
        prompt = None
        if deep_prompts is not None and deep_prompts.shape[1] > 0 and splice_flags[i]:
            prompt = deep_prompts[i]
        delta = None
        if lora is not None:
            s = lora["scale"] * lora["mask"][i]
            delta = {name: (a[i], b[i], s) for name, (a, b) in proj.items()}
            if lora.get("dropout") is not None:
                draw, rate = lora["dropout"]
                delta.update(keep=draw(i, x.shape), rate=rate)
        if remat:
            x = checkpoint(layer, block, x, prompt, delta, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(block, x, prompt, delta)
    return x
