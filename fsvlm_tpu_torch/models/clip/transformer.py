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

    def forward(self, x, collect_amax=False):
        """With ``collect_amax`` also the fp32 maxima of |x| and of the
        second GEMM's input."""
        h = quick_gelu(linear(x, self.w_fc, self.b_fc))
        y = linear(h, self.w_proj, self.b_proj)
        if collect_amax:
            return y, x.float().abs().amax(), h.float().abs().amax()
        return y


class ResidualAttentionBlock(nn.Module):
    """One pre-LN block; parameter names follow the JAX pytree
    {ln_1, attn{w_qkv,b_qkv,w_out,b_out}, ln_2, mlp{w_fc,b_fc,w_proj,b_proj}}."""

    def __init__(self, width, n_heads, dtype=torch.float32, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype, device)
        self.attn = Attention(width, n_heads, dtype, device)
        self.ln_2 = LayerNorm(width, dtype, device)
        self.mlp = MLP(width, dtype, device)

    def forward(self, x, mask=None, attn_impl=None, lora_delta=None, collect_amax=False):
        """``collect_amax``: also return the (4,) fp32 maxima of |x| at the
        inputs of the four GEMMs, in ``ops.quant._TOWER_GEMMS`` order (qkv,
        out-proj, fc, proj): the int8 calibration hook (JAX :54-82)."""
        h = self.ln_1(x)
        attn = self.attn(h, mask=mask, impl=attn_impl, lora_delta=lora_delta,
                         return_ctx_amax=collect_amax)
        if not collect_amax:
            x = x + attn
            return x + self.mlp(self.ln_2(x))
        attn, a_out = attn
        x = x + attn
        y, a_fc, a_proj = self.mlp(self.ln_2(x), collect_amax=True)
        return x + y, torch.stack([h.float().abs().amax(), a_out, a_fc, a_proj])


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
                splice_kind="text", attn_impl=None, remat=False, lora=None,
                collect_activations=False, collect_gemm_amax=False):
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

    collect_gemm_amax: return (x, (n_layers, 4) fp32), each layer's maxima
    of |x| at its four GEMM inputs (the int8 calibration hook, JAX
    :136-141); collect_activations: return (x, (n_layers, B, L, D)), each
    layer's output (the golden replays' hook, JAX :146).  Neither changes
    what the layers launch.
    """
    splice = _splice_text if splice_kind == "text" else _splice_vision
    if lora is not None:  # the factors in x's dtype once, not per layer and pass
        proj = {name: (a.to(x.dtype), b.to(x.dtype)) for name, (a, b) in lora["proj"].items()}

    def layer(block, h, prompt, delta):
        if prompt is not None:
            h = splice(h, prompt)
        return block(h, mask=mask, attn_impl=attn_impl, lora_delta=delta,
                     collect_amax=collect_gemm_amax)

    per_layer = []
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
        if collect_gemm_amax:
            x, amax = x
            per_layer.append(amax)
        elif collect_activations:
            per_layer.append(x)
    if collect_gemm_amax or collect_activations:
        return x, torch.stack(per_layer)
    return x
