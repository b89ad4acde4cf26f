"""CLIP forward passes, the ViT or ModifiedResNet image tower + the text
transformer (counterpart of fsvlm_tpu.models.clip.model).

Parity targets (reference, PromptSRC/clip/model.py):
- VisionTransformer.forward  :401-431 (+ VPT shallow append :413-415)
- CLIP.encode_text           :604-619 (EOT gather @ text_projection)
- CLIP.forward               :621-636 (normalized cosine logits)

Batch-major (B, L, D) activations in a caller-chosen compute dtype;
LayerNorm statistics, softmax and the final projections run in fp32.
The weights live in ``CLIP`` (an nn.Module whose submodules and parameters
carry the JAX pytree's names); prompts are function arguments.
"""

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from ... import resolve_device
from ...ops.attention import causal_mask
from ...ops.layers import LayerNorm, frozen_param
from .config import CLIPConfig
from .resnet import ModifiedResNet, encode_image_resnet
from .transformer import ResidualAttentionBlock, transformer


class VisionPrompts(NamedTuple):
    """shallow: (n_ctx, W) tokens appended after patch+cls tokens;
    deep: optional (n_layers, n_ctx, W), row i consumed at layer i when
    flags[i]; flags: sequence of n_layers bools."""

    shallow: torch.Tensor
    deep: Optional[torch.Tensor] = None
    flags: Optional[Sequence[bool]] = None


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype, device):
        super().__init__()
        W, P = cfg.vision_width, cfg.vision_patch_size
        self.patch_embed = frozen_param((P, P, 3, W), dtype, device)  # HWIO
        self.class_embedding = frozen_param((W,), dtype, device)
        self.positional_embedding = frozen_param((cfg.vision_seq_len, W), dtype, device)
        self.ln_pre = LayerNorm(W, dtype, device)
        self.blocks = nn.ModuleList(
            [ResidualAttentionBlock(W, cfg.vision_heads, dtype, device)
             for _ in range(cfg.vision_layers)])
        self.ln_post = LayerNorm(W, dtype, device)
        self.proj = frozen_param((W, cfg.embed_dim), dtype, device)


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype, device):
        super().__init__()
        D = cfg.transformer_width
        self.token_embedding = frozen_param((cfg.vocab_size, D), dtype, device)
        self.positional_embedding = frozen_param((cfg.context_length, D), dtype, device)
        self.blocks = nn.ModuleList(
            [ResidualAttentionBlock(D, cfg.transformer_heads, dtype, device)
             for _ in range(cfg.transformer_layers)])
        self.ln_final = LayerNorm(D, dtype, device)
        self.text_projection = frozen_param((D, cfg.embed_dim), dtype, device)


class CLIP(nn.Module):
    """Frozen CLIP weights on ``device`` (default cuda), a ViT or a
    ModifiedResNet image tower as ``cfg`` says; fill with
    convert.load_jax_params."""

    def __init__(self, cfg: CLIPConfig, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if cfg.is_vit:
            self.visual = VisionTower(cfg, dtype, device)
        else:
            self.visual = ModifiedResNet(cfg.vision_layers, cfg.vision_width, cfg.vision_heads,
                                         cfg.image_resolution, cfg.embed_dim, dtype, device)
        self.text = TextTower(cfg, dtype, device)
        self.logit_scale = frozen_param((), dtype, device)


def patch_embed(images, kernel):
    """Non-overlapping conv as unfold + matmul.
    images: (B, H, W, 3) NHWC; kernel: (P, P, 3, width) HWIO.
    Returns (B, grid*grid, width) in the images' dtype."""
    B, H, W, C = images.shape
    P = kernel.shape[0]
    gh, gw = H // P, W // P
    x = images.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, gh * gw, P * P * C)
    return x @ kernel.reshape(P * P * C, -1).to(x.dtype)


def encode_image_vit(clip, images, prompts: Optional[VisionPrompts] = None,
                     compute_dtype=torch.float32, attn_impl=None, remat=False, lora=None):
    """ViT image tower. images: (B, H, W, 3) already CLIP-normalized.
    ``remat`` checkpoints each layer and ``lora`` adds the stacked LoRA
    deltas (``transformer``).  Returns (B, embed_dim) fp32 features."""
    v = clip.visual
    x = patch_embed(images.to(compute_dtype), v.patch_embed)
    B, _, W = x.shape
    cls = v.class_embedding.to(compute_dtype).expand(B, 1, W)
    x = torch.cat([cls, x], dim=1) + v.positional_embedding.to(compute_dtype)

    deep = flags = None
    if prompts is not None:
        shallow = prompts.shallow.to(compute_dtype).expand(B, prompts.shallow.shape[0], W)
        x = torch.cat([x, shallow], dim=1)
        deep, flags = prompts.deep, prompts.flags

    x = v.ln_pre(x)
    x = transformer(
        v.blocks, x,
        deep_prompts=None if deep is None else deep.to(compute_dtype),
        splice_flags=flags, splice_kind="vision", attn_impl=attn_impl, remat=remat, lora=lora)
    x = v.ln_post(x[:, 0, :])
    return x.float() @ v.proj.float()


def encode_image(clip, images, **kw):
    """The image tower of ``clip`` (counterpart of the JAX package's
    ``encode_image``, model.py:161-170): the ViT's ``encode_image_vit``, or
    ``encode_image_resnet``, which takes no prompts, LoRA, remat or
    attention route (those keywords are dropped, as JAX drops them)."""
    if clip.cfg.is_vit:
        return encode_image_vit(clip, images, **kw)
    for name in ("prompts", "lora", "remat", "attn_impl"):
        kw.pop(name, None)
    return encode_image_resnet(clip, images, **kw)


def embed_tokens(clip, token_ids, compute_dtype=torch.float32):
    """token ids (B, L) -> embeddings (B, L, D)."""
    return clip.text.token_embedding[token_ids].to(compute_dtype)


def encode_text_embeds(clip, embeds, eot_idx, deep_prompts=None, splice_flags=None,
                       compute_dtype=torch.float32, attn_impl=None, remat=False, lora=None):
    """Text tower over pre-built embeddings (prompt-learner path).

    embeds: (B, L, D), L <= context_length (EOT-truncated: with the causal
    mask, positions past the last EOT cannot reach a gathered feature);
    eot_idx: (B,) EOT positions; ``remat`` checkpoints each layer and
    ``lora`` adds the stacked LoRA deltas (``transformer``).  Returns
    (B, embed_dim) fp32 features."""
    t = clip.text
    L = embeds.shape[1]
    x = embeds.to(compute_dtype) + t.positional_embedding[:L].to(compute_dtype)
    x = transformer(
        t.blocks, x, mask=causal_mask(L, device=x.device),
        deep_prompts=None if deep_prompts is None else deep_prompts.to(compute_dtype),
        splice_flags=splice_flags, splice_kind="text", attn_impl=attn_impl, remat=remat,
        lora=lora)
    x = t.ln_final(x)
    x = x[torch.arange(x.shape[0], device=x.device), eot_idx]
    return x.float() @ t.text_projection.float()


def encode_text_ids(clip, token_ids, compute_dtype=torch.float32, **kw):
    """Text tower from raw token ids (zero-shot path; clip/model.py:604-619)."""
    embeds = embed_tokens(clip, token_ids, compute_dtype)
    eot_idx = token_ids.argmax(dim=-1)
    return encode_text_embeds(clip, embeds, eot_idx, compute_dtype=compute_dtype, **kw)


def l2_normalize(x, dim=-1):
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def clip_logits(image_features, text_features, logit_scale):
    """Cosine-similarity logits (logits_per_image) from unnormalized features."""
    imf = l2_normalize(image_features.float())
    txf = l2_normalize(text_features.float())
    return torch.exp(logit_scale.float()) * imf @ txf.T
