"""Shared machinery of the independent V-L prompting family (IVLP,
PromptSRC, ...); counterpart of fsvlm_tpu.trainers.ivlp_family.

Every prompt is an explicit entry of a dict of fp32 tensors:

  params = {
    "ctx":          (n_ctx_text, D)              first-layer text context
    "text_deep":    (depth_t-1, n_ctx_text, D)   layers 1..depth_t-1
    "vpt_shallow":  (n_ctx_vis, W)               first-layer vision tokens
    "vision_deep":  (depth_v-1, n_ctx_vis, W)    layers 1..depth_v-1
  }
(entries absent when the corresponding depth/length is 0.)
"""

import numpy as np
import torch

from ..models.clip import VisionPrompts, encode_image_vit, encode_text_embeds
from .prompts import assemble_prompts, build_prompt_context, prompt_tensors


def init_vlp_params(cfg_node, clip_cfg, prompt_ctx, rng):
    """Initial prompts, drawn from ``rng`` (a numpy RandomState) in the JAX
    package's order, so one seed gives the same prompts in both."""
    if cfg_node.PROMPT_DEPTH_TEXT < 1 and cfg_node.N_CTX_TEXT != 0:
        raise ValueError("In Independent VL prompting, language prompt depth should be >= 1")
    D = clip_cfg.transformer_width
    W = clip_cfg.vision_width

    def draw(shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))

    params = {}
    if cfg_node.N_CTX_TEXT > 0:
        params["ctx"] = torch.from_numpy(np.asarray(prompt_ctx["init_ctx"], np.float32))
        depth_t = min(cfg_node.PROMPT_DEPTH_TEXT, clip_cfg.transformer_layers)
        if depth_t > 1:
            params["text_deep"] = draw((depth_t - 1, cfg_node.N_CTX_TEXT, D))
    if cfg_node.N_CTX_VISION > 0 and cfg_node.PROMPT_DEPTH_VISION > 0:
        params["vpt_shallow"] = draw((cfg_node.N_CTX_VISION, W))
        depth_v = min(cfg_node.PROMPT_DEPTH_VISION, clip_cfg.vision_layers)
        if depth_v > 1:
            params["vision_deep"] = draw((depth_v - 1, cfg_node.N_CTX_VISION, W))
    return params


def _pad_deep(deep, n_layers):
    """(depth-1, n, d) -> ((n_layers, n, d), flags) with rows 1..depth-1 active."""
    depth_minus1 = deep.shape[0]
    zeros = deep.new_zeros((1,) + tuple(deep.shape[1:]))
    pad = deep.new_zeros((n_layers - 1 - depth_minus1,) + tuple(deep.shape[1:]))
    flags = [False] * n_layers
    flags[1 : 1 + depth_minus1] = [True] * depth_minus1
    return torch.cat([zeros, deep, pad], dim=0), flags


def vlp_text_features(params, frozen, compute_dtype, attn_impl=None):
    """Text tower with first-layer ctx splice + deep prompt replacement."""
    clip = frozen["clip"]
    prompts = assemble_prompts(params["ctx"], frozen["base_embed"], frozen["ctx_scatter"])
    deep = flags = None
    if "text_deep" in params:
        deep, flags = _pad_deep(params["text_deep"], clip.cfg.transformer_layers)
    return encode_text_embeds(
        clip, prompts, frozen["eot_idx"], deep_prompts=deep, splice_flags=flags,
        compute_dtype=compute_dtype, attn_impl=attn_impl)


def vlp_image_features(params, frozen, images, compute_dtype, attn_impl=None):
    """Image tower with optional shallow + deep vision prompts."""
    clip = frozen["clip"]
    vision_prompts = None
    if "vpt_shallow" in params:
        deep = flags = None
        if "vision_deep" in params:
            deep, flags = _pad_deep(params["vision_deep"], clip.cfg.vision_layers)
        vision_prompts = VisionPrompts(shallow=params["vpt_shallow"], deep=deep, flags=flags)
    return encode_image_vit(clip, images, prompts=vision_prompts,
                            compute_dtype=compute_dtype, attn_impl=attn_impl)


def build_vlp_frozen(cfg_node, clip, classnames, seed, text_truncate):
    """Frozen state shared by the family: the towers + text prompt assembly
    on the towers' device (``text_truncate``: MODEL.TEXT_TRUNCATE).  Returns
    (frozen, prompt context)."""
    # phrase-init only when n_ctx <= 4, as in the reference (promptsrc.py:90)
    device = clip.logit_scale.device
    pc = build_prompt_context(
        clip.text.token_embedding.detach().float().cpu().numpy(),
        classnames,
        n_ctx=cfg_node.N_CTX_TEXT,
        ctx_init=cfg_node.CTX_INIT if cfg_node.N_CTX_TEXT <= 4 else "",
        class_token_position="end",
        rng=np.random.RandomState(max(seed, 0)),
        context_length=clip.cfg.context_length,
        init_keep_n_ctx=True,
        truncate=bool(text_truncate),
    )
    return {"clip": clip, **prompt_tensors(pc, device)}, pc
