"""CLIP weights: OpenAI checkpoint -> numpy pytree, random init, and the
carry-across of a JAX-layout pytree onto the port's modules.

Numpy copies of fsvlm_tpu.models.clip.convert (``random_clip_params``,
``clip_params_from_state_dict``, ``load_openai_checkpoint``) for the ViT
towers; the ModifiedResNet towers are not ported yet.  The pytree layout is
the JAX package's: layers stacked on axis 0, linears stored (in, out), the
fused attention in-projection ``w_qkv`` (D, 3D) with q|k|v along the output
axis, the patch embedding HWIO.  ``load_jax_params`` is the one place where
that layout meets the modules: it unstacks the layer axis and nothing else,
because the port's modules keep the (in, out) layout.
"""

import re

import numpy as np
import torch
from torch import nn

from .config import CLIPConfig, config_from_state_dict_shapes

# trainer-owned parameters that may appear in modified checkpoints; they are
# extracted by the method trainers, not by the tower converter
_SKIP_PATTERNS = [
    r".*VPT.*",
    r"^prompt_learner\..*",
    r".*lora.*",
    r"^input_resolution$",
    r"^context_length$",
    r"^vocab_size$",
]

_BLOCK_KEYS = [
    "ln_1.weight",
    "ln_1.bias",
    "attn.in_proj_weight",
    "attn.in_proj_bias",
    "attn.out_proj.weight",
    "attn.out_proj.bias",
    "ln_2.weight",
    "ln_2.bias",
    "mlp.c_fc.weight",
    "mlp.c_fc.bias",
    "mlp.c_proj.weight",
    "mlp.c_proj.bias",
]


def _to_numpy(t):
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()


def _f32(sd, key):
    return _to_numpy(sd[key]).astype(np.float32)


def _ln(sd, prefix):
    return {"scale": _f32(sd, prefix + ".weight"), "bias": _f32(sd, prefix + ".bias")}


def _stack_blocks(sd, prefix, n_layers):
    """Per-layer params stacked on a leading layer axis; torch Linear stores
    (out, in), the pytree (in, out)."""
    def get(name, transpose=False):
        arrs = [_f32(sd, f"{prefix}.resblocks.{i}.{name}") for i in range(n_layers)]
        return np.stack([a.T for a in arrs] if transpose else arrs)

    return {
        "ln_1": {"scale": get("ln_1.weight"), "bias": get("ln_1.bias")},
        "attn": {
            "w_qkv": get("attn.in_proj_weight", True),
            "b_qkv": get("attn.in_proj_bias"),
            "w_out": get("attn.out_proj.weight", True),
            "b_out": get("attn.out_proj.bias"),
        },
        "ln_2": {"scale": get("ln_2.weight"), "bias": get("ln_2.bias")},
        "mlp": {
            "w_fc": get("mlp.c_fc.weight", True),
            "b_fc": get("mlp.c_fc.bias"),
            "w_proj": get("mlp.c_proj.weight", True),
            "b_proj": get("mlp.c_proj.bias"),
        },
    }


def clip_params_from_state_dict(sd, cfg=None):
    """Convert a torch CLIP (ViT) state dict to (params pytree, CLIPConfig)."""
    sd = dict(sd)
    if cfg is None:
        cfg = config_from_state_dict_shapes(sd)
    if not cfg.is_vit:
        raise NotImplementedError("ModifiedResNet towers are not ported yet (ROADMAP A6)")

    params = {
        "visual": {
            # torch conv weight (width, 3, P, P) -> HWIO (P, P, 3, width)
            "patch_embed": _f32(sd, "visual.conv1.weight").transpose(2, 3, 1, 0),
            "class_embedding": _f32(sd, "visual.class_embedding"),
            "positional_embedding": _f32(sd, "visual.positional_embedding"),
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": _stack_blocks(sd, "visual.transformer", cfg.vision_layers),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": _f32(sd, "visual.proj"),
        },
        "text": {
            "token_embedding": _f32(sd, "token_embedding.weight"),
            "positional_embedding": _f32(sd, "positional_embedding"),
            "blocks": _stack_blocks(sd, "transformer", cfg.transformer_layers),
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": _f32(sd, "text_projection"),
        },
        "logit_scale": _f32(sd, "logit_scale").reshape(()),
    }

    consumed = {
        "token_embedding.weight", "positional_embedding", "ln_final.weight",
        "ln_final.bias", "text_projection", "logit_scale", "visual.conv1.weight",
        "visual.class_embedding", "visual.positional_embedding",
        "visual.ln_pre.weight", "visual.ln_pre.bias", "visual.ln_post.weight",
        "visual.ln_post.bias", "visual.proj",
    }
    for prefix, n in (("transformer", cfg.transformer_layers),
                      ("visual.transformer", cfg.vision_layers)):
        consumed |= {f"{prefix}.resblocks.{i}.{k}" for i in range(n) for k in _BLOCK_KEYS}
    leftovers = [
        k for k in sd
        if k not in consumed and not any(re.match(p, k) for p in _SKIP_PATTERNS)
    ]
    if leftovers:
        raise ValueError(f"Unmapped checkpoint keys: {leftovers[:10]} ...")
    return params, cfg


def load_openai_checkpoint(path):
    """Load an OpenAI CLIP release file (TorchScript archive or state dict)
    and return (params, cfg).  Parity: clip/clip.py:86-135."""
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return clip_params_from_state_dict(sd)


def random_clip_params(cfg: CLIPConfig, seed=0):
    """Random ViT CLIP weights with the reference's init distributions
    (clip/model.py:567-591), drawn in the same RandomState order as the JAX
    package, so one seed gives the same weights in both."""
    if not cfg.is_vit:
        raise NotImplementedError("ModifiedResNet towers are not ported yet (ROADMAP A6)")
    rng = np.random.RandomState(seed)

    def normal(shape, std):
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    def make_blocks(n_layers, width):
        proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
        attn_std = width ** -0.5
        fc_std = (2 * width) ** -0.5
        ones = np.ones((n_layers, width), np.float32)
        zeros = np.zeros((n_layers, width), np.float32)
        return {
            "ln_1": {"scale": ones, "bias": zeros},
            "attn": {
                "w_qkv": normal((n_layers, width, 3 * width), attn_std),
                "b_qkv": np.zeros((n_layers, 3 * width), np.float32),
                "w_out": normal((n_layers, width, width), proj_std),
                "b_out": zeros.copy(),
            },
            "ln_2": {"scale": ones.copy(), "bias": zeros.copy()},
            "mlp": {
                "w_fc": normal((n_layers, width, 4 * width), fc_std),
                "b_fc": np.zeros((n_layers, 4 * width), np.float32),
                "w_proj": normal((n_layers, 4 * width, width), proj_std),
                "b_proj": zeros.copy(),
            },
        }

    W = cfg.vision_width
    scale = W ** -0.5
    D = cfg.transformer_width
    return {
        "visual": {
            "patch_embed": normal(
                (cfg.vision_patch_size, cfg.vision_patch_size, 3, W),
                (3 * cfg.vision_patch_size ** 2) ** -0.5,
            ),
            "class_embedding": (scale * rng.randn(W)).astype(np.float32),
            "positional_embedding": (scale * rng.randn(cfg.vision_seq_len, W)).astype(np.float32),
            "ln_pre": {"scale": np.ones(W, np.float32), "bias": np.zeros(W, np.float32)},
            "blocks": make_blocks(cfg.vision_layers, W),
            "ln_post": {"scale": np.ones(W, np.float32), "bias": np.zeros(W, np.float32)},
            "proj": (scale * rng.randn(W, cfg.embed_dim)).astype(np.float32),
        },
        "text": {
            "token_embedding": normal((cfg.vocab_size, D), 0.02),
            "positional_embedding": normal((cfg.context_length, D), 0.01),
            "blocks": make_blocks(cfg.transformer_layers, D),
            "ln_final": {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)},
            "text_projection": normal((D, cfg.embed_dim), D ** -0.5),
        },
        "logit_scale": np.float32(np.log(1 / 0.07)),
    }


def _as_f32(value):
    """numpy float32 view of a pytree leaf (numpy, ml_dtypes bf16 or scalar)."""
    arr = np.asarray(value)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return arr


def load_jax_params(module, params_np, _path=""):
    """Copy a JAX-layout numpy pytree onto ``module`` (in place).

    Dict keys name submodules or parameters one to one; a submodule that is an
    ``nn.ModuleList`` takes a subtree whose leaves carry the layer axis first,
    and gets row i in layer i.  Every parameter of ``module`` must be covered
    and every leaf must fit, or this raises.  Values are cast to each
    parameter's dtype and device.
    """
    seen = set()
    for name, value in params_np.items():
        path = f"{_path}/{name}"
        if not hasattr(module, name):
            raise KeyError(f"{path}: no such submodule or parameter")
        target = getattr(module, name)
        if isinstance(target, nn.ModuleList):
            for i, layer in enumerate(target):
                sub = _index_tree(value, i, len(target), path)
                load_jax_params(layer, sub, f"{path}[{i}]")
        elif isinstance(target, nn.Module):
            load_jax_params(target, value, path)
        else:
            arr = _as_f32(value)
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{path}: shape {arr.shape} != {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.from_numpy(np.array(arr, copy=True)))
        seen.add(name)
    missing = [n for n, _ in module.named_children() if n not in seen]
    missing += [n for n, _ in module.named_parameters(recurse=False) if n not in seen]
    if missing:
        raise KeyError(f"{_path or '/'}: not in the pytree: {missing}")


def _index_tree(tree, i, n, path):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i, n, f"{path}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.shape[0] != n:
        raise ValueError(f"{path}: layer axis {arr.shape[0]} != {n} layers")
    return arr[i]
