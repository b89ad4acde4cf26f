"""CLIP weights: OpenAI checkpoint -> numpy pytree, random init, and the
carry-across of a JAX-layout pytree onto the port's modules.

Numpy copies of fsvlm_tpu.models.clip.convert (``random_clip_params``,
``clip_params_from_state_dict``, ``load_openai_checkpoint``) for the ViT and
the ModifiedResNet towers.  The pytree layout is the JAX package's:
transformer layers stacked on axis 0, linears stored (in, out), the fused
attention in-projection ``w_qkv`` (D, 3D) with q|k|v along the output axis,
the patch embedding and the RN conv kernels HWIO, the RN stages and blocks
nested lists, BatchNorm as {scale, bias, mean, var}.  ``load_jax_params`` is
the one place where that layout meets the modules: it unstacks the layer
axis, walks the nested lists, and transposes the RN conv kernels to the
OIHW that ``F.conv2d`` reads, once; the port's modules keep the (in, out)
layout of the linears.
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


_BN_KEYS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _conv(sd, prefix):
    """torch conv weight (out, in, kh, kw) -> HWIO (kh, kw, in, out)."""
    return _f32(sd, prefix + ".weight").transpose(2, 3, 1, 0)


def _bn(sd, prefix):
    return {"scale": _f32(sd, prefix + ".weight"), "bias": _f32(sd, prefix + ".bias"),
            "mean": _f32(sd, prefix + ".running_mean"), "var": _f32(sd, prefix + ".running_var")}


def _linear(sd, prefix):
    return {"w": _f32(sd, prefix + ".weight").T, "b": _f32(sd, prefix + ".bias")}


def _convert_resnet_visual(sd, cfg):
    """The RN tower's pytree and the state-dict keys it consumed."""
    consumed = set()

    def conv(prefix):
        consumed.add(prefix + ".weight")
        return _conv(sd, prefix)

    def bn(prefix):
        consumed.update(f"{prefix}.{k}" for k in _BN_KEYS)
        return _bn(sd, prefix)

    def linear(prefix):
        consumed.update((prefix + ".weight", prefix + ".bias"))
        return _linear(sd, prefix)

    visual = {"stem": {}, "layers": []}
    for i in (1, 2, 3):
        visual["stem"][f"conv{i}"] = conv(f"visual.conv{i}")
        visual["stem"][f"bn{i}"] = bn(f"visual.bn{i}")
    for li, n_blocks in enumerate(cfg.vision_layers, start=1):
        stage = []
        for b in range(n_blocks):
            p = f"visual.layer{li}.{b}"
            block = {}
            for i in (1, 2, 3):
                block[f"conv{i}"] = conv(f"{p}.conv{i}")
                block[f"bn{i}"] = bn(f"{p}.bn{i}")
            if f"{p}.downsample.0.weight" in sd:
                block["downsample"] = {"conv": conv(p + ".downsample.0"),
                                       "bn": bn(p + ".downsample.1")}
            stage.append(block)
        visual["layers"].append(stage)
    consumed.add("visual.attnpool.positional_embedding")
    visual["attnpool"] = {
        "positional_embedding": _f32(sd, "visual.attnpool.positional_embedding"),
        **{name: linear(f"visual.attnpool.{name}")
           for name in ("q_proj", "k_proj", "v_proj", "c_proj")},
    }
    return visual, consumed


def _convert_vit_visual(sd, cfg):
    """The ViT tower's pytree and the state-dict keys it consumed."""
    visual = {
        # torch conv weight (width, 3, P, P) -> HWIO (P, P, 3, width)
        "patch_embed": _conv(sd, "visual.conv1"),
        "class_embedding": _f32(sd, "visual.class_embedding"),
        "positional_embedding": _f32(sd, "visual.positional_embedding"),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": _stack_blocks(sd, "visual.transformer", cfg.vision_layers),
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _f32(sd, "visual.proj"),
    }
    consumed = {
        "visual.conv1.weight", "visual.class_embedding", "visual.positional_embedding",
        "visual.ln_pre.weight", "visual.ln_pre.bias", "visual.ln_post.weight",
        "visual.ln_post.bias", "visual.proj",
    }
    consumed |= {f"visual.transformer.resblocks.{i}.{k}"
                 for i in range(cfg.vision_layers) for k in _BLOCK_KEYS}
    return visual, consumed


def clip_params_from_state_dict(sd, cfg=None):
    """Convert a torch CLIP state dict (ViT or ModifiedResNet) to (params
    pytree, CLIPConfig).  Every key must be mapped or match a sanctioned
    skip pattern, else ValueError."""
    sd = dict(sd)
    if cfg is None:
        cfg = config_from_state_dict_shapes(sd)

    visual, consumed = (_convert_vit_visual if cfg.is_vit else _convert_resnet_visual)(sd, cfg)
    params = {
        "visual": visual,
        "text": {
            "token_embedding": _f32(sd, "token_embedding.weight"),
            "positional_embedding": _f32(sd, "positional_embedding"),
            "blocks": _stack_blocks(sd, "transformer", cfg.transformer_layers),
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": _f32(sd, "text_projection"),
        },
        "logit_scale": _f32(sd, "logit_scale").reshape(()),
    }

    consumed |= {"token_embedding.weight", "positional_embedding", "ln_final.weight",
                 "ln_final.bias", "text_projection", "logit_scale"}
    consumed |= {f"transformer.resblocks.{i}.{k}"
                 for i in range(cfg.transformer_layers) for k in _BLOCK_KEYS}
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


def _random_resnet_visual(cfg, rng):
    """ModifiedResNet random weights (reference init: every bottleneck's bn3
    scale zeroed, the attention pool's projections at std width**-0.5,
    clip/model.py:573-583; the convs uniform at fan-in scale), drawn in the
    JAX package's order (convert.py:354-422)."""

    def conv(kh, kw, cin, cout):
        bound = 1.0 / np.sqrt(cin * kh * kw)
        return rng.uniform(-bound, bound, (kh, kw, cin, cout)).astype(np.float32)

    def bn(c, zero_scale=False):
        return {"scale": (np.zeros if zero_scale else np.ones)(c).astype(np.float32),
                "bias": np.zeros(c, np.float32), "mean": np.zeros(c, np.float32),
                "var": np.ones(c, np.float32)}

    W = cfg.vision_width
    visual = {
        "stem": {"conv1": conv(3, 3, 3, W // 2), "bn1": bn(W // 2),
                 "conv2": conv(3, 3, W // 2, W // 2), "bn2": bn(W // 2),
                 "conv3": conv(3, 3, W // 2, W), "bn3": bn(W)},
        "layers": [],
    }
    inplanes = W
    for li, n_blocks in enumerate(cfg.vision_layers):
        planes = W * (2 ** li)
        stage = []
        for b in range(n_blocks):
            block = {"conv1": conv(1, 1, inplanes if b == 0 else planes * 4, planes),
                     "bn1": bn(planes),
                     "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
                     "conv3": conv(1, 1, planes, planes * 4),
                     "bn3": bn(planes * 4, zero_scale=True)}
            if b == 0:
                block["downsample"] = {"conv": conv(1, 1, inplanes, planes * 4),
                                       "bn": bn(planes * 4)}
            stage.append(block)
        inplanes = planes * 4
        visual["layers"].append(stage)

    width = W * 32
    std = width ** -0.5
    spacial = cfg.image_resolution // 32

    def linear(cin, cout):
        return {"w": rng.normal(0, std, (cin, cout)).astype(np.float32),
                "b": np.zeros(cout, np.float32)}

    visual["attnpool"] = {
        "positional_embedding": (rng.randn(spacial ** 2 + 1, width)
                                 / np.sqrt(width)).astype(np.float32),
        "q_proj": linear(width, width),
        "k_proj": linear(width, width),
        "v_proj": linear(width, width),
        "c_proj": linear(width, cfg.embed_dim),
    }
    return visual


def random_clip_params(cfg: CLIPConfig, seed=0):
    """Random CLIP weights with the reference's init distributions
    (clip/model.py:567-591), drawn in the same RandomState order as the JAX
    package (an RN tower first, then the text tower), so one seed gives the
    same weights in both."""
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

    if not cfg.is_vit:
        visual = _random_resnet_visual(cfg, rng)
        return {"visual": visual, "text": _random_text(cfg, normal, make_blocks),
                "logit_scale": np.float32(np.log(1 / 0.07))}
    W = cfg.vision_width
    scale = W ** -0.5
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
        "text": _random_text(cfg, normal, make_blocks),
        "logit_scale": np.float32(np.log(1 / 0.07)),
    }


def _random_text(cfg, normal, make_blocks):
    D = cfg.transformer_width
    return {
        "token_embedding": normal((cfg.vocab_size, D), 0.02),
        "positional_embedding": normal((cfg.context_length, D), 0.01),
        "blocks": make_blocks(cfg.transformer_layers, D),
        "ln_final": {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)},
        "text_projection": normal((D, cfg.embed_dim), D ** -0.5),
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
    ``nn.ModuleList`` takes a list with one subtree per module (the RN
    stages and blocks), or a subtree whose leaves carry the layer axis
    first, and gets row i in layer i.  A parameter marked ``from_hwio`` (an
    RN conv kernel, stored OIHW) takes the pytree's HWIO kernel transposed.
    A leaf that is the JAX package's int8 record {"q8", "scale"[, "xs"]}
    (``fsvlm_tpu.ops.quant``) replaces the float weight by an
    ``ops.quant.Int8Weight`` holding its bytes exactly (``q8`` put in the
    port's column-major layout there).  Every parameter of ``module`` must
    be covered and every leaf must fit, or this raises.  Values are cast to
    each parameter's dtype and device.
    """
    if isinstance(module, nn.ModuleList):
        if isinstance(params_np, (list, tuple)):
            if len(params_np) != len(module):
                raise ValueError(f"{_path}: {len(params_np)} subtrees for {len(module)} modules")
            subs = params_np
        else:
            subs = [_index_tree(params_np, i, len(module), _path) for i in range(len(module))]
        for i, (layer, sub) in enumerate(zip(module, subs)):
            load_jax_params(layer, sub, f"{_path}[{i}]")
        return
    seen = set()
    for name, value in params_np.items():
        path = f"{_path}/{name}"
        if not hasattr(module, name):
            raise KeyError(f"{path}: no such submodule or parameter")
        target = getattr(module, name)
        if isinstance(value, dict) and "q8" in value:
            rec = _int8_record(value, target, path)
            delattr(module, name)  # the float parameter the record replaces
            setattr(module, name, rec)
        elif isinstance(target, nn.Module):
            load_jax_params(target, value, path)
        else:
            arr = _as_f32(value)
            if getattr(target, "from_hwio", False) and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{path}: shape {arr.shape} != {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.from_numpy(np.array(arr, copy=True)))
        seen.add(name)
    missing = [n for n, _ in module.named_children() if n not in seen]
    missing += [n for n, _ in module.named_parameters(recurse=False) if n not in seen]
    if missing:
        raise KeyError(f"{_path or '/'}: not in the pytree: {missing}")


def _int8_record(rec, target, path):
    """The JAX int8 record ``rec`` (numpy) as an Int8Weight on ``target``'s
    device, shaped as the float weight it replaces."""
    from ...ops.quant import Int8Weight

    q8 = np.asarray(rec["q8"])
    if q8.dtype != np.int8 or tuple(q8.shape) != tuple(target.shape):
        raise ValueError(f"{path}: int8 record q8 {q8.dtype} {q8.shape} for a weight of "
                         f"shape {tuple(target.shape)}")
    dev = target.device

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    xs = rec.get("xs")
    return Int8Weight(torch.from_numpy(q8.copy()).to(dev), f32(rec["scale"]),
                      None if xs is None else f32(xs))


def _index_tree(tree, i, n, path):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i, n, f"{path}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.shape[0] != n:
        raise ValueError(f"{path}: layer axis {arr.shape[0]} != {n} layers")
    return arr[i]
