"""CLIP backbone resolution (counterpart of fsvlm_tpu.trainers.backbone).

1. ``$FSVLM_CLIP_WEIGHTS`` (a file, or a directory holding
   ``<Name-with-dashes>.pt``), then ``~/.cache/clip/<Name>.pt``, when
   pretrained weights are asked for;
2. random weights with the reference init distributions otherwise (and for
   the test-tiny configs), from ``seed``.

``frozen_dtype`` "bf16" stores the frozen towers in bfloat16
(MODEL.FROZEN_DTYPE); LayerNorm statistics, softmax and logits stay fp32.
"""

import os

import torch

from ..models.clip import ARCHS, CLIP, load_jax_params
from ..models.clip.convert import load_openai_checkpoint, random_clip_params

_FILENAMES = {
    "ViT-B/16": "ViT-B-16.pt",
    "ViT-B/32": "ViT-B-32.pt",
    "RN50": "RN50.pt",
    "RN101": "RN101.pt",
    "RN50x4": "RN50x4.pt",
    "RN50x16": "RN50x16.pt",
}

FROZEN_DTYPES = {"fp32": torch.float32, "float32": torch.float32, "": torch.float32,
                 "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def find_clip_weights(name):
    fname = _FILENAMES.get(name)
    candidates = []
    env = os.environ.get("FSVLM_CLIP_WEIGHTS")
    if env:
        candidates.append(env if os.path.isfile(env) else os.path.join(env, fname or ""))
    if fname:
        candidates.append(os.path.expanduser(os.path.join("~/.cache/clip", fname)))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    return None


def frozen_dtype(mode):
    try:
        return FROZEN_DTYPES[str(mode).lower()]
    except KeyError:
        raise ValueError(f"Unknown FROZEN_DTYPE: {mode}") from None


def clip_from_params(params_np, cfg, dtype=torch.float32, device=None):
    """A CLIP module on ``device`` (default cuda) holding a JAX-layout numpy
    pytree."""
    clip = CLIP(cfg, dtype=dtype, device=device)
    load_jax_params(clip, params_np)
    return clip.requires_grad_(False).eval()


def clip_for_trainer(cfg, clip, device):
    """The frozen CLIP a trainer runs: ``clip``, which must lie on
    ``device``, else the backbone of MODEL.BACKBONE (FROZEN_DTYPE, random
    weights from SEED unless PRETRAINED) on ``device``."""
    if clip is None:
        clip = load_clip_backbone(cfg.MODEL.BACKBONE.NAME, cfg.MODEL.BACKBONE.PRETRAINED,
                                  cfg.MODEL.FROZEN_DTYPE, cfg.SEED, device)
    if clip.logit_scale.device != device:
        raise ValueError(f"clip lies on {clip.logit_scale.device}, not {device}")
    return clip


def load_clip_backbone(name="ViT-B/16", pretrained=False, frozen="fp32", seed=0,
                       device=None):
    """Returns a frozen CLIP module for architecture ``name`` on ``device``
    (default cuda; asking for cuda without a card raises)."""
    if name not in ARCHS:
        raise ValueError(f"Unknown CLIP backbone: {name} (choices {sorted(ARCHS)})")
    dtype = frozen_dtype(frozen)
    if name.startswith("test-tiny") or not pretrained:
        print(f"Building {name} CLIP with random weights (no pretrained load)")
        arch = ARCHS[name]
        return clip_from_params(random_clip_params(arch, seed=max(seed, 0)), arch, dtype, device)
    path = find_clip_weights(name)
    if path is None:
        raise FileNotFoundError(
            f"No CLIP weights found for {name}. Set FSVLM_CLIP_WEIGHTS or place "
            f"{_FILENAMES.get(name)} under ~/.cache/clip.")
    print(f"Loading CLIP {name} from {path}")
    params, cfg = load_openai_checkpoint(path)
    return clip_from_params(params, cfg, dtype, device)
