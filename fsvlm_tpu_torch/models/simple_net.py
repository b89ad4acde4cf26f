"""SimpleNet: backbone, optional MLP head, linear classifier (counterpart
of fsvlm_tpu.models.simple_net), the network of every zoo trainer.

``SimpleNet(cfg, cfg.MODEL, num_classes, seed)`` draws the JAX package's
weights for that seed: the backbone from ``seed``, the head's layers
(MODEL.HEAD.HIDDEN_LAYERS under a HEAD.NAME: Linear, BatchNorm if HEAD.BN,
ReLU; HEAD.ACTIVATION and DROPOUT are read by this head no more than by the
JAX package's) and the classifier from ``seed + 1``; no classifier when
``num_classes`` is 0 (a feature extractor).  ``forward(x, state,
train=False, return_feature=False, draws=None)`` -> (logits or features,
new state).  MODEL.BACKBONE.PRETRAINED imports a torchvision state_dict
that ``find_backbone_weights`` finds; with none it prints the JAX
package's warning and keeps the random weights.  Nothing is downloaded.
"""

import glob
import os

import numpy as np
import torch.nn as nn

from .backbones import build_backbone
from .backbones.common import BatchNorm, Linear, batch_norm, linear, relu


def find_backbone_weights(name):
    """A torchvision-style state_dict for ``name``: $FSVLM_BACKBONE_WEIGHTS
    (a file, or a directory holding ``<name>*.pth``/``.pt``), then the torch
    hub cache (~/.cache/torch/hub/checkpoints/<name>-*.pth); or None."""
    cand = os.environ.get("FSVLM_BACKBONE_WEIGHTS", "")
    paths = []
    if cand:
        paths += [cand] if os.path.isfile(cand) else (
            glob.glob(os.path.join(cand, f"{name}*.pth"))
            + glob.glob(os.path.join(cand, f"{name}*.pt")))
    hub = os.path.expanduser("~/.cache/torch/hub/checkpoints")
    paths += sorted(glob.glob(os.path.join(hub, f"{name}-*.pth")))
    return paths[0] if paths else None


class SimpleNet(nn.Module):
    def __init__(self, cfg, model_cfg, num_classes, seed=0, **kwargs):
        super().__init__()
        self.backbone = build_backbone(model_cfg.BACKBONE.NAME, verbose=cfg.VERBOSE, seed=seed,
                                       **kwargs)
        self._backbone_state = None
        if model_cfg.BACKBONE.PRETRAINED:
            self._try_load_pretrained(model_cfg.BACKBONE.NAME)
        fdim = self.backbone.out_features
        rng = np.random.RandomState(seed + 1)
        self.head_layers = []
        head = model_cfg.HEAD
        if head.NAME and list(head.HIDDEN_LAYERS):
            self.head = nn.Module()
            for i, width in enumerate(head.HIDDEN_LAYERS):
                self.head.add_module(f"fc{i}", Linear(rng, fdim, width))
                if head.BN:
                    self.head.add_module(f"bn{i}", BatchNorm(width))
                self.head_layers.append((i, bool(head.BN)))
                fdim = width
        self.classifier = Linear(rng, fdim, num_classes) if num_classes > 0 else None
        self.fdim = fdim

    def _try_load_pretrained(self, name):
        """Staged weights where found, else the JAX package's warning
        (simple_net.py:66-103)."""
        path = find_backbone_weights(name)
        if path is None:
            print(f"* WARNING: MODEL.BACKBONE.PRETRAINED=True but no weights "
                  f'found for "{name}" (searched $FSVLM_BACKBONE_WEIGHTS and '
                  f"~/.cache/torch/hub/checkpoints) — initializing randomly. "
                  f"Set MODEL.BACKBONE.PRETRAINED False to silence.")
            return
        from .backbones.resnet import ResNetBackbone, load_torch_state_dict

        if not isinstance(self.backbone, ResNetBackbone) or self.backbone.dynamic:
            print(f'* WARNING: pretrained import for "{name}" is not implemented (only '
                  f"plain/MixStyle resnets); found {path} but initializing randomly.")
            return
        import torch

        sd = torch.load(path, map_location="cpu", weights_only=True)
        self._backbone_state = load_torch_state_dict(self.backbone, sd)
        print(f'Loaded pretrained backbone weights from "{path}"')

    def init_state(self):
        state = {"backbone": self._backbone_state or self.backbone.init_state()}
        if self.head_layers:
            state["head"] = {f"bn{i}": getattr(self.head, f"bn{i}").init_state()
                             for i, use_bn in self.head_layers if use_bn}
        return state

    def forward(self, x, state, train=False, return_feature=False, draws=None):
        f, bb_state = self.backbone(x, state["backbone"], train, draws)
        new_state = dict(state, backbone=bb_state)
        if self.head_layers:
            nhs = {}
            for i, use_bn in self.head_layers:
                f = linear(f, getattr(self.head, f"fc{i}"))
                if use_bn:
                    f, nhs[f"bn{i}"] = batch_norm(f, getattr(self.head, f"bn{i}"),
                                                  state["head"][f"bn{i}"], train)
                f = relu(f)
            new_state["head"] = nhs
        if self.classifier is None:
            return f, new_state
        logits = linear(f, self.classifier)
        return ((logits, f) if return_feature else logits), new_state
