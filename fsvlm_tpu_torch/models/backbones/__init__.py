"""The backbone zoo (counterpart of fsvlm_tpu.models.backbones): CNN
feature extractors looked up by name in ``BACKBONE_REGISTRY`` and built
with ``build_backbone(name, seed=...)``.

A backbone is an ``nn.Module`` holding its weights (as drawn by the JAX
package from the same seed), with ``init_state()`` its BatchNorm running
statistics as a nested dict of tensors (the JAX tree's ``state``) and
``forward(x, state, train=False, draws=None) -> (features (B, fdim), new
state)`` on NCHW images; ``draws`` (``models.draws``) feeds the stochastic
variants in train mode.  The registry holds every backbone of the JAX
package's, the SSL trainers' two wide ResNets included.
"""

import torch.nn as nn

from ...utils.registry import Registry

BACKBONE_REGISTRY = Registry("BACKBONE")


class Backbone(nn.Module):
    out_features = None

    def init_state(self):
        return {}

    def forward(self, x, state, train=False, draws=None):
        raise NotImplementedError


def build_backbone(name, verbose=False, **kwargs):
    backbone = BACKBONE_REGISTRY.get(name)(**kwargs)
    if verbose:
        print(f"Backbone: {name} (fdim={backbone.out_features})")
    return backbone


from . import cnn_digit, efficientnet, misc, resnet, wide_resnet  # noqa: E402,F401  (register)
