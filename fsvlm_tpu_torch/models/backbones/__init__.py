"""The backbone zoo (counterpart of fsvlm_tpu.models.backbones): CNN
feature extractors looked up by name in ``BACKBONE_REGISTRY`` and built
with ``build_backbone(name, seed=...)``.

A backbone is an ``nn.Module`` holding its weights (as drawn by the JAX
package from the same seed), with ``init_state()`` its BatchNorm running
statistics as a nested dict of tensors (the JAX tree's ``state``) and
``forward(x, state, train=False, draws=None) -> (features (B, fdim), new
state)`` on NCHW images; ``draws`` (``models.draws``) feeds the stochastic
variants in train mode.  The JAX package's two wide ResNets
(wide_resnet_16_4, wide_resnet_28_2: the SSL trainers' backbones, not
ported yet) raise KeyError naming ROADMAP A9.
"""

import torch.nn as nn

from ...utils.registry import Registry

BACKBONE_REGISTRY = Registry("BACKBONE")

# the JAX package's backbones that this package does not have yet
UNPORTED = ("wide_resnet_16_4", "wide_resnet_28_2")


class Backbone(nn.Module):
    out_features = None

    def init_state(self):
        return {}

    def forward(self, x, state, train=False, draws=None):
        raise NotImplementedError


def build_backbone(name, verbose=False, **kwargs):
    if name in UNPORTED:
        raise KeyError(f"Backbone {name!r} is one of the Dassl SSL zoo's wide ResNets, not "
                       f"ported yet (ROADMAP A9)")
    backbone = BACKBONE_REGISTRY.get(name)(**kwargs)
    if verbose:
        print(f"Backbone: {name} (fdim={backbone.out_features})")
    return backbone


from . import cnn_digit, efficientnet, misc, resnet  # noqa: E402,F401  (register)
