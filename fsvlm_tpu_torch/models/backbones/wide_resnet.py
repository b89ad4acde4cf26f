"""Wide ResNet, pre-activation with LeakyReLU 0.01, the SSL zoo's backbone
(counterpart of fsvlm_tpu.models.backbones.wide_resnet; Dassl's
backbone/wide_resnet.py).

``wide_resnet_28_2`` and ``wide_resnet_16_4``: a 3x3 stem of 16 channels,
three stages of (depth - 4) / 6 pre-activation basic blocks at widths 16k,
32k and 64k (strides 1, 2, 2), then BatchNorm, LeakyReLU and global average
pooling: fdim 128 (28_2) or 256 (16_4).  A block is BN -> LeakyReLU -> conv
-> BN -> LeakyReLU -> conv; where it projects (its first block of each
stage: the width changes), the 1x1 shortcut conv taps the *activated* input,
else the shortcut is the raw input (wide_resnet.py:55-63).  The weights are
drawn from ``numpy.random.RandomState(seed)`` in the JAX package's order:
the stem, then per block conv1, conv2 and the shortcut.
"""

import numpy as np
import torch.nn.functional as F

from . import BACKBONE_REGISTRY, Backbone
from .common import BatchNorm, Conv, avg_pool_global, batch_norm, conv


def leaky_relu(x):
    return F.leaky_relu(x, 0.01)


class WideBlock(Backbone):
    def __init__(self, rng, cin, cout, stride):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(rng, 3, 3, cin, cout)
        self.bn2 = BatchNorm(cout)
        self.conv2 = Conv(rng, 3, 3, cout, cout)
        self.shortcut = Conv(rng, 1, 1, cin, cout) if cin != cout else None

    def init_state(self):
        return {"bn1": self.bn1.init_state(), "bn2": self.bn2.init_state()}

    def forward(self, x, s, train=False, draws=None):
        ns = {}
        pre, ns["bn1"] = batch_norm(x, self.bn1, s["bn1"], train)
        pre = leaky_relu(pre)
        out = conv(pre, self.conv1, self.stride, 1)
        out, ns["bn2"] = batch_norm(out, self.bn2, s["bn2"], train)
        out = conv(leaky_relu(out), self.conv2, 1, 1)
        shortcut = conv(pre, self.shortcut, self.stride) if self.shortcut is not None else x
        return shortcut + out, ns


class WideResNet(Backbone):
    def __init__(self, depth, widen_factor, seed=0):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"WideResNet depth must be 6n + 4, got {depth}")
        n = (depth - 4) // 6
        chans = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        rng = np.random.RandomState(seed)
        self.conv1 = Conv(rng, 3, 3, 3, chans[0])
        cin, self.block_names = chans[0], []
        for stage in range(3):
            for b in range(n):
                name = f"b{stage}_{b}"
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                self.add_module(name, WideBlock(rng, cin, chans[stage + 1], stride))
                self.block_names.append(name)
                cin = chans[stage + 1]
        self.bn_out = BatchNorm(cin)
        self.out_features = cin

    def init_state(self):
        s = {n: getattr(self, n).init_state() for n in self.block_names}
        s["bn_out"] = self.bn_out.init_state()
        return s

    def forward(self, x, state, train=False, draws=None):
        h, ns = conv(x, self.conv1, 1, 1), {}
        for name in self.block_names:
            h, ns[name] = getattr(self, name)(h, state[name], train)
        h, ns["bn_out"] = batch_norm(h, self.bn_out, state["bn_out"], train)
        return avg_pool_global(leaky_relu(h)), ns


@BACKBONE_REGISTRY.register()
def wide_resnet_28_2(seed=0, **kw):
    return WideResNet(28, 2, seed)


@BACKBONE_REGISTRY.register()
def wide_resnet_16_4(seed=0, **kw):
    return WideResNet(16, 4, seed)
