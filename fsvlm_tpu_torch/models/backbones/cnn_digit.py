"""The digit-benchmark CNNs for 32x32 inputs (counterpart of
fsvlm_tpu.models.backbones.cnn_digit):

- cnn_digitsdg: 4 x [conv3x3-64 + relu, max pool 2], flattened: fdim 256;
- cnn_digitsingle: conv5 (valid) x 2 with pools, fc3, fc4: fdim 1024;
- cnn_digit5_m3sda: 3 x conv5 (pad 2) + bn (pools after the first two),
  fc1 (8192 -> 3072) + bn, dropout 0.5 in train mode (its keep mask from
  ``draws``; none without draws, as the JAX package without an rng),
  fc2 (3072 -> 2048) + bn: fdim 2048.

Every flatten is in NHWC order (``flatten_nhwc``), as the JAX package's, so
that the layers reading it take the JAX weights transposed.
"""

import numpy as np

from ..draws import bernoulli_rows
from . import BACKBONE_REGISTRY, Backbone
from .common import (
    BatchNorm,
    Conv,
    Linear,
    batch_norm,
    conv,
    flatten_nhwc,
    linear,
    max_pool,
    relu,
)


class CnnDigitsDG(Backbone):
    def __init__(self, seed=0, c_hidden=64):
        super().__init__()
        rng = np.random.RandomState(seed)
        for i in range(4):
            self.add_module(f"conv{i}", Conv(rng, 3, 3, 3 if i == 0 else c_hidden, c_hidden,
                                             bias=True))
        self.out_features = c_hidden * 2 * 2

    def forward(self, x, state, train=False, draws=None):
        h = x
        for i in range(4):
            h = max_pool(relu(conv(h, getattr(self, f"conv{i}"), 1, 1)), 2, 2, 0)
        return flatten_nhwc(h), state


class CnnDigitSingle(Backbone):
    out_features = 1024

    def __init__(self, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.conv1 = Conv(rng, 5, 5, 3, 64, bias=True)
        self.conv2 = Conv(rng, 5, 5, 64, 128, bias=True)
        self.fc3 = Linear(rng, 5 * 5 * 128, 1024)
        self.fc4 = Linear(rng, 1024, 1024)

    def forward(self, x, state, train=False, draws=None):
        h = max_pool(relu(conv(x, self.conv1)), 2, 2, 0)
        h = max_pool(relu(conv(h, self.conv2)), 2, 2, 0)
        h = relu(linear(flatten_nhwc(h), self.fc3))
        return relu(linear(h, self.fc4)), state


class CnnDigit5M3SDA(Backbone):
    out_features = 2048
    BNS = (("bn1", 64), ("bn2", 64), ("bn3", 128), ("bnf1", 3072), ("bnf2", 2048))

    def __init__(self, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.conv1 = Conv(rng, 5, 5, 3, 64, bias=True)
        self.conv2 = Conv(rng, 5, 5, 64, 64, bias=True)
        self.conv3 = Conv(rng, 5, 5, 64, 128, bias=True)
        self.fc1 = Linear(rng, 8192, 3072)
        self.fc2 = Linear(rng, 3072, 2048)
        for name, c in self.BNS:
            self.add_module(name, BatchNorm(c))

    def init_state(self):
        return {name: getattr(self, name).init_state() for name, _ in self.BNS}

    def forward(self, x, state, train=False, draws=None):
        ns = {}
        h = conv(x, self.conv1, 1, 2)
        h, ns["bn1"] = batch_norm(h, self.bn1, state["bn1"], train)
        h = max_pool(relu(h), 3, 2, 1)
        h = conv(h, self.conv2, 1, 2)
        h, ns["bn2"] = batch_norm(h, self.bn2, state["bn2"], train)
        h = max_pool(relu(h), 3, 2, 1)
        h = conv(h, self.conv3, 1, 2)
        h, ns["bn3"] = batch_norm(h, self.bn3, state["bn3"], train)
        h = flatten_nhwc(relu(h))
        h, ns["bnf1"] = batch_norm(linear(h, self.fc1), self.bnf1, state["bnf1"], train)
        h = relu(h)
        if train and draws is not None:  # F.dropout(training=...), p = 0.5
            keep = bernoulli_rows(draws, 0.5, h.shape)
            h = h * keep / 0.5
        h, ns["bnf2"] = batch_norm(linear(h, self.fc2), self.bnf2, state["bnf2"], train)
        return relu(h), ns


@BACKBONE_REGISTRY.register()
def cnn_digitsdg(seed=0, **kw):
    return CnnDigitsDG(seed)


@BACKBONE_REGISTRY.register()
def cnn_digitsingle(seed=0, **kw):
    return CnnDigitSingle(seed)


@BACKBONE_REGISTRY.register()
def cnn_digit5_m3sda(seed=0, **kw):
    return CnnDigit5M3SDA(seed)
