"""EfficientNet B0-B7 (counterpart of fsvlm_tpu.models.backbones.efficientnet;
Dassl's backbone/efficientnet, the lukemelas port).

MBConv blocks (1x1 expand -> depthwise conv -> squeeze-and-excite -> 1x1
project) with swish, TF-SAME padding (the padding XLA's "SAME" gives,
the larger half after: ``F.pad`` before each convolution), compound
width/depth scaling (``round_filters`` / ``round_repeats``), BatchNorm at
momentum 0.01 and eps 1e-3, and per-block drop-connect at a rate ramped
linearly over the blocks on the residual blocks; the classifier is left
out: the pooled head features, fdim ``round_filters(1280)``, after the
model's dropout.  Names follow the JAX tree: ``stem_conv``/``stem_bn``,
``block<i>`` with ``expand``/``bn0`` (expand ratio above 1), ``dw``/``bn1``,
``se_reduce``/``se_expand`` (biased), ``project``/``bn2``, and
``head_conv``/``head_bn``.  Every drop-connect mask (block order) and the
dropout mask come from ``draws``; a train-mode forward without draws
raises, as the JAX package's without an rng.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..draws import bernoulli_rows
from . import BACKBONE_REGISTRY, Backbone
from .common import BatchNorm, Conv, batch_norm

# (repeats, kernel, stride, expand, c_in, c_out, se_ratio): B0's block args
BLOCKS_ARGS = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)
# width, depth, resolution, dropout
PARAMS = {
    "b0": (1.0, 1.0, 224, 0.2), "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3), "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4), "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5), "b7": (2.0, 3.1, 600, 0.5),
}
BN_MOMENTUM, BN_EPS = 0.01, 1e-3
DROP_CONNECT = 0.2


def round_filters(filters, width, divisor=8):
    if not width:
        return filters
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats, depth):
    return int(math.ceil(depth * repeats)) if depth else repeats


def swish(x):
    return x * torch.sigmoid(x)


def conv_same(x, c, stride=1, groups=1):
    """A convolution with TF-SAME padding: total max((ceil(n / s) - 1) s + k
    - n, 0) per axis, half of it (rounded down) before."""
    k = c.w.shape[-1]
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return F.conv2d(x, c.w, c.b, stride, 0, 1, groups)


class MBConv(Backbone):
    def __init__(self, rng, k, stride, expand, cin, cout, se):
        super().__init__()
        self.stride, self.ratio, self.cin, self.cout = stride, expand, cin, cout
        mid = cin * expand
        if expand != 1:
            self.expand = Conv(rng, 1, 1, cin, mid)
            self.bn0 = BatchNorm(mid)
        self.dw = Conv(rng, k, k, 1, mid)  # depthwise: HWIO (k, k, 1, mid)
        self.bn1 = BatchNorm(mid)
        n_sq = max(1, int(cin * se))
        self.se_reduce = Conv(rng, 1, 1, mid, n_sq, bias=True)
        self.se_expand = Conv(rng, 1, 1, n_sq, mid, bias=True)
        self.project = Conv(rng, 1, 1, mid, cout)
        self.bn2 = BatchNorm(cout)
        self.bns = [n for n in ("bn0", "bn1", "bn2") if hasattr(self, n)]

    def init_state(self):
        return {n: getattr(self, n).init_state() for n in self.bns}

    def _bn(self, h, name, s, ns, train):
        h, ns[name] = batch_norm(h, getattr(self, name), s[name], train, BN_MOMENTUM, BN_EPS)
        return h

    def forward(self, x, s, train=False, drop_rate=0.0, draws=None):
        ns = {}
        h = x
        if self.ratio != 1:
            h = swish(self._bn(conv_same(h, self.expand), "bn0", s, ns, train))
        h = conv_same(h, self.dw, self.stride, groups=h.shape[1])
        h = swish(self._bn(h, "bn1", s, ns, train))
        sq = swish(conv_same(h.mean((2, 3), keepdim=True), self.se_reduce))
        h = torch.sigmoid(conv_same(sq, self.se_expand)) * h
        h = self._bn(conv_same(h, self.project), "bn2", s, ns, train)
        if self.stride == 1 and self.cin == self.cout:
            if train and drop_rate:
                keep = 1.0 - drop_rate
                h = h / keep * bernoulli_rows(draws, keep, (h.shape[0], 1, 1, 1))
            h = h + x
        return h, ns


class EfficientNet(Backbone):
    def __init__(self, name, seed=0):
        super().__init__()
        width, depth, _res, self.dropout_rate = PARAMS[name]
        rng = np.random.RandomState(seed)
        stem_out = round_filters(32, width)
        self.stem_conv = Conv(rng, 3, 3, 3, stem_out)
        self.stem_bn = BatchNorm(stem_out)
        self.block_names = []
        cin = stem_out
        for r, k, st, e, _ci, co, se in BLOCKS_ARGS:
            cout = round_filters(co, width)
            for j in range(round_repeats(r, depth)):
                name_i = f"block{len(self.block_names)}"
                self.add_module(name_i, MBConv(rng, k, st if j == 0 else 1, e, cin, cout, se))
                self.block_names.append(name_i)
                cin = cout
        self.out_features = round_filters(1280, width)
        self.head_conv = Conv(rng, 1, 1, cin, self.out_features)
        self.head_bn = BatchNorm(self.out_features)

    def init_state(self):
        return {"stem_bn": self.stem_bn.init_state(), "head_bn": self.head_bn.init_state(),
                **{n: getattr(self, n).init_state() for n in self.block_names}}

    def forward(self, x, state, train=False, draws=None):
        if train and draws is None:
            raise ValueError("efficientnet's drop-connect and dropout need draws in train mode")
        ns = {}
        h = conv_same(x, self.stem_conv, 2)
        h, ns["stem_bn"] = batch_norm(h, self.stem_bn, state["stem_bn"], train, BN_MOMENTUM,
                                      BN_EPS)
        h = swish(h)
        n = len(self.block_names)
        for i, name in enumerate(self.block_names):
            h, ns[name] = getattr(self, name)(h, state[name], train, DROP_CONNECT * float(i) / n,
                                              draws)
        h, ns["head_bn"] = batch_norm(conv_same(h, self.head_conv), self.head_bn,
                                      state["head_bn"], train, BN_MOMENTUM, BN_EPS)
        h = swish(h).mean((2, 3))
        if train and self.dropout_rate:
            keep = 1.0 - self.dropout_rate
            h = h * bernoulli_rows(draws, keep, h.shape) / keep
        return h, ns


def _register():
    for name in PARAMS:
        def build(seed=0, _name=name, **kw):
            return EfficientNet(_name, seed)

        BACKBONE_REGISTRY.register(f"efficientnet_{name}")(build)


_register()
