"""AlexNet, VGG-16 and PreAct-ResNet18 (counterpart of
fsvlm_tpu.models.backbones.misc; Dassl's backbone/{alexnet,vgg,
preact_resnet18}.py).

- alexnet: 5 biased convs with max pools, 6x6 adaptive average pooling,
  dropout 0.5 -> fc1 -> relu -> dropout 0.5 -> fc2 -> relu: fdim 4096;
- vgg16 (configuration "D", no BatchNorm): 13 biased 3x3 convs in 5 pooled
  stages, 7x7 adaptive average pooling, fc1 -> relu -> dropout 0.5 -> fc2
  -> relu -> dropout 0.5: fdim 4096;
- preact_resnet18: a 3x3 stem and pre-activation basic blocks (BatchNorm
  and relu before each conv, a 1x1 shortcut conv where the shape changes),
  4x4 average pooling: fdim 512 at 32x32.

The dropout keep masks come from ``draws`` in forward order; a train-mode
forward of alexnet or vgg16 without draws raises, as the JAX package's
without an rng.  Flattening is in NHWC order (``flatten_nhwc``).
"""

import numpy as np
import torch.nn.functional as F

from ..draws import bernoulli_rows
from . import BACKBONE_REGISTRY, Backbone
from .common import BatchNorm, Conv, Linear, batch_norm, conv, flatten_nhwc, linear, max_pool, relu


def dropout(x, draws, rate, train):
    """Inverted dropout with the keep mask from ``draws``."""
    if not train or rate == 0.0:
        return x
    if draws is None:
        raise ValueError("dropout needs draws in train mode")
    return x * bernoulli_rows(draws, 1.0 - rate, x.shape) / (1.0 - rate)


class AlexNet(Backbone):
    out_features = 4096
    CONVS = (("conv1", 11, 3, 64), ("conv2", 5, 64, 192), ("conv3", 3, 192, 384),
             ("conv4", 3, 384, 256), ("conv5", 3, 256, 256))

    def __init__(self, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        for name, k, cin, cout in self.CONVS:
            self.add_module(name, Conv(rng, k, k, cin, cout, bias=True))
        self.fc1 = Linear(rng, 256 * 6 * 6, 4096)
        self.fc2 = Linear(rng, 4096, 4096)

    def forward(self, x, state, train=False, draws=None):
        h = max_pool(relu(conv(x, self.conv1, 4, 2)), 3, 2, 0)
        h = max_pool(relu(conv(h, self.conv2, 1, 2)), 3, 2, 0)
        h = relu(conv(h, self.conv3, 1, 1))
        h = relu(conv(h, self.conv4, 1, 1))
        h = max_pool(relu(conv(h, self.conv5, 1, 1)), 3, 2, 0)
        h = flatten_nhwc(F.adaptive_avg_pool2d(h, (6, 6)))
        h = relu(linear(dropout(h, draws, 0.5, train), self.fc1))
        return relu(linear(dropout(h, draws, 0.5, train), self.fc2)), state


VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512, "M")


class VGG16(Backbone):
    out_features = 4096

    def __init__(self, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        cin, i = 3, 0
        for v in VGG16_CFG:
            if v != "M":
                self.add_module(f"conv{i}", Conv(rng, 3, 3, cin, v, bias=True))
                cin, i = v, i + 1
        self.fc1 = Linear(rng, 512 * 7 * 7, 4096)
        self.fc2 = Linear(rng, 4096, 4096)

    def forward(self, x, state, train=False, draws=None):
        h, i = x, 0
        for v in VGG16_CFG:
            if v == "M":
                h = max_pool(h, 2, 2, 0)
            else:
                h, i = relu(conv(h, getattr(self, f"conv{i}"), 1, 1)), i + 1
        h = flatten_nhwc(F.adaptive_avg_pool2d(h, (7, 7)))
        h = dropout(relu(linear(h, self.fc1)), draws, 0.5, train)
        return dropout(relu(linear(h, self.fc2)), draws, 0.5, train), state


class PreActBlock(Backbone):
    def __init__(self, rng, cin, planes, stride):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(rng, 3, 3, cin, planes)
        self.bn2 = BatchNorm(planes)
        self.conv2 = Conv(rng, 3, 3, planes, planes)
        self.shortcut = (Conv(rng, 1, 1, cin, planes) if stride != 1 or cin != planes
                         else None)

    def init_state(self):
        return {"bn1": self.bn1.init_state(), "bn2": self.bn2.init_state()}

    def forward(self, x, s, train=False, draws=None):
        ns = {}
        out, ns["bn1"] = batch_norm(x, self.bn1, s["bn1"], train)
        out = relu(out)
        shortcut = conv(out, self.shortcut, self.stride) if self.shortcut is not None else x
        out = conv(out, self.conv1, self.stride, 1)
        out, ns["bn2"] = batch_norm(out, self.bn2, s["bn2"], train)
        return conv(relu(out), self.conv2, 1, 1) + shortcut, ns


class PreActResNet18(Backbone):
    out_features = 512

    def __init__(self, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.conv1 = Conv(rng, 3, 3, 3, 64)
        cin, self.block_names = 64, []
        for stage, (planes, stride0) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            for b in range(2):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, PreActBlock(rng, cin, planes, stride0 if b == 0 else 1))
                self.block_names.append(name)
                cin = planes

    def init_state(self):
        return {n: getattr(self, n).init_state() for n in self.block_names}

    def forward(self, x, state, train=False, draws=None):
        h, ns = conv(x, self.conv1, 1, 1), {}
        for name in self.block_names:
            h, ns[name] = getattr(self, name)(h, state[name], train)
        return flatten_nhwc(F.avg_pool2d(h, 4)), ns


@BACKBONE_REGISTRY.register()
def alexnet(seed=0, **kw):
    return AlexNet(seed)


@BACKBONE_REGISTRY.register()
def vgg16(seed=0, **kw):
    return VGG16(seed)


@BACKBONE_REGISTRY.register()
def preact_resnet18(seed=0, **kw):
    return PreActResNet18(seed)
