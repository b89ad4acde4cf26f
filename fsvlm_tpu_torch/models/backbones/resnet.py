"""The ResNet family (counterpart of fsvlm_tpu.models.backbones.resnet,
:34-280): resnet18/34/50/101/152, the MixStyle and EFDMix variants
resnet{18,50,101}_{ms,efdmix}_l{123,12,1} and the dynamic-conv variants
resnet{18,50,101}_dynamic[_ms_l{123,12,1}], registered under the JAX
package's names.

Blocks are named as the JAX tree's keys ("layer1_0", with conv1/bn1,
conv2/bn2[, conv3/bn3] and down_conv/down_bn); BatchNorm statistics are
threaded (``forward`` returns the new ones).  A style variant mixes after
the last block of each named stage in train mode, with its draws from the
``draws`` source in stage order, and raises without one.
``load_torch_state_dict`` imports a torchvision ``state_dict``: the layouts
agree, so it is a key map.
"""

import numpy as np

from . import BACKBONE_REGISTRY, Backbone
from .common import BatchNorm, Conv, avg_pool_global, batch_norm, conv, max_pool, relu

BLOCK_BASIC = "basic"
BLOCK_BOTTLENECK = "bottleneck"
_EXPANSION = {BLOCK_BASIC: 1, BLOCK_BOTTLENECK: 4}


class Block(Backbone):
    """One residual block (resnet.py:36-71); ``dynamic`` swaps its 3x3 convs
    for Conv2dDynamic with the attention over the block's input."""

    def __init__(self, rng, kind, cin, width, stride, zero_init_residual=False, dynamic=False):
        from ..modeling_ops import Conv2dDynamic

        super().__init__()
        self.kind, self.stride, self.dynamic = kind, stride, dynamic

        def conv3x3(ci, co):
            if dynamic:
                return Conv2dDynamic(rng, ci, co, 3, squeeze=max(cin // 16, 4),
                                     attention_in_channels=cin)
            return Conv(rng, 3, 3, ci, co)

        cout = width * _EXPANSION[kind]
        if kind == BLOCK_BASIC:
            self.conv1 = conv3x3(cin, width)
            self.bn1 = BatchNorm(width)
            self.conv2 = conv3x3(width, width)
            self.bn2 = BatchNorm(width, zero_scale=zero_init_residual)
        else:
            self.conv1 = Conv(rng, 1, 1, cin, width)
            self.bn1 = BatchNorm(width)
            self.conv2 = conv3x3(width, width)
            self.bn2 = BatchNorm(width)
            self.conv3 = Conv(rng, 1, 1, width, cout)
            self.bn3 = BatchNorm(cout, zero_scale=zero_init_residual)
        self.has_down = stride != 1 or cin != cout
        if self.has_down:
            self.down_conv = Conv(rng, 1, 1, cin, cout)
            self.down_bn = BatchNorm(cout)
        self.bns = [n for n in ("bn1", "bn2", "bn3", "down_bn") if hasattr(self, n)]

    def init_state(self):
        return {n: getattr(self, n).init_state() for n in self.bns}

    def forward(self, x, s, train=False, draws=None):
        from ..modeling_ops import conv2d_dynamic_apply

        def conv3x3(h, c, stride):
            if self.dynamic:
                return conv2d_dynamic_apply(h, c, stride=stride, attention_x=x)
            return conv(h, c, stride, 1)

        ns = {}
        if self.kind == BLOCK_BASIC:
            h = conv3x3(x, self.conv1, self.stride)
            h, ns["bn1"] = batch_norm(h, self.bn1, s["bn1"], train)
            h = conv3x3(relu(h), self.conv2, 1)
            h, ns["bn2"] = batch_norm(h, self.bn2, s["bn2"], train)
        else:
            h = conv(x, self.conv1)
            h, ns["bn1"] = batch_norm(h, self.bn1, s["bn1"], train)
            h = conv3x3(relu(h), self.conv2, self.stride)
            h, ns["bn2"] = batch_norm(h, self.bn2, s["bn2"], train)
            h = conv(relu(h), self.conv3)
            h, ns["bn3"] = batch_norm(h, self.bn3, s["bn3"], train)
        identity = x
        if self.has_down:
            identity = conv(x, self.down_conv, self.stride)
            identity, ns["down_bn"] = batch_norm(identity, self.down_bn, s["down_bn"], train)
        return relu(h + identity), ns


class ResNetBackbone(Backbone):
    """conv1 7x7/2 + bn1 + max pool, the blocks, global average pooling;
    ``ms_layers``/``ms_class`` mix styles (MixStyle or EFDMix) after the
    named stages (resnet.py:283-594)."""

    def __init__(self, kind, layers, seed=0, ms_layers=(), ms_class="mixstyle", ms_p=0.5,
                 ms_a=0.1, dynamic=False):
        super().__init__()
        self.kind, self.layers, self.dynamic = kind, layers, dynamic
        self.out_features = 512 * _EXPANSION[kind]
        self.ms_layers, self.ms_class = tuple(ms_layers), ms_class
        self.ms_p, self.ms_a = ms_p, ms_a
        rng = np.random.RandomState(seed)
        self.conv1 = Conv(rng, 7, 7, 3, 64)
        self.bn1 = BatchNorm(64)
        cin = 64
        self.block_names = []
        for stage, n_blocks in enumerate(layers):
            width = 64 * (2 ** stage)
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Block(rng, kind, cin, width, stride, dynamic=dynamic))
                self.block_names.append(name)
                cin = width * _EXPANSION[kind]
        self.mix_after = {f"layer{stage + 1}_{n - 1}" for stage, n in enumerate(layers)
                          if f"layer{stage + 1}" in self.ms_layers}

    def init_state(self):
        return {"bn1": self.bn1.init_state(),
                **{n: getattr(self, n).init_state() for n in self.block_names}}

    def forward(self, x, state, train=False, draws=None):
        from ..modeling_ops import efdmix, mixstyle

        if self.ms_layers and train and draws is None:
            raise ValueError(f"{self.ms_class} backbone needs draws in train mode "
                             "(pass draws= through SimpleNet)")
        ns = {}
        h = conv(x, self.conv1, 2, 3)
        h, ns["bn1"] = batch_norm(h, self.bn1, state["bn1"], train)
        h = max_pool(relu(h), 3, 2, 1)
        mix = mixstyle if self.ms_class == "mixstyle" else efdmix
        for name in self.block_names:
            h, ns[name] = getattr(self, name)(h, state[name], train)
            if train and name in self.mix_after:
                h = mix(draws, h, p=self.ms_p, alpha=self.ms_a)
        return avg_pool_global(h), ns


def load_torch_state_dict(backbone, sd):
    """Copy a torchvision ResNet ``state_dict`` (torch tensors or numpy) into
    ``backbone``'s weights; returns its BatchNorm running statistics as a
    new state (resnet.py:174-220)."""
    import torch

    def get(name):
        t = sd[name]
        return torch.as_tensor(np.asarray(t.detach().cpu() if hasattr(t, "detach") else t))

    def put_bn(bn, theirs):
        bn.scale.copy_(get(theirs + ".weight"))
        bn.bias.copy_(get(theirs + ".bias"))
        return {"mean": get(theirs + ".running_mean").float().clone(),
                "var": get(theirs + ".running_var").float().clone()}

    state = {}
    with torch.no_grad():
        backbone.conv1.w.copy_(get("conv1.weight"))
        state["bn1"] = put_bn(backbone.bn1, "bn1")
        for name in backbone.block_names:
            stage, b = name.split("_")
            tv, blk, bs = f"{stage}.{b}", getattr(backbone, name), {}
            for c in ("conv1", "conv2") + (("conv3",) if backbone.kind == BLOCK_BOTTLENECK else ()):
                getattr(blk, c).w.copy_(get(f"{tv}.{c}.weight"))
                bs["bn" + c[-1]] = put_bn(getattr(blk, "bn" + c[-1]), f"{tv}.bn{c[-1]}")
            if blk.has_down:
                blk.down_conv.w.copy_(get(f"{tv}.downsample.0.weight"))
                bs["down_bn"] = put_bn(blk.down_bn, f"{tv}.downsample.1")
            state[name] = bs
    return state


_LAYERS = {"resnet18": (BLOCK_BASIC, [2, 2, 2, 2]), "resnet34": (BLOCK_BASIC, [3, 4, 6, 3]),
           "resnet50": (BLOCK_BOTTLENECK, [3, 4, 6, 3]),
           "resnet101": (BLOCK_BOTTLENECK, [3, 4, 23, 3]),
           "resnet152": (BLOCK_BOTTLENECK, [3, 8, 36, 3])}


def _register(name, **fixed):
    def build(seed=0, **kw):
        return ResNetBackbone(seed=seed, **fixed)

    BACKBONE_REGISTRY.register(name)(build)


def _register_all():
    stage_sets = (("l123", ("layer1", "layer2", "layer3")), ("l12", ("layer1", "layer2")),
                  ("l1", ("layer1",)))
    for arch, (kind, layers) in _LAYERS.items():
        _register(arch, kind=kind, layers=layers)
        if arch in ("resnet34", "resnet152"):
            continue
        for ms_class, tag in (("mixstyle", "ms"), ("efdmix", "efdmix")):
            for stages_tag, stages in stage_sets:
                _register(f"{arch}_{tag}_{stages_tag}", kind=kind, layers=layers,
                          ms_layers=stages, ms_class=ms_class)
        _register(f"{arch}_dynamic", kind=kind, layers=layers, dynamic=True)
        for stages_tag, stages in stage_sets:
            _register(f"{arch}_dynamic_ms_{stages_tag}", kind=kind, layers=layers, dynamic=True,
                      ms_layers=stages, ms_class="mixstyle")


_register_all()
