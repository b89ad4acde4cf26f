"""The head zoo (counterpart of fsvlm_tpu.models.heads): ``build_head(name)``
from ``HEAD_REGISTRY``; ``mlp`` is [Linear -> BN1d -> activation (->
dropout)] per hidden layer, the dropout's keep masks from ``draws``
(models/draws.py) in train mode, one per layer in order.  SimpleNet builds
its own head from MODEL.HEAD (models/simple_net.py), as the JAX package's.
"""

import numpy as np
import torch.nn.functional as F

from ..utils.registry import Registry
from .backbones import Backbone
from .backbones.common import BatchNorm, Linear, batch_norm, linear
from .draws import bernoulli_rows

HEAD_REGISTRY = Registry("HEAD")


def build_head(name, verbose=False, **kwargs):
    head = HEAD_REGISTRY.get(name)(**kwargs)
    if verbose:
        print(f"Head: {name} (out_features={head.out_features})")
    return head


class MLPHead(Backbone):
    def __init__(self, in_features=2048, hidden_layers=(), activation="relu", bn=True,
                 dropout=0.0, seed=0):
        super().__init__()
        hidden_layers = ([hidden_layers] if isinstance(hidden_layers, int)
                         else list(hidden_layers))
        assert len(hidden_layers) > 0
        if activation == "relu":
            self.act = F.relu
        elif activation == "leaky_relu":
            self.act = lambda x: F.leaky_relu(x, 0.01)
        else:
            raise NotImplementedError(activation)
        self.bn, self.dropout = bn, dropout
        self.out_features = hidden_layers[-1]
        self.n_layers = len(hidden_layers)
        rng = np.random.RandomState(seed)
        cin = in_features
        for i, width in enumerate(hidden_layers):
            self.add_module(f"fc{i}", Linear(rng, cin, width))
            if bn:
                self.add_module(f"bn{i}", BatchNorm(width))
            cin = width

    def init_state(self):
        return {f"bn{i}": getattr(self, f"bn{i}").init_state()
                for i in range(self.n_layers) if self.bn}

    def forward(self, x, state, train=False, draws=None):
        new_state = {}
        for i in range(self.n_layers):
            x = linear(x, getattr(self, f"fc{i}"))
            if self.bn:
                x, new_state[f"bn{i}"] = batch_norm(x, getattr(self, f"bn{i}"), state[f"bn{i}"],
                                                    train)
            x = self.act(x)
            if self.dropout > 0 and train:
                if draws is None:
                    raise ValueError("mlp head dropout needs draws in train mode")
                keep = bernoulli_rows(draws, 1.0 - self.dropout, x.shape)
                x = x * keep / (1.0 - self.dropout)
        return x, new_state


@HEAD_REGISTRY.register()
def mlp(**kwargs):
    return MLPHead(**kwargs)
