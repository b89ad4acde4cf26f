"""The generator zoo (counterpart of fsvlm_tpu.models.networks, :25-237):
DDAIG's perturbation FCN, its localization net and the FCN-STN, by name
from ``NETWORK_REGISTRY`` (fcn_3x32_gctx, fcn_3x64_gctx and their _stn
variants).

FCN: a reflection-padded conv stem, residual blocks with instance norm
(affine-free, no running statistics), optional global-context fusion, and
a tanh-regressed perturbation added to the input scaled by lmda; convs
drawn N(0, 0.02) as the JAX package draws them.  The STN variants warp the
input first by the affine map that LocNet predicts: ``affine_grid_sample``
is torch's affine_grid (align_corners False) and grid_sample (bilinear,
zero padding), the JAX package's ``_affine_grid_sample``.  LocNet carries
BatchNorm statistics, so every generator has ``init_state()`` and
``forward(x, state, lmda, train) -> (x_p, new state)``.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import Registry
from .backbones.common import BatchNorm, Conv, Linear, batch_norm, conv, flatten_nhwc, max_pool

NETWORK_REGISTRY = Registry("NETWORK")


def build_network(name, verbose=False, **kwargs):
    net = NETWORK_REGISTRY.get(name)(**kwargs)
    if verbose:
        print(f"Network: {name}")
    return net


def _conv(rng, kh, kw, cin, cout, bias=False):
    w = (rng.standard_normal((kh, kw, cin, cout)) * 0.02).astype(np.float32)
    return Conv(None, kh, kw, cin, cout, bias=bias, w=w)


def _instance_norm(x, eps=1e-5):
    return F.instance_norm(x, eps=eps)


def _reflect_pad(x, p=1):
    return F.pad(x, (p, p, p, p), mode="reflect")


class FCN(nn.Module):
    def __init__(self, input_nc=3, output_nc=3, nc=32, n_blocks=3, gctx=True, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.n_blocks, self.gctx = n_blocks, gctx
        self.stem = _conv(rng, 3, 3, input_nc, nc)
        for i in range(n_blocks):
            self.add_module(f"res{i}a", _conv(rng, 3, 3, nc, nc))
            self.add_module(f"res{i}b", _conv(rng, 3, 3, nc, nc))
        if gctx:
            self.fuse = _conv(rng, 1, 1, 2 * nc, nc)
        self.regress = _conv(rng, 1, 1, nc, output_nc, bias=True)

    def init_state(self):
        return {}

    def perturb(self, x, lmda=1.0, return_p=False):
        h = F.relu(_instance_norm(conv(_reflect_pad(x), self.stem)))
        for i in range(self.n_blocks):
            r = F.relu(_instance_norm(conv(_reflect_pad(h), getattr(self, f"res{i}a"))))
            r = conv(_reflect_pad(r), getattr(self, f"res{i}b"))
            h = h + _instance_norm(r)
        if self.gctx:
            c = h.mean(dim=(2, 3), keepdim=True).expand_as(h)
            h = F.relu(_instance_norm(conv(torch.cat([h, c], 1), self.fuse)))
        p = torch.tanh(conv(h, self.regress))
        x_p = x + lmda * p
        return (x_p, p) if return_p else x_p

    def forward(self, x, state, lmda=1.0, train=False):
        return self.perturb(x, lmda), state


def affine_grid_sample(x, theta):
    """Bilinear sampling of NCHW ``x`` on the affine grid of ``theta`` (B, 2,
    3), output coordinates to input ones, zero outside."""
    grid = F.affine_grid(theta.to(x.dtype), list(x.shape), align_corners=False)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


class LocNet(nn.Module):
    """The STN's localization net (ddaig_fcn.py:115-161): a strided conv +
    BN, residual blocks with max pools, and an fc predicting a 2x2 linear
    map, initialized to the identity."""

    def __init__(self, input_nc=3, nc=32, n_blocks=3, image_size=32, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.n_blocks = n_blocks
        self.stem = _conv(rng, 3, 3, input_nc, nc)
        self.stem_bn = BatchNorm(nc)
        self.bns = ["stem_bn"]
        for i in range(n_blocks):
            for part in "ab":
                self.add_module(f"res{i}{part}", _conv(rng, 3, 3, nc, nc))
                self.add_module(f"res{i}{part}_bn", BatchNorm(nc))
                self.bns.append(f"res{i}{part}_bn")
        reduced = int(image_size * 0.5 ** (n_blocks + 1))
        self.fc = Linear(None, nc * reduced * reduced, 4,
                         init={"w": np.zeros((nc * reduced * reduced, 4), np.float32),
                               "b": np.array([1, 0, 0, 1], np.float32)})

    def init_state(self):
        return {n: getattr(self, n).init_state() for n in self.bns}

    def forward(self, x, state, train=False):
        ns = {}
        h, ns["stem_bn"] = batch_norm(conv(x, self.stem, 2, 1), self.stem_bn, state["stem_bn"],
                                      train)
        h = F.relu(h)
        for i in range(self.n_blocks):
            r, ns[f"res{i}a_bn"] = batch_norm(conv(h, getattr(self, f"res{i}a"), 1, 1),
                                              getattr(self, f"res{i}a_bn"),
                                              state[f"res{i}a_bn"], train)
            r, ns[f"res{i}b_bn"] = batch_norm(conv(F.relu(r), getattr(self, f"res{i}b"), 1, 1),
                                              getattr(self, f"res{i}b_bn"),
                                              state[f"res{i}b_bn"], train)
            h = max_pool(h + r, 2, 2, 0)
        B = x.shape[0]
        lin = torch.tanh(F.linear(flatten_nhwc(h), self.fc.w, self.fc.b)).reshape(B, 2, 2)
        return torch.cat([lin, lin.new_zeros(B, 2, 1)], -1), ns


class FCNSTN(nn.Module):
    """The FCN behind a spatial transformer (the stn=True variants): LocNet
    (weights from seed + 1) warps the input, then the FCN perturbs it;
    the state is LocNet's BatchNorm statistics, updated in train mode."""

    def __init__(self, input_nc=3, output_nc=3, nc=32, n_blocks=3, gctx=True, image_size=32,
                 seed=0):
        super().__init__()
        self.fcn = FCN(input_nc, output_nc, nc, n_blocks, gctx, seed)
        self.loc = LocNet(input_nc, nc, n_blocks, image_size, seed + 1)

    def init_state(self):
        return self.loc.init_state()

    def forward(self, x, state, lmda=1.0, train=False):
        theta, new_state = self.loc(x, state, train)
        return self.fcn.perturb(affine_grid_sample(x, theta), lmda), new_state


@NETWORK_REGISTRY.register()
def fcn_3x32_gctx(seed=0, **kw):
    return FCN(3, 3, nc=32, n_blocks=3, seed=seed)


@NETWORK_REGISTRY.register()
def fcn_3x64_gctx(seed=0, **kw):
    return FCN(3, 3, nc=64, n_blocks=3, seed=seed)


@NETWORK_REGISTRY.register()
def fcn_3x32_gctx_stn(image_size=32, seed=0, **kw):
    return FCNSTN(3, 3, nc=32, n_blocks=3, image_size=image_size, seed=seed)


@NETWORK_REGISTRY.register()
def fcn_3x64_gctx_stn(image_size=224, seed=0, **kw):
    return FCNSTN(3, 3, nc=64, n_blocks=3, image_size=image_size, seed=seed)
