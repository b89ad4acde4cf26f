"""ModifiedResNet image tower, RN50/RN101/RN50x4/RN50x16 (counterpart of
fsvlm_tpu.models.clip.resnet).

Parity target: PromptSRC/clip/model.py:10-150: a 3-conv stem with an
average pool, anti-aliased strided bottlenecks (the average pool before the
stride-2 conv3, and on the downsample path before its 1x1 conv), and a QKV
attention pool instead of global average pooling.

The JAX package runs NHWC activations and HWIO kernels through XLA's
convolutions; here the convolutions are ``F.conv2d`` (cuDNN on the card) on
NCHW views of the same memory (the NHWC images permuted, so channels-last),
with the kernels stored OIHW, the layout ``F.conv2d`` reads:
``convert.load_jax_params`` transposes them from the pytree's HWIO once, at
load.  No attention kernel runs here: the pool's one query token against
HW + 1 keys is plain products, as JAX's einsums are.

BatchNorm always uses the frozen running statistics (the JAX package's
documented divergence from the reference, which leaves BN in train mode
during prompt tuning): the scale and shift are folded in fp32 and cast to
the activations' dtype before ``x * w + b``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.layers import frozen_param, linear


def hwio_param(kh, kw, cin, cout, dtype, device):
    """A frozen conv kernel stored OIHW (cout, cin, kh, kw); the pytree
    holds it HWIO (kh, kw, cin, cout), and ``load_jax_params`` transposes."""
    p = frozen_param((cout, cin, kh, kw), dtype, device)
    p.from_hwio = True
    return p


class BatchNorm(nn.Module):
    """Frozen BatchNorm statistics, named as the pytree's {scale, bias,
    mean, var}."""

    def __init__(self, c, dtype, device):
        super().__init__()
        for name in ("scale", "bias", "mean", "var"):
            setattr(self, name, frozen_param((c,), dtype, device))

    def forward(self, x):
        inv = torch.rsqrt(self.var.float() + 1e-5)
        scale = self.scale.float()
        w = (scale * inv).to(x.dtype)
        b = (self.bias.float() - self.mean.float() * scale * inv).to(x.dtype)
        return x * w[:, None, None] + b[:, None, None]


def _conv(x, kernel, stride=1, padding=0):
    return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=padding)


def _avg_pool(x, k):
    """A k x k window sum over k^2 (k = 2 here: the division is exact)."""
    return F.avg_pool2d(x, k)


class Stem(nn.Module):
    def __init__(self, width, dtype, device):
        super().__init__()
        half = width // 2
        self.conv1 = hwio_param(3, 3, 3, half, dtype, device)
        self.bn1 = BatchNorm(half, dtype, device)
        self.conv2 = hwio_param(3, 3, half, half, dtype, device)
        self.bn2 = BatchNorm(half, dtype, device)
        self.conv3 = hwio_param(3, 3, half, width, dtype, device)
        self.bn3 = BatchNorm(width, dtype, device)

    def forward(self, x):
        x = F.relu(self.bn1(_conv(x, self.conv1, stride=2, padding=1)))
        x = F.relu(self.bn2(_conv(x, self.conv2, padding=1)))
        x = F.relu(self.bn3(_conv(x, self.conv3, padding=1)))
        return _avg_pool(x, 2)


class Downsample(nn.Module):
    def __init__(self, cin, cout, dtype, device):
        super().__init__()
        self.conv = hwio_param(1, 1, cin, cout, dtype, device)
        self.bn = BatchNorm(cout, dtype, device)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (avg pool) -> 1x1 x4, with a pooled 1x1 downsample on
    a stage's first block (clip/model.py:10-53)."""

    def __init__(self, inplanes, planes, stride, downsample, dtype, device):
        super().__init__()
        self.stride = stride
        self.conv1 = hwio_param(1, 1, inplanes, planes, dtype, device)
        self.bn1 = BatchNorm(planes, dtype, device)
        self.conv2 = hwio_param(3, 3, planes, planes, dtype, device)
        self.bn2 = BatchNorm(planes, dtype, device)
        self.conv3 = hwio_param(1, 1, planes, planes * 4, dtype, device)
        self.bn3 = BatchNorm(planes * 4, dtype, device)
        self.downsample = Downsample(inplanes, planes * 4, dtype, device) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(_conv(x, self.conv1)))
        out = F.relu(self.bn2(_conv(out, self.conv2, padding=1)))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(_conv(out, self.conv3))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = _avg_pool(x, self.stride)
            identity = self.downsample.bn(_conv(identity, self.downsample.conv))
        return F.relu(out + identity)


class Linear(nn.Module):
    """A frozen linear stored (in, out), named as the pytree's {w, b}."""

    def __init__(self, cin, cout, dtype, device):
        super().__init__()
        self.w = frozen_param((cin, cout), dtype, device)
        self.b = frozen_param((cout,), dtype, device)

    def forward(self, t):
        return linear(t, self.w, self.b)


class AttentionPool(nn.Module):
    """QKV attention pool (AttentionPool2d, clip/model.py:56-91): the mean
    token attends over [mean; tokens]; only its output is kept."""

    def __init__(self, spacial, width, heads, out_dim, dtype, device):
        super().__init__()
        self.heads = heads
        self.positional_embedding = frozen_param((spacial ** 2 + 1, width), dtype, device)
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, Linear(width, width, dtype, device))
        self.c_proj = Linear(width, out_dim, dtype, device)

    def forward(self, x):
        """x: (B, C, H, W) -> (B, out_dim) in x's dtype."""
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, H*W, C), (H, W) row-major as JAX's
        seq = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        seq = seq + self.positional_embedding.to(seq.dtype)
        d = C // self.heads

        def heads(t):  # (B, L, C) -> (B, heads, L, d)
            return t.view(B, -1, self.heads, d).transpose(1, 2)

        q = heads(self.q_proj(seq[:, :1]))
        k, v = heads(self.k_proj(seq)), heads(self.v_proj(seq))
        # the scale before the product, the logits in fp32 (JAX :75-79)
        logits = (q * d ** -0.5).float() @ k.float().transpose(-1, -2)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (weights @ v).transpose(1, 2).reshape(B, C)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """The frozen RN tower, named as the JAX pytree: ``stem``,
    ``layers[i][j]`` (stage i, block j) and ``attnpool``."""

    def __init__(self, layers, width, heads, image_resolution, out_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.stem = Stem(width, dtype, device)
        stages, inplanes = [], width
        for i, n_blocks in enumerate(layers):
            planes = width * 2 ** i
            stages.append(nn.ModuleList(
                [Bottleneck(inplanes if j == 0 else planes * 4, planes,
                            (1 if i == 0 else 2) if j == 0 else 1, j == 0, dtype, device)
                 for j in range(n_blocks)]))
            inplanes = planes * 4
        self.layers = nn.ModuleList(stages)
        self.attnpool = AttentionPool(image_resolution // 32, width * 32, heads, out_dim,
                                      dtype, device)

    def forward(self, images, compute_dtype=torch.float32, collect_stages=False):
        """images: (B, H, W, 3) CLIP-normalized NHWC.  Returns (B, out_dim)
        fp32 features; with ``collect_stages`` also the four stage outputs,
        NHWC as JAX returns them (the golden comparison surface)."""
        x = self.stem(images.to(compute_dtype).permute(0, 3, 1, 2))
        stages = []
        for stage in self.layers:
            for block in stage:
                x = block(x)
            stages.append(x.permute(0, 2, 3, 1))
        feats = self.attnpool(x).float()
        return (feats, stages) if collect_stages else feats


def encode_image_resnet(clip, images, compute_dtype=torch.float32, collect_stages=False):
    """The RN image tower of ``clip`` (JAX :86-112)."""
    return clip.visual(images, compute_dtype=compute_dtype, collect_stages=collect_stages)
