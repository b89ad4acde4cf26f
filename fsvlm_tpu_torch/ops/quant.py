"""W8A8 int8 for the frozen CLIP towers: serving and the int8 frozen teacher
(counterpart of fsvlm_tpu.ops.quant).

Scheme, as in the JAX package:
  * weights: symmetric per output channel over the contraction axis,
    scale = max(amax, 1e-12) / 127, q8 = clip(round(w / scale), -127, 127)
    (``torch.round`` rounds half to even, as ``jnp.round``), computed once
    at quantization (``quantize_weight``);
  * activations: dynamic per-row scales max(amax_row(|x|), 1e-12) / 127 in
    fp32, or the record's static per-tensor scale ``xs`` calibrated once
    over a few batches (``calibrate_visual_amax``);
  * the product int8 x int8 -> int32 (``torch._int_mm``, cuBLASLt on the
    card), then y = y * x_scale * w_scale in fp32, in that order, cast to
    x's dtype, plus the bias.

The JAX package's int8 product is XLA's int8 ``dot_general`` (JAX
:81-84), outside any Pallas kernel, so it is no TPU kernel to port: the
product goes to ``torch._int_mm`` as a plain large matrix product, and the
activation quantization (amax, divide, round, clip, cast) is plain torch,
as XLA fused it.  ``int8_linear`` never falls back to a float product:
where ``torch._int_mm`` refuses a shape (on the card: at most 16 rows, or a
width that is no multiple of 8), it raises.

Layout: cuBLASLt's int8 kernels take the weight operand column-major (its
"TN" form).  Handed a row-major (D_in, D_out) matrix, ``torch._int_mm``
runs 4-6x slower at the tower's shapes and refuses small ones
(CUBLAS_STATUS_NOT_SUPPORTED); ``chip_smoke.py`` phase 14 times both
layouts (PERF.md §6).  So ``Int8Weight.q8`` has the JAX package's
shape (..., D_in, D_out) and is stored once, at quantization, as the
transpose of a contiguous (..., D_out, D_in) tensor: each call hands it to
``torch._int_mm`` as it is, with no copy.

What stays float: the attention scores and probabilities, LayerNorm,
softmax and logits, the patch embedding and the final projections, and
every float leaf of the quantized CLIP, which is shared with the float
CLIP, not copied.  FROZEN ONLY: nothing differentiates through the int8
weights (``trainer.test()`` serving under MODEL.QUANT_INT8 and the no-grad
teachers under INT8_TEACHER).
"""

import copy

import torch
from torch import nn

#: (submodule, weight) of each GEMM of a transformer block, in the order of
#: the calibration's columns (qkv, out-proj, fc, proj)
_TOWER_GEMMS = (("attn", "w_qkv"), ("attn", "w_out"), ("mlp", "w_fc"), ("mlp", "w_proj"))
#: int8 products launched (``int8_linear``), as the kernels' LAUNCHES count
LAUNCHES = {"int8_gemm": 0}


def _over_127(t):
    """t / 127 by IEEE division, as JAX divides.  The divisor is a tensor on
    t's device: a CUDA kernel divides by a CPU scalar as a product with its
    reciprocal, an ulp off for some t, and that ulp moves a scale and the
    int8 rounding of whatever is divided by it."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def _tn_layout(q8):
    """``q8`` (..., D_in, D_out) with the memory of a contiguous
    (..., D_out, D_in) tensor: the column-major weight operand that
    cuBLASLt's int8 kernels read without a copy."""
    return q8.transpose(-1, -2).contiguous().transpose(-1, -2)


class Int8Weight(nn.Module):
    """An int8 quantization record, the JAX package's {"q8", "scale", "xs"}:
    ``q8`` int8 (..., D_in, D_out) (stored column-major, see the module
    note), ``scale`` fp32 (..., D_out), and ``xs``, None (dynamic
    activation scales) or the static activation scale, fp32: a scalar for
    one layer's weight, or one per layer of a stacked weight."""

    def __init__(self, q8, scale, xs=None):
        super().__init__()
        if q8.dtype != torch.int8:
            raise ValueError(f"q8 must be int8, got {q8.dtype}")
        self.register_buffer("q8", _tn_layout(q8))
        self.register_buffer("scale", scale.float())
        self.register_buffer("xs", None if xs is None else xs.float())


def is_quantized(w):
    return isinstance(w, Int8Weight)


def quantize_weight(w):
    """fp weight (..., D_in, D_out) -> ``Int8Weight`` with per-output-channel
    scales over the contraction axis; a stacked (n_layers, D_in, D_out)
    leaf quantizes per (layer, output channel)."""
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=-2)  # the contraction axis
    scale = _over_127(torch.clamp_min(amax, 1e-12))
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -127, 127).to(torch.int8)
    return Int8Weight(q, scale)


def quantize_activation(x, xs=None):
    """(int8 x, its fp32 scale): x (..., D_in) float over its per-row scale
    max(amax_row(|x|), 1e-12) / 127, or over the static scale ``xs``,
    rounded half to even and clipped to [-127, 127]."""
    x32 = x.float()
    if xs is not None:
        x_scale = torch.clamp_min(xs, 1e-12)
    else:
        x_scale = _over_127(torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True), 1e-12))
    return torch.clamp(torch.round(x32 / x_scale), -127, 127).to(torch.int8), x_scale


def int8_linear(x, wq, b=None):
    """y = x @ W + b with W an ``Int8Weight`` of one layer (2-D ``q8``) and
    x (..., D_in) float quantized per row, or by the record's static ``xs``."""
    xq, x_scale = quantize_activation(x, wq.xs)
    y = torch._int_mm(xq.reshape(-1, xq.shape[-1]), wq.q8)
    LAUNCHES["int8_gemm"] += 1
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    y = (y.float() * x_scale * wq.scale).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _shallow_copy(module):
    """A new module object that shares every parameter, buffer and child of
    ``module``; assigning to the copy leaves ``module`` as it is."""
    out = copy.copy(module)
    out._parameters = dict(module._parameters)
    out._buffers = dict(module._buffers)
    out._non_persistent_buffers_set = set(module._non_persistent_buffers_set)
    out._modules = dict(module._modules)
    return out


def quantize_blocks(blocks, families=("attn", "mlp"), static_amax=None):
    """The blocks (an ``nn.ModuleList`` of ResidualAttentionBlock) with the
    GEMM weights of ``families`` ⊆ {"attn", "mlp"} as ``Int8Weight``s
    ({"mlp"} quantizes only the two wide MLP GEMMs).  Every other leaf is
    the float blocks' own.  ``static_amax``: optional (n_layers, 4)
    per-layer GEMM-input maxima (``calibrate_visual_amax``; columns in
    ``_TOWER_GEMMS`` order); each record then carries xs = max(amax,
    1e-12) / 127."""
    out = []
    for i, block in enumerate(blocks):
        new = _shallow_copy(block)
        for gi, (group, name) in enumerate(_TOWER_GEMMS):
            w = getattr(getattr(block, group), name)
            if group not in families or is_quantized(w):
                continue
            if getattr(new, group) is getattr(block, group):
                setattr(new, group, _shallow_copy(getattr(block, group)))
            rec = quantize_weight(w)
            if static_amax is not None:
                amax = torch.as_tensor(static_amax)[i, gi].to(w.device, torch.float32)
                rec.xs = _over_127(torch.clamp_min(amax, 1e-12))
            delattr(getattr(new, group), name)  # the copy's float parameter
            setattr(getattr(new, group), name, rec)
        out.append(new)
    return nn.ModuleList(out)


def quantize_clip(clip, towers=("visual",), families=("attn", "mlp"), static_amax=None):
    """A CLIP whose ``towers`` ⊆ {"visual", "text"} have their transformer
    blocks in int8 (``quantize_blocks``), sharing every float leaf with
    ``clip``.  Only ViT-style ``blocks`` are quantized: a ModifiedResNet
    image tower is left as it is (JAX :130-132).  ``static_amax``: optional
    {tower: (n_layers, 4)} calibrated maxima, for static activation
    scales."""
    out = _shallow_copy(clip)
    for t in towers:
        sub = getattr(clip, t, None)
        if sub is None or not isinstance(getattr(sub, "blocks", None), nn.ModuleList):
            continue
        amax = None if static_amax is None else static_amax.get(t)
        new = _shallow_copy(sub)
        new.blocks = quantize_blocks(sub.blocks, families=families, static_amax=amax)
        setattr(out, t, new)
    return out


@torch.no_grad()
def calibrate_visual_amax(clip, batches, compute_dtype=None, attn_impl=None):
    """The float ViT image tower's per-layer maxima of its four GEMM inputs
    over ``batches`` (an iterable of (B, H, W, 3) CLIP-normalized images),
    the elementwise max over the batches, as an (n_layers, 4) fp32 tensor
    for ``quantize_clip(static_amax={"visual": ...})``.  The compute dtype
    defaults to bf16 on the card and fp32 on the CPU (the JAX package
    picks it by backend).  Raises on no batches."""
    from ..models.clip.model import encode_image

    device = clip.logit_scale.device
    if compute_dtype is None:
        compute_dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    total = None
    for imgs in batches:
        _, amax = encode_image(clip, torch.as_tensor(imgs).to(device), compute_dtype=compute_dtype,
                               attn_impl=attn_impl, collect_gemm_amax=True)
        total = amax if total is None else torch.maximum(total, amax)
    if total is None:
        raise ValueError("calibrate_visual_amax: no calibration batches")
    return total
