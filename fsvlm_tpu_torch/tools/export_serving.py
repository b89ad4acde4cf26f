"""Export the CLIP serving function as a ``torch.export`` program
(counterpart of the repository's tools/export_serving.py).

The JAX tool serializes the jitted uint8-pixels -> (top-1, logits) serving
function with ``jax.export``: normalization, the image tower, the class text
features and the logit math in one program, the text features and the
logit scale folded in as constants, the image tower's weights a runtime
input, so that one artifact serves any fine-tune.  Here the same function
is a ``torch.export`` program saved with ``torch.export.save``: the image
tower's weights are its first input, a flat dict of tensors named as the
CLIP module names them (``visual.blocks.0.attn.w_qkv``, ...), applied with
``torch.func.functional_call``; the text features, the logit scale and the
pixel statistics are the program's own buffers.

Exported on the card, the program's attention nodes are the port's
operators (``torch.ops.fsvlm.flash_attn_fwd_d64`` at head dim 64, the
blockwise one under ``FSVLM_FORCE_PALLAS=1``), the hand-written kernels
themselves, not aten's attention.  So loading the artifact needs torch and
the port's operator module, ``fsvlm_tpu_torch.ops.flash_attention``, which
registers the ``fsvlm::*`` operators and builds their kernels from the
repository's sources at the first launch: ``load_serving`` imports it
before ``torch.export.load``.  (A StableHLO file needs no framework because
XLA's attention is an XLA op; this program's attention is the repository's
own kernel.)  The program takes its inputs with the layouts it was
exported with; ``load_serving``'s callable refuses other strides, such as
a row-major int8 weight, rather than lay them out on every call.

    python -m fsvlm_tpu_torch.tools.export_serving --arch ViT-B/16 \\
        --classes 100 --batch 96 --out /tmp/clip_serving.pt2 \\
        [--int8 [--int8-families attn,mlp] [--int8-static]] [--bf16] \\
        [--device cuda]
"""

import argparse
import os
from collections import Counter

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_unflatten

from .. import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _ImageTower(nn.Module):
    """The image tower of a CLIP (its ``visual`` and ``cfg``), as
    ``encode_image`` reads it, in ``compute_dtype``."""

    def __init__(self, clip, compute_dtype):
        super().__init__()
        self.visual = clip.visual
        self.cfg = clip.cfg
        self.compute_dtype = compute_dtype

    def forward(self, x):
        from ..models.clip.model import encode_image

        return encode_image(self, x, compute_dtype=self.compute_dtype)


class ServingFunction(nn.Module):
    """serve(params, images_u8) -> (top-1 int32 (B,), logits fp32 (B, C)):
    normalize, the image tower applied with ``params`` (``functional_call``),
    l2-normalize, then ``scale * imf @ txf.T`` in fp32.  The tower is held
    outside the module's own state, so that an exported program carries
    only the text features, the scale and the pixel statistics."""

    def __init__(self, clip, txf, scale, compute_dtype):
        from ..ops.preprocess import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD

        super().__init__()
        object.__setattr__(self, "_tower", _ImageTower(clip, compute_dtype))
        device = clip.logit_scale.device
        self.register_buffer("txf", txf)
        self.register_buffer("scale", scale)
        self.register_buffer("mean", torch.tensor(CLIP_PIXEL_MEAN, device=device))
        self.register_buffer("std", torch.tensor(CLIP_PIXEL_STD, device=device))

    def forward(self, params, images_u8):
        from ..models.clip.model import l2_normalize
        from ..ops.preprocess import normalize_only

        x = normalize_only(images_u8, self.mean, self.std)
        imf = l2_normalize(torch.func.functional_call(self._tower, params, (x,)))
        logits = self.scale * (imf.float() @ self.txf.float().T)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits


@torch.no_grad()
def build_serving_fn(arch, n_classes, dtype_name="float32", int8=False, classnames=None,
                     params=None, seed=0, int8_families=("attn", "mlp"), int8_static=False,
                     device=None):
    """Returns (serve, params, res): ``serve(params, uint8 images)`` ->
    (top-1 ids, logits), ``params`` the image tower's (optionally int8)
    tensors, ``res`` the input resolution.  ``params`` in: a JAX-layout
    numpy pytree (``random_clip_params``, the converter) or a built CLIP;
    random weights from ``seed`` when None.  bf16 stores and computes the
    towers in bfloat16.  int8 quantizes the image tower (``quantize_clip``);
    ``int8_static`` calibrates its activation scales on 4 batches of 32
    uint8 images from ``np.random.RandomState(7)``, as the JAX tool does."""
    from ..models.clip import ARCHS, encode_text_ids, l2_normalize, random_clip_params, tokenize
    from ..ops.preprocess import normalize_only
    from ..ops.quant import calibrate_visual_amax, quantize_clip
    from ..trainers.backbone import clip_from_params

    device = resolve_device(device)
    cfg = ARCHS[arch]
    dtype = DTYPES[dtype_name]
    if params is None:
        params = random_clip_params(cfg, seed=seed)
    clip = params if isinstance(params, nn.Module) else clip_from_params(params, cfg, dtype,
                                                                         device)

    names = classnames or [f"class {i}" for i in range(n_classes)]
    ids = torch.from_numpy(tokenize([f"a photo of a {c}." for c in names])).to(device)
    txf = l2_normalize(encode_text_ids(clip, ids, compute_dtype=dtype))
    scale = torch.exp(clip.logit_scale).float()

    if int8:
        static_amax = None
        if int8_static:
            rng_c = np.random.RandomState(7)
            r = cfg.image_resolution
            cal = [normalize_only(torch.from_numpy(rng_c.randint(
                0, 256, (32, r, r, 3), dtype=np.uint8)).to(device)) for _ in range(4)]
            static_amax = {"visual": calibrate_visual_amax(clip, cal, compute_dtype=dtype)}
        clip = quantize_clip(clip, towers=("visual",), families=int8_families,
                             static_amax=static_amax)

    serve = ServingFunction(clip, txf, scale, dtype)
    # the tower's parameters and buffers (an int8 record's q8, scale, xs)
    params = {**dict(serve._tower.named_parameters()), **dict(serve._tower.named_buffers())}
    return serve, params, cfg.image_resolution


def export_serving(arch, n_classes, batch, out_path, int8=False, dtype_name="float32",
                   classnames=None, params=None, int8_families=("attn", "mlp"),
                   int8_static=False, device=None):
    """``torch.export`` the serving function on ``device`` (default cuda)
    for uint8 (batch, res, res, 3) images and save it to ``out_path``.
    Returns (params, the artifact's bytes)."""
    device = resolve_device(device)
    serve, params, res = build_serving_fn(
        arch, n_classes, dtype_name=dtype_name, int8=int8, classnames=classnames,
        params=params, int8_families=int8_families, int8_static=int8_static, device=device)
    images = torch.zeros((batch, res, res, 3), dtype=torch.uint8, device=device)
    with torch.no_grad():
        ep = torch.export.export(serve, (params, images))
    ep.example_inputs = None  # else the archive keeps a copy of the weights
    torch.export.save(ep, out_path)
    return params, os.path.getsize(out_path)


def graph_ops(ep):
    """Counter of the operators an exported program calls, by name
    (``fsvlm.flash_attn_fwd_d64.default``, ``aten.addmm.default``, ...)."""
    return Counter(str(n.target) for n in ep.graph.nodes if n.op == "call_function")


class ServingProgram:
    """A loaded serving program: ``(params, images_u8) -> (top1, logits)``
    under no_grad.  Each input must have the name, shape, dtype, device and
    strides the program was exported with (ValueError otherwise)."""

    def __init__(self, ep):
        self.program = ep
        self.module = ep.module()
        vals = [n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"
                and n.name in ep.graph_signature.user_inputs]
        in_spec = ep.call_spec.in_spec
        (params_at, images_at), _ = tree_unflatten(list(range(in_spec.num_leaves)), in_spec)
        self.expected = {name: vals[i] for name, i in params_at.items()}
        self.expected["images"] = vals[images_at]

    def __call__(self, params, images_u8):
        if set(params) != set(self.expected) - {"images"}:
            raise ValueError("params must hold exactly the program's tower tensors: "
                             f"missing {sorted(set(self.expected) - {'images'} - set(params))}, "
                             f"unknown {sorted(set(params) - set(self.expected))}")
        for name, t in [*params.items(), ("images", images_u8)]:
            want = self.expected[name]
            if (t.shape != want.shape or t.dtype != want.dtype or t.device != want.device
                    or t.stride() != want.stride()):
                raise ValueError(
                    f"{name}: the program takes {tuple(want.shape)} {want.dtype} on "
                    f"{want.device} with strides {want.stride()}, got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device} with strides {t.stride()}")
        ordered = {name: params[name] for name in self.expected if name != "images"}
        with torch.no_grad():
            return self.module(ordered, images_u8)


def load_serving(path, device=None):
    """The serving program saved at ``path``, as a ``ServingProgram``.
    Imports the port's operator module first, so that the ``fsvlm::*``
    attention operators are registered for ``torch.export.load``; raises
    if the program was exported for another device than ``device``
    (default cuda)."""
    from ..ops import flash_attention  # noqa: F401  (registers the fsvlm:: operators)

    device = resolve_device(device)
    program = ServingProgram(torch.export.load(path))
    got = program.expected["images"].device
    if got != device:
        raise ValueError(f"{path} was exported for {got}, not {device}")
    return program


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="ViT-B/16")
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--out", required=True)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int8-families", default="attn,mlp",
                    help="GEMM families to quantize: attn,mlp | mlp")
    ap.add_argument("--int8-static", action="store_true",
                    help="calibrated static activation scales (no per-row "
                         "dynamic act-quant in the serving graph)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda", help="where to export (cuda, or cpu)")
    args = ap.parse_args(argv)

    _, nbytes = export_serving(
        args.arch, args.classes, args.batch, args.out, int8=args.int8,
        dtype_name="bfloat16" if args.bf16 else "float32",
        int8_families=tuple(args.int8_families.split(",")),
        int8_static=args.int8_static, device=args.device)
    print(f"wrote {args.out} ({nbytes / 1e6:.2f} MB, arch={args.arch}, "
          f"classes={args.classes}, batch={args.batch}, int8={args.int8})")


if __name__ == "__main__":
    main()
