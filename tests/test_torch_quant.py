"""The port's W8A8 int8 mode (fsvlm_tpu_torch/ops/quant.py) against the JAX
package's (fsvlm_tpu/ops/quant.py), on the CPU, with the same numpy weights
and inputs.  Mirrors tests/test_quant.py where a test applies (its mesh
test waits for ROADMAP A8).

- ``quantize_weight``: q8 and scale byte-equal, 2-D and stacked;
- ``int8_linear``: dynamic and static, within 1e-6 of JAX's largest output
  (the int32 product is exact; the rest is the same fp32 elementwise math);
- the quantized towers: a one-step int8 rounding can flip where the two
  packages' fp32 activations differ by an ulp at a rounding tie, so the
  port's int8 features are held to JAX's int8 features at a distance at
  most a third of JAX-int8's distance to JAX-fp32 (Frobenius norms);
- ``calibrate_visual_amax`` within 1e-5 relative; JAX-quantized records
  carried across by the converter byte-equal to the port's own;
- the engine's MODEL.QUANT_INT8 test() (CoOp, PromptSRC, ZeroshotCLIP;
  dynamic and static) against the JAX trainer's logits, by the towers' rule.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import CLASSNAMES, TINY, _both_cfgs

from fsvlm_tpu.models.clip import ARCHS as JAX_ARCHS
from fsvlm_tpu.models.clip import encode_image as jax_encode_image
from fsvlm_tpu.ops import quant as jq
from fsvlm_tpu_torch.models.clip import ARCHS, CLIPConfig, encode_image, random_clip_params
from fsvlm_tpu_torch.models.clip.transformer import transformer
from fsvlm_tpu_torch.ops import preprocess
from fsvlm_tpu_torch.ops import quant as pq
from fsvlm_tpu_torch.ops.layers import linear
from fsvlm_tpu_torch.trainers.backbone import clip_from_params

RATIO = 1 / 3  # port int8 to JAX int8, over JAX int8 to JAX fp32


def _params(arch, seed=0):
    return random_clip_params(ARCHS[arch], seed=seed)


def _images(n, res=32, seed=2):
    return np.random.RandomState(seed).randn(n, res, res, 3).astype(np.float32) * 0.5


def _jax_feats(params, cfg, imgs):
    return np.asarray(jax_encode_image(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(imgs)))


@torch.no_grad()
def _port_feats(clip, imgs):
    return encode_image(clip, torch.from_numpy(imgs)).numpy()


def _cos_min(a, b):
    return float(np.min(np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) *
                                             np.linalg.norm(b, axis=-1))))


def _check_close_to_jax_int8(port_q, jax_q, jax_fp, ratio=RATIO):
    gap = np.linalg.norm(jax_q - jax_fp)
    assert gap > 0
    assert np.linalg.norm(port_q - jax_q) <= ratio * gap, (np.linalg.norm(port_q - jax_q), gap)


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48), (768, 2304)],
                         ids=["2d", "stacked", "vit_b16_qkv"])
def test_quantize_weight_is_byte_equal_to_jax(shape):
    """q8 and scale byte-equal to JAX's; q8 in JAX's shape, stored
    column-major (the transpose of a contiguous (D_out, D_in)); a stacked
    weight's slice equals quantizing that layer alone."""
    w = (np.random.RandomState(1).randn(*shape) * 0.05).astype(np.float32)
    ref = jq.quantize_weight(jnp.asarray(w))
    rec = pq.quantize_weight(torch.from_numpy(w))
    assert rec.q8.dtype == torch.int8 and rec.scale.dtype == torch.float32
    np.testing.assert_array_equal(rec.q8.numpy(), np.asarray(ref["q8"]))
    np.testing.assert_array_equal(rec.scale.numpy(), np.asarray(ref["scale"]))
    assert rec.q8.transpose(-1, -2).is_contiguous() and rec.xs is None
    assert pq.is_quantized(rec) and not pq.is_quantized(torch.from_numpy(w))
    if len(shape) == 3:
        one = pq.quantize_weight(torch.from_numpy(w[1]))
        np.testing.assert_array_equal(rec.q8[1].numpy(), one.q8.numpy())
        np.testing.assert_array_equal(rec.scale[1].numpy(), one.scale.numpy())


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_linear_matches_jax(static):
    """Dynamic per-row and static per-tensor activation scales: within 1e-6
    of JAX's largest output; both within JAX's own bounds of the fp linear
    (2% / 3% relative); ``linear`` dispatches on the record."""
    rng = np.random.RandomState(9)
    x = rng.randn(4, 9, 64).astype(np.float32)
    w = (rng.randn(64, 96) * 0.05).astype(np.float32)
    b = (rng.randn(96) * 0.1).astype(np.float32)
    ref = jq.quantize_weight(jnp.asarray(w))
    rec = pq.quantize_weight(torch.from_numpy(w))
    if static:
        xs = np.float32(np.abs(x).max() / 127.0)
        ref = dict(ref, xs=jnp.asarray(xs))
        rec.xs = torch.tensor(xs)
    y_ref = np.asarray(jq.int8_linear(jnp.asarray(x), ref, jnp.asarray(b)))
    y = pq.int8_linear(torch.from_numpy(x), rec, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-6 * np.abs(y_ref).max())
    y_fp = x @ w + b
    assert np.linalg.norm(y - y_fp) / np.linalg.norm(y_fp) < (0.03 if static else 0.02)
    np.testing.assert_array_equal(linear(torch.from_numpy(x), rec, torch.from_numpy(b)).numpy(),
                                  y)


def test_int8_linear_keeps_the_input_dtype_and_has_no_fallback(monkeypatch):
    """bf16 in, bf16 out (the product's rescale in fp32), one launch counted;
    where ``torch._int_mm`` refuses a shape the error reaches the caller: no
    float product is tried, and no launch is counted."""
    rec = pq.quantize_weight(torch.randn(32, 48, generator=torch.Generator().manual_seed(0)))
    x = torch.randn(20, 32, generator=torch.Generator().manual_seed(1))
    before = pq.LAUNCHES["int8_gemm"]
    y = pq.int8_linear(x.bfloat16(), rec)
    assert y.dtype == torch.bfloat16 and y.shape == (20, 48)
    assert pq.LAUNCHES["int8_gemm"] == before + 1  # one product, counted once

    def refuse(a, b):
        raise RuntimeError("self.size(0) needs to be greater than 16")

    monkeypatch.setattr(torch, "_int_mm", refuse)
    with pytest.raises(RuntimeError, match="greater than 16"):
        pq.int8_linear(x, rec)
    assert pq.LAUNCHES["int8_gemm"] == before + 1


# ------------------------------------------------------------------- towers
def test_quantized_vit_features_match_jax():
    """test-tiny: the visual tower quantized (attn + mlp, dynamic), the text
    tower untouched and every float leaf shared; features within RATIO of
    JAX's int8 features (see the module note), and at cosine > 0.99 to the
    fp features (test_quant.py's rule)."""
    params = _params("test-tiny")
    cfg = JAX_ARCHS["test-tiny"]
    imgs = _images(8)
    jax_fp = _jax_feats(params, cfg, imgs)
    jax_q = _jax_feats(jq.quantize_clip_params(params, towers=("visual",)), cfg, imgs)

    clip = clip_from_params(params, ARCHS["test-tiny"], device="cpu")
    q = pq.quantize_clip(clip)
    block, qblock = clip.visual.blocks[0], q.visual.blocks[0]
    assert pq.is_quantized(qblock.attn.w_qkv) and pq.is_quantized(qblock.mlp.w_proj)
    assert not pq.is_quantized(block.attn.w_qkv)  # the float CLIP is left as it was
    assert q.text is clip.text and qblock.ln_1 is block.ln_1
    assert qblock.attn.b_qkv is block.attn.b_qkv
    assert q.visual.proj is clip.visual.proj and q.logit_scale is clip.logit_scale
    port_q = _port_feats(q, imgs)
    _check_close_to_jax_int8(port_q, jax_q, jax_fp)
    assert _cos_min(port_q, _port_feats(clip, imgs)) > 0.99


def test_quantized_vit_b16_layers_match_jax():
    """ViT-B/16 at full width, 2 images.  Over 12 layers the two packages'
    int8 runs decorrelate: an ulp of fp32 difference at a rounding tie
    flips one int8 step, and each layer's flips move the next layer's
    inputs by about its own quantization noise, so the towers' outputs are
    compared layer by layer instead: each quantized block of the port on
    JAX's int8 input to that layer, against JAX's quantized block, by the
    RATIO rule against JAX's float block on the same input.  The whole
    tower: cosine > 0.99 to the fp features (test_quant.py's rule)."""
    from fsvlm_tpu.models.clip.transformer import transformer as jax_transformer

    params = _params("ViT-B/16")
    cfg = JAX_ARCHS["ViT-B/16"]
    imgs = _images(2, cfg.image_resolution)
    jqp = jq.quantize_clip_params(params, towers=("visual",))
    clip = clip_from_params(params, ARCHS["ViT-B/16"], device="cpu")
    q = pq.quantize_clip(clip)
    assert _cos_min(_port_feats(q, imgs), _port_feats(clip, imgs)) > 0.99

    def layer(tree, i):
        return jax.tree.map(lambda a: jnp.asarray(a)[i:i + 1], tree)

    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, 197, 768).astype(np.float32))
    _, inputs = jax_transformer(jax.tree.map(jnp.asarray, jqp["visual"]["blocks"]), x,
                                n_heads=12, collect_activations=True)
    for i in range(12):
        xi = x if i == 0 else inputs[i - 1]
        ref_q = np.asarray(jax_transformer(layer(jqp["visual"]["blocks"], i), xi, n_heads=12))
        ref_fp = np.asarray(jax_transformer(layer(params["visual"]["blocks"], i), xi, n_heads=12))
        with torch.no_grad():
            got = transformer(q.visual.blocks[i:i + 1], torch.from_numpy(np.array(xi))).numpy()
        _check_close_to_jax_int8(got, ref_q, ref_fp)


def test_quantize_families_subset_matches_jax():
    """families ("mlp",): only the two MLP GEMMs quantize; the tower tracks
    JAX's mlp-only tower by the RATIO rule and the fp features at > 0.99."""
    params = _params("test-tiny", seed=7)
    cfg = JAX_ARCHS["test-tiny"]
    imgs = _images(4, seed=8)
    jax_fp = _jax_feats(params, cfg, imgs)
    jax_q = _jax_feats(jq.quantize_clip_params(params, towers=("visual",), families=("mlp",)),
                       cfg, imgs)
    clip = clip_from_params(params, ARCHS["test-tiny"], device="cpu")
    q = pq.quantize_clip(clip, families=("mlp",))
    for b in q.visual.blocks:
        assert pq.is_quantized(b.mlp.w_fc) and pq.is_quantized(b.mlp.w_proj)
        assert not pq.is_quantized(b.attn.w_qkv) and not pq.is_quantized(b.attn.w_out)
    port_q = _port_feats(q, imgs)
    _check_close_to_jax_int8(port_q, jax_q, jax_fp)
    assert _cos_min(port_q, jax_fp) > 0.99


def test_quantized_blocks_run_through_the_transformer():
    """quantize_blocks' output runs through ``transformer`` (JAX's scan
    test): finite, the input's shape, close to the float blocks."""
    params = _params("test-tiny", seed=3)
    clip = clip_from_params(params, ARCHS["test-tiny"], device="cpu")
    qb = pq.quantize_blocks(clip.visual.blocks)
    W = clip.cfg.vision_width
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 5, W).astype(np.float32))
    with torch.no_grad():
        out, ref = transformer(qb, x), transformer(clip.visual.blocks, x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert (out - ref).norm() / ref.norm() < 0.05


def test_resnet_tower_quantization_is_noop():
    """A ModifiedResNet image tower is left as it is (JAX :130-132)."""
    clip = clip_from_params(_params("test-tiny-rn", seed=5), ARCHS["test-tiny-rn"], device="cpu")
    q = pq.quantize_clip(clip, towers=("visual",))
    assert q.visual is clip.visual
    assert not any(isinstance(m, pq.Int8Weight) for m in q.modules())


# --------------------------------------------------------------- calibration
def test_calibrate_visual_amax_matches_jax():
    """The float tower's per-layer GEMM-input maxima over 3 batches, fp32:
    within 1e-5 relative of JAX's; the collect hook leaves the features as
    they were; no batches raises."""
    params = _params("test-tiny")
    cal = [_images(4, seed=11 + i) for i in range(3)]
    ref = np.asarray(jq.calibrate_visual_amax(jax.tree.map(jnp.asarray, params),
                                              JAX_ARCHS["test-tiny"],
                                              [jnp.asarray(c) for c in cal],
                                              compute_dtype=jnp.float32))
    clip = clip_from_params(params, ARCHS["test-tiny"], device="cpu")
    amax = pq.calibrate_visual_amax(clip, [torch.from_numpy(c) for c in cal])
    assert amax.shape == (2, 4) and amax.dtype == torch.float32
    np.testing.assert_allclose(amax.numpy(), ref, rtol=1e-5)
    with torch.no_grad():
        feats, _ = encode_image(clip, torch.from_numpy(cal[0]), collect_gemm_amax=True)
    np.testing.assert_array_equal(feats.numpy(), _port_feats(clip, cal[0]))
    with pytest.raises(ValueError, match="no calibration batches"):
        pq.calibrate_visual_amax(clip, [])


def test_static_tower_matches_jax():
    """Static scales from JAX's calibration: each record's xs byte-equal to
    JAX's; features by the RATIO rule and at cosine > 0.985 to fp
    (test_quant.py's static rule)."""
    params = _params("test-tiny")
    cfg = JAX_ARCHS["test-tiny"]
    rng = np.random.RandomState(11)
    cal = [jnp.asarray(rng.randn(4, 32, 32, 3).astype(np.float32) * 0.5) for _ in range(3)]
    amax = jq.calibrate_visual_amax(jax.tree.map(jnp.asarray, params), cfg, cal,
                                    compute_dtype=jnp.float32)
    jqp = jq.quantize_clip_params(params, towers=("visual",), static_amax={"visual": amax})
    imgs = rng.randn(8, 32, 32, 3).astype(np.float32) * 0.5
    jax_fp, jax_q = _jax_feats(params, cfg, imgs), _jax_feats(jqp, cfg, imgs)

    clip = clip_from_params(params, ARCHS["test-tiny"], device="cpu")
    q = pq.quantize_clip(clip, static_amax={"visual": torch.from_numpy(np.array(amax))})
    for i, b in enumerate(q.visual.blocks):
        for group, name in pq._TOWER_GEMMS:
            np.testing.assert_array_equal(getattr(getattr(b, group), name).xs.numpy(),
                                          np.asarray(jqp["visual"]["blocks"][group][name]["xs"][i]))
    port_q = _port_feats(q, imgs)
    _check_close_to_jax_int8(port_q, jax_q, jax_fp)
    assert _cos_min(port_q, jax_fp) > 0.985


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_converter_carries_jax_int8_records(static):
    """A JAX-quantized pytree loaded by ``load_jax_params`` gives the same
    buffers, byte for byte, as the port's quantization of the same numpy
    weights, and the same features."""
    params = _params("test-tiny")
    amax = np.abs(np.random.RandomState(3).randn(2, 4)).astype(np.float32) + 0.5
    jqp = jq.quantize_clip_params(params, towers=("visual",),
                                  static_amax={"visual": jnp.asarray(amax)} if static else None)
    loaded = clip_from_params(jax.tree.map(np.asarray, jqp), ARCHS["test-tiny"], device="cpu")
    own = pq.quantize_clip(clip_from_params(params, ARCHS["test-tiny"], device="cpu"),
                           static_amax={"visual": torch.from_numpy(amax)} if static else None)
    a, b = dict(loaded.named_buffers()), dict(own.named_buffers())
    assert sorted(a) == sorted(b) and len(a) == 2 * 4 * (3 if static else 2)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].stride() == b[k].stride(), k
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    imgs = _images(2)
    np.testing.assert_array_equal(_port_feats(loaded, imgs), _port_feats(own, imgs))


def test_collect_activations_matches_jax():
    """``transformer(..., collect_activations=True)``: every layer's output
    against JAX's (rtol 1e-5, atol 1e-5), the final output unchanged."""
    from fsvlm_tpu.models.clip.transformer import transformer as jax_transformer

    params = _params("test-tiny")
    clip = clip_from_params(params, ARCHS["test-tiny"], device="cpu")
    W, H = clip.cfg.vision_width, clip.cfg.vision_heads
    x = np.random.RandomState(5).randn(2, 5, W).astype(np.float32)
    ref_out, ref_layers = jax_transformer(jax.tree.map(jnp.asarray, params["visual"]["blocks"]),
                                          jnp.asarray(x), n_heads=H, collect_activations=True)
    with torch.no_grad():
        out, layers = transformer(clip.visual.blocks, torch.from_numpy(x),
                                  collect_activations=True)
        plain = transformer(clip.visual.blocks, torch.from_numpy(x))
    assert layers.shape == (clip.cfg.vision_layers, 2, 5, W)
    np.testing.assert_allclose(layers.numpy(), np.asarray(ref_layers), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- engine
_TRAINERS = {  # name: (JAX module, class, config key, port module)
    "CoOp": ("coop", "CoOp", "COOP", "coop"),
    "PromptSRC": ("promptsrc", "PromptSRC", "PROMPTSRC", "promptsrc"),
    "ZeroshotCLIP": ("zsclip", "ZeroshotCLIP", None, "zsclip"),
}


def _engine_cfgs(key, **kw):
    base = dict(SEED=2, INPUT__SIZE=(32, 32), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD), DATALOADER__TEST__BATCH_SIZE=4,
                DATASET__NAME="Synthetic", MODEL__QUANT_INT8=True)
    if key == "COOP":
        base.update(TRAINER__COOP__N_CTX=4, TRAINER__COOP__CTX_INIT="", TRAINER__COOP__PREC="fp32")
    elif key == "PROMPTSRC":
        base.update({f"TRAINER__PROMPTSRC__{k}": v for k, v in dict(
            N_CTX_TEXT=2, N_CTX_VISION=2, PROMPT_DEPTH_TEXT=2, PROMPT_DEPTH_VISION=2,
            PREC="fp32").items()})
    base.update(kw)
    return _both_cfgs(**base)


def _jax_trainer(module_name, cls_name, jcfg, params, loader):
    import importlib

    from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig

    mod = importlib.import_module(f"fsvlm_tpu.trainers.{module_name}")
    t = getattr(mod, cls_name).__new__(getattr(mod, cls_name))
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=CLASSNAMES))
    t.test_loader, t.train_loader_x = loader, None
    t.parse_batch_test = lambda batch: batch
    # PromptSRC builds its towers in IVLP's build_model
    owner = mod if hasattr(mod, "load_clip_backbone") else importlib.import_module(
        "fsvlm_tpu.trainers.ivlp")
    saved = owner.load_clip_backbone
    owner.load_clip_backbone = lambda cfg: (params, JaxCLIPConfig(*TINY))
    try:
        t.build_model()
    finally:
        owner.load_clip_backbone = saved
    return t


def _jax_logits(t, frozen, imgs):
    if getattr(t, "image_logits_fn", None) is not None:
        txf = t.text_features_fn(t.params, t.frozen)
        return np.asarray(t.image_logits_fn(t.params, frozen, jnp.asarray(imgs), txf))
    return np.asarray(t.logits_fn(t.params, frozen, jnp.asarray(imgs)))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("name", list(_TRAINERS))
def test_engine_int8_test_matches_jax(name, static, capsys):
    """MODEL.QUANT_INT8 test() on 12 uint8 images in batches of 4: the
    port's logits against the JAX trainer's ``_get_frozen_eval`` logits on
    the same normalized images, by the RATIO rule against JAX's fp32
    logits; under QUANT_INT8_STATIC both calibrate over the test loader's
    first 2 batches (the port normalizes its uint8 views as test() does),
    and the scales agree within 1e-5.  The eval tower is built once, the
    training tower stays float, and JAX's log line is printed."""
    jmod, jcls, key, pmod = _TRAINERS[name]
    jcfg, pcfg = _engine_cfgs(key, MODEL__QUANT_INT8_STATIC=static,
                              MODEL__QUANT_INT8_CALIB_BATCHES=2)
    params = random_clip_params(CLIPConfig(*TINY), seed=3)
    rng = np.random.RandomState(6)
    images = rng.randint(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), 12)
    norm = ((images / np.float32(255) - np.float32(preprocess.CLIP_PIXEL_MEAN))
            / np.float32(preprocess.CLIP_PIXEL_STD)).astype(np.float32)
    jt = _jax_trainer(jmod, jcls, jcfg, params,
                      [{"img": norm[i:i + 4]} for i in range(0, 12, 4)])
    jax_q = _jax_logits(jt, jt._get_frozen_eval(), norm)
    jax_fp = _jax_logits(jt, jt.frozen, norm)

    import importlib

    cls = getattr(importlib.import_module(f"fsvlm_tpu_torch.trainers.{pmod}"), jcls)
    pt = cls(pcfg, CLASSNAMES, clip=clip_from_params(params, CLIPConfig(*TINY), device="cpu"),
             device="cpu", steps_per_epoch=1)
    pt.test_loader = [{"img": images[i:i + 4]} for i in range(0, 12, 4)]
    seen = []
    if getattr(pt, "image_logits_fn", None) is not None:
        inner = pt.image_logits_fn
        pt.image_logits_fn = lambda *a: seen.append(inner(*a)) or seen[-1]
    else:
        inner = pt.logits_fn
        pt.logits_fn = lambda *a: seen.append(inner(*a)) or seen[-1]
    acc = pt.test(images, labels)
    port_q = torch.cat(seen).numpy()
    _check_close_to_jax_int8(port_q, jax_q, jax_fp)
    assert 0 <= acc <= 100
    fe = pt.frozen_eval()
    assert fe is pt.frozen_eval() and fe["clip"] is not pt.frozen["clip"]
    rec = fe["clip"].visual.blocks[0].attn.w_qkv
    assert pq.is_quantized(rec) and (rec.xs is not None) == static
    assert not pq.is_quantized(pt.frozen["clip"].visual.blocks[0].attn.w_qkv)
    if static:
        ref = jt._get_frozen_eval()["clip"]["visual"]["blocks"]["attn"]["w_qkv"]["xs"]
        np.testing.assert_allclose(
            [b.attn.w_qkv.xs.item() for b in fe["clip"].visual.blocks], np.asarray(ref),
            rtol=1e-5)
    out = capsys.readouterr().out
    assert (f"[eval] int8 image tower (MODEL.QUANT_INT8, families=attn,mlp, "
            f"act={'static' if static else 'dynamic'})") in out
    np.testing.assert_allclose(pt.model_inference(torch.from_numpy(norm)).numpy(), port_q,
                               rtol=1e-6, atol=1e-6)


def test_engine_int8_families_config():
    """MODEL.QUANT_INT8_FAMILIES ["mlp"] through merge_from_list reaches the
    eval tower: only the MLP GEMMs quantize."""
    _, pcfg = _engine_cfgs("COOP")
    pcfg.merge_from_list(["MODEL.QUANT_INT8_FAMILIES", "['mlp']"])
    assert pcfg.MODEL.QUANT_INT8_FAMILIES == ["mlp"]
    from fsvlm_tpu_torch.trainers.coop import CoOp

    params = random_clip_params(CLIPConfig(*TINY), seed=3)
    t = CoOp(pcfg, CLASSNAMES, clip=clip_from_params(params, CLIPConfig(*TINY), device="cpu"),
             device="cpu", steps_per_epoch=1)
    blocks = t.frozen_eval()["clip"].visual.blocks
    assert all(pq.is_quantized(b.mlp.w_fc) and not pq.is_quantized(b.attn.w_qkv) for b in blocks)


def test_static_scales_need_a_loader_and_int8_off_is_the_float_tower():
    """A trainer fed tensors has no loader to calibrate on: under
    QUANT_INT8_STATIC its first test() raises, saying so; with QUANT_INT8
    off the eval state is ``frozen`` itself; on a ModifiedResNet tower
    QUANT_INT8 changes nothing."""
    from fsvlm_tpu_torch.trainers.zsclip import ZeroshotCLIP

    params = random_clip_params(CLIPConfig(*TINY), seed=3)
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    _, pcfg = _engine_cfgs(None, MODEL__QUANT_INT8_STATIC=True)
    t = ZeroshotCLIP(pcfg, CLASSNAMES, clip=clip, device="cpu", steps_per_epoch=1)
    with pytest.raises(ValueError, match="fed tensors"):
        t.test(np.zeros((2, 32, 32, 3), np.uint8), np.zeros(2))
    _, pcfg = _engine_cfgs(None, MODEL__QUANT_INT8=False)
    t = ZeroshotCLIP(pcfg, CLASSNAMES, clip=clip, device="cpu", steps_per_epoch=1)
    assert t.frozen_eval() is t.frozen
    _, pcfg = _engine_cfgs(None, INPUT__SIZE=(64, 64))
    rn = clip_from_params(_params("test-tiny-rn"), ARCHS["test-tiny-rn"], device="cpu")
    t = ZeroshotCLIP(pcfg, CLASSNAMES, clip=rn, device="cpu", steps_per_epoch=1)
    assert t.frozen_eval() is t.frozen


def test_zsclip_serving_int8_top1_agreement():
    """ZeroshotCLIP's logits on 16 images, int8 against fp: top-1 agrees on
    at least 14 (test_quant.py's rule)."""
    from fsvlm_tpu_torch.models.clip import encode_text_ids, l2_normalize
    from fsvlm_tpu_torch.models.clip.tokenizer import tokenize

    clip = clip_from_params(_params("test-tiny"), ARCHS["test-tiny"], device="cpu")
    ids = torch.from_numpy(tokenize([f"a photo of a thing {i}." for i in range(7)])).long()
    imgs = torch.from_numpy(_images(16, seed=6))
    with torch.no_grad():
        txf = l2_normalize(encode_text_ids(clip, ids))
        l_fp = l2_normalize(encode_image(clip, imgs)) @ txf.T
        l_q = l2_normalize(encode_image(pq.quantize_clip(clip), imgs)) @ txf.T
    assert (l_fp.argmax(-1) == l_q.argmax(-1)).float().mean().item() >= 14 / 16
