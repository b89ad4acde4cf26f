"""The port's CLIP-LoRA slice against the JAX package, on the CPU.

- ``mha`` with q/k/v/o deltas and JAX's dropout draws handed in, also under
  FSVLM_ATTN_BLHD=1, against fsvlm_tpu.ops.attention.mha;
- ``transformer`` with stacked factors, a 0/1 layer mask and per-layer
  dropout, rematerialized, against JAX's scan;
- remat and no remat give the same gradients under the same draws;
- the LoRA loss, its aux and the factors' gradients against
  jax.value_and_grad of JAX's loss_fn, with a random nonzero B (at LoRA's
  own init B = 0 and A's gradient is exactly 0), the SCL weights at
  defaults.py's 25/10/1, ENCODER text/vision/both, PARAMS with and without
  o, and a POSITION that selects no layer of the tiny towers;
- the real init (B = 0) gives zero-shot CLIP's logits;
- the LoRA checkpoint written by either package and read by the other, and
  a metadata mismatch raising ValueError;
- a 3-step LoRA trajectory against JAX's, with JAX's crop, flip and dropout
  draws handed in (torch cannot draw JAX's threefry bits).

fp32 throughout, on the tiny CLIP of tests/test_torch_train.py (d = 64 in
both towers); each test states its tolerance.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.engine import optim as jax_optim
from fsvlm_tpu.models.clip.transformer import transformer as jax_transformer
from fsvlm_tpu.ops import attention as jax_attention
from fsvlm_tpu_torch.config import get_cfg_default
from fsvlm_tpu_torch.models.clip import CLIPConfig, random_clip_params
from fsvlm_tpu_torch.models.clip.transformer import transformer
from fsvlm_tpu_torch.ops import attention, preprocess
from fsvlm_tpu_torch.trainers.backbone import clip_from_params
from fsvlm_tpu_torch.trainers.lora import LoRA, DropoutDraws

TINY = (64, 32, 2, 128, 16, 77, 49408, 128, 2, 2)  # d = 64 in both towers
CLASSNAMES = ["cat", "golden_retriever", "aircraft carrier", "sea", "Ferrari 250 GTO"]
PROJ_INDEX = {"q": 0, "k": 1, "v": 2, "o": 3}  # JAX's fold_in index (attention.py:56)
RATE = 0.25


# the gradient tests whose limits sit at the fp32 noise floor keep torch's
# default thread pool, with which those limits were measured: one thread sums
# in another order (one entry of 512 past its limit, 1.7e-7 against 1.3e-7)
DEFAULT_THREADS = ("test_lora_loss_and_grads_match_jax",)


@pytest.fixture(autouse=True)
def _one_thread(request):
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    if request.node.originalname in DEFAULT_THREADS:
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _set(cfg, **kw):
    for path, value in kw.items():
        *parents, leaf = path.split("__")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    return cfg


def _cfgs(**kw):
    base = dict(SEED=2, OPTIM__NAME="sgd", OPTIM__LR=0.5, OPTIM__MAX_EPOCH=2,
                OPTIM__LR_SCHEDULER="cosine", OPTIM__WARMUP_EPOCH=1,
                OPTIM__WARMUP_TYPE="constant", OPTIM__WARMUP_CONS_LR=0.2,
                INPUT__SIZE=(32, 32), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD),
                DATALOADER__TRAIN_X__BATCH_SIZE=4, DATASET__NAME="Synthetic",
                MODEL__BACKBONE__NAME="test-tiny", TRAINER__LORA__PREC="fp32",
                TRAINER__LORA__DROPOUT_RATE=RATE)
    base.update(kw)
    return _set(jax_get_cfg_default(), **base), _set(get_cfg_default(), **base)


@pytest.fixture(scope="module")
def tiny_params():
    return random_clip_params(CLIPConfig(*TINY), seed=3)


def _jax_lora(jcfg, params):
    """The JAX LoRA's state and loss_fn, built without its DataManager."""
    import fsvlm_tpu.trainers.lora as jax_lora
    from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig

    t = jax_lora.LoRA.__new__(jax_lora.LoRA)
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=CLASSNAMES))
    t.mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    saved = jax_lora.load_clip_backbone
    jax_lora.load_clip_backbone = lambda cfg: (params, JaxCLIPConfig(*TINY))
    try:
        t.build_model()
    finally:
        jax_lora.load_clip_backbone = saved
    return t


def _port_lora(pcfg, params, **kw):
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    return LoRA(pcfg, CLASSNAMES, clip=clip, device="cpu", **kw)


def _randomize(jt, pt, seed):
    """The same random A and nonzero B in both trainers (JAX's tree, the
    port's flat tensors, in place)."""
    rng = np.random.RandomState(seed)
    tree = {}
    for tower, projs in jt.params.items():
        tree[tower] = {}
        for name, (a, b) in projs.items():
            a = (0.2 * rng.randn(*a.shape)).astype(np.float32)
            b = (0.2 * rng.randn(*b.shape)).astype(np.float32)
            tree[tower][name] = (jnp.asarray(a), jnp.asarray(b))
            with torch.no_grad():
                pt.params[f"{tower}.{name}.0"].copy_(torch.from_numpy(a))
                pt.params[f"{tower}.{name}.1"].copy_(torch.from_numpy(b))
    jt.params = tree


def _jax_masks(key, shapes, names, n_layers):
    """{(tower, layer): {name: bool mask}} as JAX's LoRA draws them from a
    step key (lora.py:128-138, transformer.py:124-135, attention.py:50-60)."""
    masks = {}
    for ti, tower in enumerate(("text", "vision")):
        keys = jax.random.split(jax.random.fold_in(key, ti), n_layers)
        for i in range(n_layers):
            masks[tower, i] = {n: torch.from_numpy(np.array(jax.random.bernoulli(
                jax.random.fold_in(keys[i], PROJ_INDEX[n]), 1.0 - RATE, shapes[tower])))
                for n in names}
    return masks


def _tower_shapes(pt, batch_size):
    c = pt.clip.cfg
    vision_L = (c.image_resolution // c.vision_patch_size) ** 2 + 1
    return {"text": (len(CLASSNAMES), pt.frozen["fixed_prompts"].shape[1], c.transformer_width),
            "vision": (batch_size, vision_L, c.vision_width)}


def _mha_weights(rng, D):
    return [(rng.randn(D, 3 * D) * D ** -0.5).astype(np.float32),
            (0.1 * rng.randn(3 * D)).astype(np.float32),
            (rng.randn(D, D) * D ** -0.5).astype(np.float32),
            (0.1 * rng.randn(D)).astype(np.float32)]


# ------------------------------------------------------------------- mha
@pytest.mark.parametrize("blhd", [False, True], ids=["bhld", "blhd"])
@pytest.mark.parametrize("names", ["qkv", "qkvo"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_mha_with_lora_deltas_and_dropout_matches_jax(causal, names, blhd, monkeypatch):
    """mha with per-projection LoRA deltas (A, B, scale) and JAX's dropout
    keep masks handed in, against JAX's mha with the same key; also under
    FSVLM_ATTN_BLHD=1, where JAX takes its head-minor XLA attention and the
    port keeps its route (same math).  Output and the gradients of x and of
    every A and B at rtol 1e-4 / atol 1e-5 (of the largest entry, for the
    gradients)."""
    if blhd:
        monkeypatch.setenv("FSVLM_ATTN_BLHD", "1")
    else:
        monkeypatch.delenv("FSVLM_ATTN_BLHD", raising=False)
    rng = np.random.RandomState(4)
    B, L, D, H, r = 3, 13, 128, 2, 3
    x = rng.randn(B, L, D).astype(np.float32)
    w = _mha_weights(rng, D)
    factors = {n: ((0.3 * rng.randn(D, r)).astype(np.float32),
                   (0.3 * rng.randn(r, D)).astype(np.float32)) for n in names}
    scale = float(np.float32(0.7))
    g = rng.randn(B, L, D).astype(np.float32)
    key = jax.random.PRNGKey(11)
    mask = jax_attention.causal_mask(L) if causal else None

    def jax_out(x_, fac):
        delta = {n: (a, b, jnp.float32(scale)) for n, (a, b) in fac.items()}
        delta["dropout"] = (key, RATE)
        out = jax_attention.mha(x_, *w, H, mask=mask, lora_delta=delta)
        return jnp.sum(out * g), out

    jfac = {n: tuple(jnp.asarray(t) for t in ab) for n, ab in factors.items()}
    (_, ref), (gx_ref, gf_ref) = jax.value_and_grad(jax_out, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jfac)
    keep = {n: torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(key, PROJ_INDEX[n]), 1.0 - RATE, (B, L, D)))) for n in names}

    t = torch.from_numpy
    tx = t(x).requires_grad_()
    tfac = {n: tuple(t(a).requires_grad_() for a in ab) for n, ab in factors.items()}
    delta = {n: (a, b, scale) for n, (a, b) in tfac.items()}
    delta.update(keep=keep, rate=RATE)
    out = attention.mha(tx, *(t(a) for a in w), H, lora_delta=delta,
                        mask=attention.causal_mask(L, device="cpu") if causal else None)
    loss = (out * t(g)).sum()
    grads = torch.autograd.grad(loss, [tx] + [p for ab in tfac.values() for p in ab])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    wants = [gx_ref] + [p for n in names for p in gf_ref[n]]
    for got, want in zip(grads, wants):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------- transformer
@pytest.mark.parametrize("tower", ["vision", "text"])
def test_transformer_with_stacked_factors_and_position_mask_matches_jax(tiny_params, tower):
    """The stacked transformer with q/v/o factors on both layers, layer 0
    masked off (scale * 0), per-layer dropout from JAX's keys, rematerialized,
    against JAX's scan: output at rtol 1e-5 / atol 1e-5; the gradients of x
    and of every A and B at rtol 1e-4 / atol 1e-5 of the largest entry, and
    layer 0's factors get a gradient of exactly 0 in both."""
    rng = np.random.RandomState(5)
    jblocks = jax.tree.map(jnp.asarray, tiny_params["visual" if tower == "vision" else "text"]
                           ["blocks"])
    clip = clip_from_params(tiny_params, CLIPConfig(*TINY), device="cpu")
    blocks = clip.visual.blocks if tower == "vision" else clip.text.blocks
    B, L, W, r, n_layers, H = 3, 9, 128, 2, 2, 2
    x = rng.randn(B, L, W).astype(np.float32)
    g = rng.randn(B, L, W).astype(np.float32)
    names = ("q", "v", "o")
    factors = {n: ((0.3 * rng.randn(n_layers, W, r)).astype(np.float32),
                   (0.3 * rng.randn(n_layers, r, W)).astype(np.float32)) for n in names}
    layer_mask, scale = [0.0, 1.0], float(np.float32(1 / np.sqrt(r)))
    keys = jax.random.split(jax.random.PRNGKey(9), n_layers)
    causal = tower == "text"

    def jax_loss(x_, fac):
        lora = {"proj": fac, "scale": scale, "mask": jnp.asarray(layer_mask, jnp.float32),
                "dropout_keys": keys, "dropout_rate": RATE}
        out = jax_transformer(jblocks, x_, n_heads=H, lora=lora, remat=True,
                              mask=jax_attention.causal_mask(L) if causal else None)
        return jnp.sum(out * g)

    jfac = {n: tuple(jnp.asarray(t) for t in ab) for n, ab in factors.items()}
    ref, (gx_ref, gf_ref) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jfac)
    masks = {(tower, i): {n: torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(keys[i], PROJ_INDEX[n]), 1.0 - RATE, (B, L, W)))) for n in names}
        for i in range(n_layers)}

    t = torch.from_numpy
    tx = t(x).requires_grad_()
    tfac = {n: tuple(t(a).requires_grad_() for a in ab) for n, ab in factors.items()}
    lora = {"proj": tfac, "scale": scale, "mask": layer_mask,
            "dropout": (DropoutDraws(RATE, names, masks=masks).tower(tower), RATE)}
    out = transformer(blocks, tx, lora=lora, remat=True,
                      mask=attention.causal_mask(L, device="cpu") if causal else None)
    loss = (out * t(g)).sum()
    grads = torch.autograd.grad(loss, [tx] + [p for ab in tfac.values() for p in ab])
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-5)
    wants = [gx_ref] + [p for n in names for p in gf_ref[n]]
    for got, want in zip(grads, wants):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    for got in grads[1:]:
        assert got[0].abs().max().item() == 0.0 and got[1].abs().max().item() > 0


def test_remat_gives_the_gradients_of_no_remat_under_the_same_draws(tiny_params):
    """The same generator seed, with and without remat: the masks are drawn
    before each layer, outside its checkpoint, so the recomputation in the
    backward draws nothing and sees the forward's masks.  Loss and every
    gradient equal exactly, and both generators end in the same state."""
    clip = clip_from_params(tiny_params, CLIPConfig(*TINY), device="cpu")
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 7, 128).astype(np.float32))
    fac = {n: (torch.from_numpy((0.3 * rng.randn(2, 128, 2)).astype(np.float32)),
               torch.from_numpy((0.3 * rng.randn(2, 2, 128)).astype(np.float32)))
           for n in ("q", "k", "v", "o")}
    runs = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(0)
        leaves = [p.clone().requires_grad_() for ab in fac.values() for p in ab]
        proj = {n: (leaves[2 * i], leaves[2 * i + 1]) for i, n in enumerate(fac)}
        draws = DropoutDraws(RATE, proj, generator=gen)
        lora = {"proj": proj, "scale": 0.7, "mask": [1.0, 1.0],
                "dropout": (draws.tower("vision"), RATE)}
        loss = transformer(clip.visual.blocks, x, lora=lora, remat=remat).square().sum()
        runs.append((loss, torch.autograd.grad(loss, leaves), gen.get_state(), draws.masks))
    (l0, g0, s0, m0), (l1, g1, s1, m1) = runs
    assert l0.item() == l1.item() and torch.equal(s0, s1)
    assert all(torch.equal(m0[k][n], m1[k][n]) for k in m0 for n in m0[k])
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------- the trainer
@pytest.mark.parametrize("encoder,params,position", [
    ("both", ["q", "k", "v"], "all"), ("both", ["q", "k", "v", "o"], "all"),
    ("text", ["q", "k", "v"], "all"), ("vision", ["q", "v", "o"], "all"),
    ("both", ["q", "k", "v"], "mid"),
], ids=["both-qkv", "both-qkvo", "text-qkv", "vision-qvo", "both-mid"])
def test_lora_loss_and_grads_match_jax(tiny_params, encoder, params, position):
    """One batch (one padded row), dropout at 0.25 with JAX's draws handed
    in, the SCL weights at defaults.py's 25/10/1, a random nonzero B in both
    trainers: loss and aux at rtol 1e-4 / atol 1e-5; the gradient of every
    A and B at rtol 1e-3 / atol 1e-6 of the largest entry.  "mid" selects
    no layer of the 2-layer towers: every gradient is exactly 0 in both."""
    jcfg, pcfg = _cfgs(TRAINER__LORA__ENCODER=encoder, TRAINER__LORA__PARAMS=params,
                       TRAINER__LORA__POSITION=position)
    jt = _jax_lora(jcfg, tiny_params)
    pt = _port_lora(pcfg, tiny_params, steps_per_epoch=2)
    assert pt.node.TEXT_LOSS_WEIGHT == 25.0 and pt.node.LOGITS_LOSS_WEIGHT == 1.0
    for tower, projs in jt.params.items():  # the init, drawn in JAX's order
        for name, (a, b) in projs.items():
            np.testing.assert_array_equal(pt.params[f"{tower}.{name}.0"].detach().numpy(),
                                          np.asarray(a))
            assert not np.asarray(b).any() and not pt.params[f"{tower}.{name}.1"].detach().any()
    assert sorted(pt.params) == sorted(f"{t}.{n}.{i}" for t in jt.params for n in params
                                       for i in (0, 1))
    np.testing.assert_allclose(pt.frozen["zs_text"].numpy(), np.asarray(jt.frozen["zs_text"]),
                               rtol=1e-5, atol=1e-6)
    _randomize(jt, pt, seed=7)

    rng = np.random.RandomState(1)
    batch = {"img": rng.randn(4, 32, 32, 3).astype(np.float32), "label": np.array([0, 3, 1, 4]),
             "valid": np.array([True, True, True, False])}
    key = jax.random.PRNGKey(5)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        jt.params, jt.frozen, batch, key)

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["drop"] = DropoutDraws(RATE, params, masks=_jax_masks(
        key, _tower_shapes(pt, 4), params, 2))
    p_loss, p_aux = pt.loss_fn(pt.params, pt.frozen, tbatch)
    p_grads = dict(zip(pt.params, torch.autograd.grad(p_loss, list(pt.params.values()))))
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=1e-4, atol=1e-5)
    for k, v in aux.items():
        np.testing.assert_allclose(p_aux[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    for tower, projs in grads.items():
        for name, ab in projs.items():
            for i, ref in enumerate(ab):
                ref, got = np.asarray(ref), p_grads[f"{tower}.{name}.{i}"].numpy()
                np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6 * np.abs(ref).max(),
                                           err_msg=f"{tower}.{name}.{i}")
                assert (np.abs(ref).max() > 0) == (position == "all"), (tower, name, i)


def test_real_init_gives_zero_shot_logits(tiny_params):
    """At LoRA's own init (B = 0) the adapted towers are the frozen ones: the
    split eval's logits equal the towers' without LoRA exactly, and JAX's
    LoRA logits at rtol 1e-5 / atol 1e-5 (the JAX package's own test,
    tests/test_lora_simclr.py:66)."""
    from fsvlm_tpu_torch.models.clip import encode_image_vit, encode_text_embeds, l2_normalize

    jcfg, pcfg = _cfgs()
    jt = _jax_lora(jcfg, tiny_params)
    pt = _port_lora(pcfg, tiny_params, steps_per_epoch=1)
    images = np.random.RandomState(3).randn(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = pt.logits_fn(pt.params, pt.frozen, torch.from_numpy(images))
        f = pt.frozen
        txf = l2_normalize(encode_text_embeds(f["clip"], f["fixed_prompts"], f["eot_idx"]))
        imf = l2_normalize(encode_image_vit(f["clip"], torch.from_numpy(images)))
        zs = torch.exp(f["clip"].logit_scale).float() * imf @ txf.T
    torch.testing.assert_close(got, zs, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.logits_fn(jt.params, jt.frozen, images)),
                               rtol=1e-5, atol=1e-5)


def test_lora_checkpoint_both_ways_and_metadata_mismatch(tiny_params, tmp_path, capsys):
    """The port writes lora/best.pkl (and last.pkl under best-val tracking),
    which the JAX trainer loads, and loads what the JAX trainer writes, to
    the same factors exactly; a config whose R differs raises ValueError."""
    jcfg, pcfg = _cfgs(OUTPUT_DIR=str(tmp_path), TEST__FINAL_MODEL="best_val")
    jt = _jax_lora(jcfg, tiny_params)
    pt = _port_lora(pcfg, tiny_params, steps_per_epoch=1)
    _randomize(jt, pt, seed=8)
    pt.save_model(0, str(tmp_path / "port"), val_result=12.5, model_name="model-best.pkl")
    lora_dir = tmp_path / "port" / "Synthetic" / "test-tiny" / "lora"
    assert sorted(os.listdir(lora_dir)) == ["best.pkl"]
    pt.save_model(1, str(tmp_path / "port"))
    assert sorted(os.listdir(lora_dir)) == ["best.pkl", "last.pkl"]
    jt2 = _jax_lora(jcfg, tiny_params)
    jt2.load_model(str(tmp_path / "port"))
    for tower, projs in jt.params.items():
        for name, ab in projs.items():
            for x, y in zip(ab, jt2.params[tower][name]):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))

    jt.save_model(2, str(tmp_path / "jax"))
    pt2 = _port_lora(pcfg, tiny_params, steps_per_epoch=1)
    pt2.load_model(str(tmp_path / "jax"))
    for k, p in pt.params.items():
        torch.testing.assert_close(pt2.params[k], p, rtol=0, atol=0)
    assert pt2.optim.params[0] is pt2.params["text.q.0"]  # loaded in place
    assert pt2.resume_model_if_exist(str(tmp_path / "jax")) == 0

    _, bad = _cfgs(OUTPUT_DIR=str(tmp_path), TRAINER__LORA__R=4)
    with pytest.raises(ValueError, match="metadata mismatch for 'r'"):
        _port_lora(bad, tiny_params, steps_per_epoch=1).load_model(str(tmp_path / "jax"))


def test_lora_trajectory_matches_jax(tiny_params):
    """3 resident steps on a uint8 cache under DEVICE_AUG (warmup LR, then
    the cosine's first), each step's boxes, flips and dropout masks taken
    from JAX's draws: loss per step within 1e-4 * (1 + |loss|); every A and
    B at rtol 1e-3 / atol 1e-6 after each step (B moves off 0 at step 1, A at
    step 2)."""
    import optax

    from fsvlm_tpu.ops import preprocess as jax_preprocess

    jcfg, pcfg = _cfgs(DATALOADER__DEVICE_AUG=True)
    rng = np.random.RandomState(5)
    cache = rng.randint(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), 8)
    jt = _jax_lora(jcfg, tiny_params)
    pt = _port_lora(pcfg, tiny_params, images=cache, labels=labels)
    assert pt.steps_per_epoch == 2
    tx, _ = jax_optim.build_optimizer(jcfg, steps_per_epoch=2)
    mean, std = jnp.asarray(jcfg.INPUT.PIXEL_MEAN), jnp.asarray(jcfg.INPUT.PIXEL_STD)
    scale = tuple(jcfg.INPUT.RRCROP_SCALE)

    @jax.jit
    def jax_step(params, opt_state, frozen, imgs_u8, labels_, key):
        k_aug, k_rest = jax.random.split(key)
        imgs = jax_preprocess.random_resized_crop_flip_normalize(
            imgs_u8, k_aug, out_size=32, scale=scale, mean=mean, std=std)
        (loss, _), grads = jax.value_and_grad(jt.loss_fn, has_aux=True)(
            params, frozen, {"img": imgs, "label": labels_}, k_rest)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def jax_draws(key):  # the boxes and flips random_resized_crop_flip_normalize draws
        keys = jax.random.split(jax.random.split(key)[0], 5)
        flips = jax.random.bernoulli(keys[0], 0.5, (4,))
        boxes = jax.vmap(lambda k: jnp.stack(jax_preprocess._sample_crop_box(k, 40, 40, scale)))(
            keys[1:])
        return boxes, flips

    params, opt_state = jt.params, tx.init(jt.params)
    shapes, names = _tower_shapes(pt, 4), list(pt.proj_names)
    order = np.random.RandomState(6).permutation(8)
    for step in range(3):
        index = order[(step % 2) * 4:(step % 2) * 4 + 4]
        key = jax.random.PRNGKey(100 + step)
        params, opt_state, loss = jax_step(params, opt_state, jt.frozen, cache[index],
                                           labels[index], key)
        boxes, flips = (torch.from_numpy(np.array(a)) for a in jax_draws(key))
        drop = DropoutDraws(RATE, names, masks=_jax_masks(jax.random.split(key)[1], shapes,
                                                          names, 2))
        metrics = pt.train_step_resident(torch.from_numpy(index), aug=(boxes, flips), drop=drop)
        assert abs(metrics["loss"].item() - float(loss)) <= 1e-4 * (1 + abs(float(loss))), step
        for tower, projs in params.items():
            for name, ab in projs.items():
                for i, v in enumerate(ab):
                    np.testing.assert_allclose(pt.params[f"{tower}.{name}.{i}"].detach().numpy(),
                                               np.asarray(v), rtol=1e-3, atol=1e-6,
                                               err_msg=f"{tower}.{name}.{i} at step {step}")
        b_moved = any(np.asarray(ab[1]).any() for projs in params.values() for ab in projs.values())
        assert b_moved
    assert int(pt.optim.count) == 3


def test_lora_trains_on_its_own_draws_and_evaluates_deterministically(tiny_params):
    """train(): each step draws its dropout masks from the trainer's
    generator (the same seed gives the same run); test() draws none, so
    two evaluations agree exactly."""
    runs = []
    rng = np.random.RandomState(5)
    cache = rng.randint(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), 8)
    for _ in range(2):
        _, pcfg = _cfgs(DATALOADER__DEVICE_AUG=True)
        pt = _port_lora(pcfg, tiny_params, images=cache, labels=labels)
        history = pt.train()
        runs.append([m["loss"] for h in history for m in h])
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))
    a = pt.test(cache[:, 4:36, 4:36], labels, return_pred=True)
    b = pt.test(cache[:, 4:36, 4:36], labels, return_pred=True)
    assert a == b


def test_l1_loss_gradient_at_a_zero_difference_is_jax_s():
    """JAX's abs has gradient +1 at 0 (torch's abs: 0); the port's l1_loss
    follows JAX, since LoRA's first step meets exact zeros (rtol 0)."""
    from fsvlm_tpu.trainers import losses as jax_losses
    from fsvlm_tpu_torch.trainers import losses

    a = np.array([[0.5, -1.0, 2.0], [1.0, 0.0, -3.0]], np.float32)
    b = np.array([[0.5, 0.0, 2.5], [1.0, 0.0, -1.0]], np.float32)
    for valid in (None, np.array([True, False])):
        ref = jax.grad(lambda x: jax_losses.l1_loss(x, b, valid=valid))(jnp.asarray(a))
        x = torch.from_numpy(a).requires_grad_()
        (got,) = torch.autograd.grad(losses.l1_loss(
            x, torch.from_numpy(b), valid=None if valid is None else torch.from_numpy(valid)), x)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
