"""The port's CLIP towers against the JAX package on the same numpy weights,
and the full-shape ViT-B/16 golden pack replayed through the port.

The JAX towers run their attention through the head-packed Pallas kernel in
interpret mode (FSVLM_FORCE_PALLAS=packed), the kernel the port's
flash-attention forward replaces.  fp32; rtol 1e-4 / atol 1e-4 for the tiny
towers, the golden pack's own budget at full shape.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_pack_common as C
from fsvlm_tpu.models.clip import model as jax_model
from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig
from fsvlm_tpu.models.clip.convert import random_clip_params as jax_random_clip_params
from fsvlm_tpu.trainers import ivlp_family as jax_family
from fsvlm_tpu_torch.models.clip import (
    ARCHS,
    CLIPConfig,
    VisionPrompts,
    encode_image_vit,
    encode_text_embeds,
    encode_text_ids,
    load_jax_params,
    random_clip_params,
    tokenize,
)
from fsvlm_tpu_torch.models.clip.model import CLIP, patch_embed
from fsvlm_tpu_torch.trainers import ivlp_family, prompts
from fsvlm_tpu_torch.trainers.backbone import clip_from_params

TINY = (64, 32, 2, 128, 16, 77, 49408, 128, 2, 2)  # d = 64, two heads per tower


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig(*TINY)
    params = random_clip_params(cfg, seed=5)
    return params, cfg, clip_from_params(params, cfg, device="cpu")


@pytest.fixture
def packed_pallas(monkeypatch):
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", "packed")


def test_random_params_and_carry_across_match_jax(tiny):
    params, cfg, clip = tiny
    ref = jax_random_clip_params(JaxCLIPConfig(*TINY), seed=5)
    np.testing.assert_array_equal(params["visual"]["blocks"]["mlp"]["w_proj"],
                                  ref["visual"]["blocks"]["mlp"]["w_proj"])
    np.testing.assert_array_equal(params["text"]["text_projection"],
                                  ref["text"]["text_projection"])
    # layer i of the stacked pytree lands in block i, in the (in, out) layout
    np.testing.assert_array_equal(clip.visual.blocks[1].attn.w_qkv.numpy(),
                                  params["visual"]["blocks"]["attn"]["w_qkv"][1])
    np.testing.assert_array_equal(clip.text.blocks[0].mlp.b_fc.numpy(),
                                  params["text"]["blocks"]["mlp"]["b_fc"][0])
    assert clip.logit_scale.shape == ()


def test_load_jax_params_refuses_partial_or_misshapen_trees(tiny):
    params, cfg, _ = tiny
    clip = CLIP(cfg, device="cpu")
    bad = dict(params, visual=dict(params["visual"], proj=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError):
        load_jax_params(clip, bad)
    with pytest.raises(KeyError):
        load_jax_params(clip, {k: v for k, v in params.items() if k != "logit_scale"})


def test_encode_image_vit_with_vpt_matches_jax(tiny, packed_pallas):
    params, cfg, clip = tiny
    rng = np.random.RandomState(0)
    images = rng.randn(3, 32, 32, 3).astype(np.float32)
    shallow = (0.02 * rng.randn(4, 128)).astype(np.float32)
    deep = np.concatenate([np.zeros((1, 4, 128), np.float32),
                           (0.02 * rng.randn(1, 4, 128)).astype(np.float32)])
    flags = [False, True]
    ref = jax_model.encode_image_vit(
        params, JaxCLIPConfig(*TINY), images,
        prompts=jax_model.VisionPrompts(shallow=shallow, deep=jnp.asarray(deep),
                                        flags=jnp.asarray(flags)))
    out = encode_image_vit(clip, torch.from_numpy(images), prompts=VisionPrompts(
        torch.from_numpy(shallow), torch.from_numpy(deep), flags))
    assert out.shape == (3, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_encode_text_with_deep_prompts_and_eot_truncation_matches_jax(tiny, packed_pallas):
    params, cfg, clip = tiny
    classnames = ["cat", "golden retriever", "aircraft carrier"]
    kw = dict(n_ctx=4, ctx_init="a photo of a", init_keep_n_ctx=True, truncate=True)
    pc = prompts.build_prompt_context(params["text"]["token_embedding"], classnames, **kw)
    from fsvlm_tpu.trainers.prompts import build_prompt_context as jax_build

    pc_ref = jax_build(params, classnames, **kw)
    for key in ("base_embed", "ctx_scatter", "tokenized", "eot_idx", "init_ctx"):
        np.testing.assert_array_equal(pc[key], pc_ref[key], err_msg=key)
    assert pc["base_embed"].shape[1] == 16  # truncated to a multiple of 8

    rng = np.random.RandomState(1)
    ctx = pc["init_ctx"] + (0.01 * rng.randn(4, 128)).astype(np.float32)
    deep = (0.02 * rng.randn(1, 4, 128)).astype(np.float32)
    jax_frozen = {"clip": params, "base_embed": pc["base_embed"],
                  "ctx_scatter": pc["ctx_scatter"], "eot_idx": pc["eot_idx"]}
    ref = jax_family.vlp_text_features({"ctx": ctx, "text_deep": deep}, jax_frozen,
                                       JaxCLIPConfig(*TINY), jnp.float32)
    frozen = {"clip": clip, "base_embed": torch.from_numpy(pc["base_embed"]),
              "ctx_scatter": torch.from_numpy(pc["ctx_scatter"]),
              "eot_idx": torch.from_numpy(pc["eot_idx"]).long()}
    out = ivlp_family.vlp_text_features(
        {"ctx": torch.from_numpy(ctx), "text_deep": torch.from_numpy(deep)}, frozen,
        torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)

    full_ids = tokenize(["a photo of a cat."])
    ref_ids = jax_model.encode_text_ids(params, JaxCLIPConfig(*TINY), full_ids)
    out_ids = encode_text_ids(clip, torch.from_numpy(full_ids).long())
    np.testing.assert_allclose(out_ids.numpy(), np.asarray(ref_ids), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("csc", [False, True], ids=["unified", "csc"])
@pytest.mark.parametrize("position", ["end", "middle", "front"])
def test_prompt_context_and_assembly_match_jax(tiny, position, csc):
    from fsvlm_tpu.trainers.prompts import assemble_prompts as jax_assemble
    from fsvlm_tpu.trainers.prompts import build_prompt_context as jax_build

    params, _, _ = tiny
    classnames = ["cat", "golden_retriever", "Ferrari 250 GTO"]
    kw = dict(n_ctx=3, class_token_position=position, csc=csc, truncate=True)
    pc = prompts.build_prompt_context(params["text"]["token_embedding"], classnames,
                                      rng=np.random.RandomState(4), **kw)
    pc_ref = jax_build(params, classnames, rng=np.random.RandomState(4), **kw)
    for key in ("base_embed", "ctx_scatter", "tokenized", "eot_idx", "name_lens", "init_ctx"):
        np.testing.assert_array_equal(pc[key], pc_ref[key], err_msg=key)
    ctx = pc["init_ctx"] + np.random.RandomState(5).randn(*pc["init_ctx"].shape).astype(np.float32)
    out = prompts.assemble_prompts(torch.from_numpy(ctx), torch.from_numpy(pc["base_embed"]),
                                   torch.from_numpy(pc["ctx_scatter"]))
    ref = jax_assemble(jnp.asarray(ctx), jnp.asarray(pc_ref["base_embed"]),
                       jnp.asarray(pc_ref["ctx_scatter"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_pad_deep_matches_jax():
    deep = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    full, flags = ivlp_family._pad_deep(torch.from_numpy(deep), 5)
    full_ref, flags_ref = jax_family._pad_deep(jnp.asarray(deep), 5)
    np.testing.assert_array_equal(full.numpy(), np.asarray(full_ref))
    assert flags == list(np.asarray(flags_ref))


# ------------------------------------------------------------- full shape
@pytest.fixture(scope="module")
def vit_full():
    pack = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_pack",
                        "vit_full_shape.npz")
    cfg = ARCHS["ViT-B/16"]
    clip = clip_from_params(random_clip_params(cfg, seed=C.VIT_WEIGHTS_SEED), cfg,
                            device="cpu")
    return dict(np.load(pack, allow_pickle=False)), clip


def test_vit_b16_vision_blocks_full_shape(vit_full):
    pack, clip = vit_full
    v = clip.visual
    imgs = torch.from_numpy(C.golden_images(2, C.IMAGES_SEED_VIT))
    with torch.inference_mode():
        x = patch_embed(imgs, v.patch_embed)
        x = torch.cat([v.class_embedding.expand(2, 1, 768), x], dim=1) + v.positional_embedding
        x = v.ln_pre(x)
        for layer, block in enumerate(v.blocks):
            x = block(x)
            C.check_subsampled(pack, f"vis_block_{layer}", x.numpy())
        imf = encode_image_vit(clip, imgs).numpy()
    ref = pack["image_features"]
    np.testing.assert_allclose(imf, ref, rtol=0, atol=2e-3 * np.abs(ref).max())


def test_vit_b16_text_blocks_and_logits_full_shape(vit_full):
    pack, clip = vit_full
    from fsvlm_tpu_torch.models.clip import clip_logits
    from fsvlm_tpu_torch.ops.attention import causal_mask

    ids = tokenize(C.PROMPTS)
    np.testing.assert_array_equal(ids, pack["ids"])
    t = clip.text
    ids_t = torch.from_numpy(ids).long()
    with torch.inference_mode():
        x = t.token_embedding[ids_t] + t.positional_embedding
        for layer, block in enumerate(t.blocks):
            x = block(x, mask=causal_mask(77, device="cpu"))
            C.check_subsampled(pack, f"text_block_{layer}", x.numpy())
        txf = encode_text_ids(clip, ids_t)
        imf = encode_image_vit(clip, torch.from_numpy(C.golden_images(2, C.IMAGES_SEED_VIT)))
        logits = clip_logits(imf, txf, clip.logit_scale).numpy()
    ref_tx = pack["text_features"]
    np.testing.assert_allclose(txf.numpy(), ref_tx, rtol=0, atol=2e-3 * np.abs(ref_tx).max())
    ref_logits = pack["logits_per_image"]
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=5e-3 * np.abs(ref_logits).max())
    assert (logits.argmax(1) == ref_logits.argmax(1)).all()


def test_openai_state_dict_loads_through_the_pretrained_path(tiny, tmp_path, monkeypatch):
    """export_openai_state_dict (JAX package) -> torch.save -> the port's
    find_clip_weights / load_openai_checkpoint / clip_params_from_state_dict."""
    from fsvlm_tpu.models.clip.convert import export_openai_state_dict
    from fsvlm_tpu_torch.models.clip import clip_params_from_state_dict
    from fsvlm_tpu_torch.trainers.backbone import load_clip_backbone

    params, cfg, clip = tiny
    sd = export_openai_state_dict(params, JaxCLIPConfig(*TINY))
    back, cfg_back = clip_params_from_state_dict(sd)
    assert cfg_back == cfg
    np.testing.assert_array_equal(back["visual"]["blocks"]["attn"]["w_qkv"],
                                  params["visual"]["blocks"]["attn"]["w_qkv"])
    with pytest.raises(ValueError, match="Unmapped"):
        clip_params_from_state_dict(dict(sd, stray=np.zeros(1, np.float32)))

    path = tmp_path / "weights.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    monkeypatch.setenv("FSVLM_CLIP_WEIGHTS", str(path))
    loaded = load_clip_backbone("ViT-B/16", pretrained=True, frozen="bf16",
                                device="cpu")
    assert loaded.cfg == cfg and loaded.text.token_embedding.dtype == torch.bfloat16
    ref = torch.from_numpy(params["text"]["blocks"]["mlp"]["w_fc"][1]).bfloat16()
    torch.testing.assert_close(loaded.text.blocks[1].mlp.w_fc, ref, rtol=0, atol=0)
