"""The port's ModifiedResNet towers against the JAX package, on the CPU.

- ``random_clip_params`` for test-tiny-rn and RN50: JAX's arrays, array for
  array, from the same seed;
- the state-dict converter: the port's pytree equals JAX's converter's on
  the same OpenAI-layout state dict (and the pytree that state dict was
  exported from), an unmapped key raises, and the loaded module's OIHW
  conv kernels are the state dict's tensors;
- the frozen golden pack: ``rn_tower.npz`` (stem, the four stages and the
  attention pool of a tiny reference ModifiedResNet) and
  ``rn50_full_shape.npz`` (RN50 at 224^2, weights and images from seeds),
  replayed at the JAX package's tolerances (tests/test_golden_pack.py,
  tests/test_golden_pack_full_shape.py);
- the tower and encode_image against JAX's on test-tiny-rn with every BN
  perturbed (the reference init zeroes each bn3 scale, which silences the
  residual branches), in fp32 and with bf16 frozen weights;
- CoOp's loss and ctx gradient, ZeroshotCLIP's and LinearProbeCLIP's
  logits, loss and gradients on test-tiny-rn against JAX; the trainers
  that JAX cannot run on an RN tower raise in both packages.

fp32 unless stated; each test states its tolerance.
"""

import dataclasses
import importlib
import os
import types

import jax
import numpy as np
import pytest
import torch

import golden_pack_common as C
from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.models.clip import ARCHS as JAX_ARCHS
from fsvlm_tpu.models.clip import convert as jax_convert
from fsvlm_tpu.models.clip.resnet import encode_image_resnet as jax_encode_image_resnet
from fsvlm_tpu_torch.config import get_cfg_default
from fsvlm_tpu_torch.engine.checkpoint import flatten
from fsvlm_tpu_torch.engine.trainer import TRAINER_REGISTRY
from fsvlm_tpu_torch.models.clip import (
    ARCHS,
    ModifiedResNet,
    clip_params_from_state_dict,
    encode_image,
    load_jax_params,
    random_clip_params,
)
from fsvlm_tpu_torch.ops import flash_attention, preprocess
from fsvlm_tpu_torch.trainers.backbone import clip_from_params

PACK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_pack")
CLASSNAMES = ["cat", "golden_retriever", "aircraft carrier", "sea", "Ferrari 250 GTO"]
TINY_RN = "test-tiny-rn"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, prefix=""):
    """(path, array) of every leaf of a pytree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k, v in la.items():
        assert v.dtype == lb[k].dtype and v.shape == lb[k].shape, k
        np.testing.assert_array_equal(v, lb[k], err_msg=k)


def _perturb_bn(params, seed):
    """Every BN of the RN tower random, as golden_pack_common's RN50."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict) and set(node) == {"scale", "bias", "mean", "var"}:
            c = node["scale"].shape[0]
            node["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            node["bias"] = rng.normal(0, 0.05, c).astype(np.float32)
            node["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            node["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params["visual"])
    return params


@pytest.fixture(scope="module")
def tiny_rn():
    return _perturb_bn(random_clip_params(ARCHS[TINY_RN], seed=3), 4)


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("name", [TINY_RN, "RN50"])
def test_random_clip_params_match_jax(name):
    _assert_trees_equal(random_clip_params(ARCHS[name], seed=5),
                        jax_convert.random_clip_params(JAX_ARCHS[name], seed=5))


def test_state_dict_converter_matches_jax_both_ways(tiny_rn):
    sd = jax_convert.export_openai_state_dict(tiny_rn, JAX_ARCHS[TINY_RN])
    got, cfg = clip_params_from_state_dict(sd)
    ref, ref_cfg = jax_convert.clip_params_from_state_dict(sd)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(ref_cfg) and not cfg.is_vit
    _assert_trees_equal(got, ref)
    _assert_trees_equal(got, tiny_rn)
    clip = clip_from_params(got, ARCHS[TINY_RN], device="cpu")
    block = clip.visual.layers[1][0]
    for key, param in (("visual.conv1.weight", clip.visual.stem.conv1),
                       ("visual.layer2.0.conv2.weight", block.conv2),
                       ("visual.layer2.0.downsample.0.weight", block.downsample.conv),
                       ("visual.layer2.0.bn3.running_var", block.bn3.var)):
        assert torch.equal(param, torch.from_numpy(np.asarray(sd[key]))), key
    assert clip.visual.layers[1][0].conv2.shape == (32, 32, 3, 3)  # OIHW
    with pytest.raises(ValueError, match="Unmapped"):
        clip_params_from_state_dict({**sd, "visual.layer9.0.conv1.weight": sd["visual.conv1.weight"]})
    sd.pop("visual.layer1.0.bn2.running_mean")
    with pytest.raises(KeyError):
        clip_params_from_state_dict(sd)


# ------------------------------------------------------------------ goldens
def _load(name):
    return dict(np.load(os.path.join(PACK_DIR, name), allow_pickle=False))


def _pack_tree(z, prefix):
    """The pytree of 'prefix.a/b/0/c' keys; all-digit levels become lists."""
    tree = {}
    for key, value in z.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def test_pack_rn_tower_stages():
    """The tiny reference ModifiedResNet's stem, stage outputs and pooled
    features (clip/model.py:93-150, attnpool :56-92), at
    tests/test_golden_pack.py's tolerances: the stem rtol 2e-4 / atol
    2e-5, the stages and features rtol 5e-4 / atol 5e-5."""
    z = _load("rn_tower.npz")
    vis = _pack_tree(z, "vis.")
    width = vis["stem"]["conv3"].shape[-1]
    layers = [len(stage) for stage in vis["layers"]]
    resolution = z["images"].shape[1]
    out_dim = vis["attnpool"]["c_proj"]["w"].shape[1]
    tower = ModifiedResNet(layers, width, int(z["n_heads"]), resolution, out_dim, device="cpu")
    load_jax_params(tower, vis)
    x = torch.from_numpy(z["images"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        x = tower.stem(x)
        np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), z["act.avgpool"], rtol=2e-4,
                                   atol=2e-5, err_msg="stem")
        for li, stage in enumerate(tower.layers):
            for block in stage:
                x = block(x)
            np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), z[f"act.layer{li + 1}"],
                                       rtol=5e-4, atol=5e-5, err_msg=f"stage {li + 1}")
        feats = tower.attnpool(x)
    np.testing.assert_allclose(feats.numpy(), z["image_features"], rtol=5e-4, atol=5e-5)


def test_rn50_full_shape_stages_and_pool():
    """RN50 at 224^2 (seed-50 weights, BN perturbed with seed 51, 2 images
    from seed 13): the four stages at their sub-sampled positions and
    moments (rtol 2e-3 of the tensor's scale), the features at 5e-3 of
    their largest entry: tests/test_golden_pack_full_shape.py's replay."""
    pack = _load("rn50_full_shape.npz")
    params, cfg = C.full_shape_rn50_params()
    clip = clip_from_params(jax.tree.map(np.asarray, params), ARCHS["RN50"], device="cpu")
    images = torch.from_numpy(C.golden_images(2, C.IMAGES_SEED_RN))
    with torch.no_grad():
        feat, stages = encode_image(clip, images, collect_stages=True)
    assert stages[3].shape == (2, 7, 7, 2048)
    for i, stage in enumerate(stages, start=1):
        C.check_subsampled(pack, f"stage{i}", stage.numpy(), rtol=2e-3)
    ref = pack["image_features"]
    np.testing.assert_allclose(feat.numpy(), ref, rtol=0, atol=5e-3 * np.abs(ref).max())


# -------------------------------------------------------------------- tower
@pytest.mark.parametrize("frozen", ["fp32", "bf16"])
def test_tower_matches_jax(tiny_rn, frozen):
    """encode_image on test-tiny-rn (BN perturbed) against JAX's
    encode_image_resnet, stages included, at rtol 1e-4 / atol 1e-5 of the
    largest entry; with bf16 frozen weights (MODEL.FROZEN_DTYPE, the JAX
    package's cast) computed in fp32 on the CPU as JAX does.  The ViT-only
    keywords are dropped, as JAX drops them."""
    params = tiny_rn
    dtype = torch.float32
    if frozen == "bf16":
        from fsvlm_tpu.trainers.backbone import _apply_frozen_dtype

        cfg = types.SimpleNamespace(MODEL=types.SimpleNamespace(FROZEN_DTYPE="bf16"))
        params = jax.tree.map(np.asarray, _apply_frozen_dtype(cfg, tiny_rn))
        dtype = torch.bfloat16
    clip = clip_from_params(params, ARCHS[TINY_RN], dtype, device="cpu")
    images = np.random.RandomState(0).randn(3, 64, 64, 3).astype(np.float32)
    ref, ref_stages = jax_encode_image_resnet(params, JAX_ARCHS[TINY_RN], images,
                                              collect_stages=True)
    with torch.no_grad():
        got, stages = encode_image(clip, torch.from_numpy(images), collect_stages=True)
        dropped = encode_image(clip, torch.from_numpy(images), prompts=object(), lora=object(),
                               remat=True, attn_impl="plain")
    assert got.dtype == torch.float32 and torch.equal(dropped, got)
    for a, b in zip([got] + stages, [ref] + list(ref_stages)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max())


# ----------------------------------------------------------------- trainers
def _cfgs(**kw):
    base = dict(SEED=2, OPTIM__NAME="sgd", OPTIM__LR=0.05, OPTIM__MAX_EPOCH=2,
                INPUT__SIZE=(64, 64), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD),
                DATALOADER__TRAIN_X__BATCH_SIZE=4, DATASET__NAME="Synthetic",
                MODEL__BACKBONE__NAME=TINY_RN, TRAINER__COOP__PREC="fp32",
                TRAINER__COOP__N_CTX=4)
    base.update(kw)
    out = []
    for cfg in (jax_get_cfg_default(), get_cfg_default()):
        for path, value in base.items():
            *parents, leaf = path.split("__")
            node = cfg
            for p in parents:
                node = getattr(node, p)
            setattr(node, leaf, value)
        out.append(cfg)
    return out


def _jax_trainer(module, name, jcfg, params):
    """A JAX trainer's state and functions on test-tiny-rn, built without
    its DataManager (the backbone loader patched where the trainer's
    module family imports it)."""
    mod = importlib.import_module(f"fsvlm_tpu.trainers.{module}")
    t = getattr(mod, name).__new__(getattr(mod, name))
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=CLASSNAMES),
                                 num_classes=len(CLASSNAMES))
    loaders = [importlib.import_module(c.__module__) for c in type(t).__mro__]
    loaders = [m for m in loaders if hasattr(m, "load_clip_backbone")]
    saved = [m.load_clip_backbone for m in loaders]
    for m in loaders:
        m.load_clip_backbone = lambda cfg: (params, JAX_ARCHS[TINY_RN])
    try:
        t.build_model()
    finally:
        for m, fn in zip(loaders, saved):
            m.load_clip_backbone = fn
    return t


def _port_trainer(name, pcfg, params):
    clip = clip_from_params(params, ARCHS[TINY_RN], device="cpu")
    return TRAINER_REGISTRY.get(name)(pcfg, CLASSNAMES, clip=clip, device="cpu",
                                      steps_per_epoch=2)


def _batch():
    rng = np.random.RandomState(1)
    return {"img": rng.randn(4, 64, 64, 3).astype(np.float32), "label": np.array([0, 3, 1, 4]),
            "valid": np.array([True, True, True, False])}


@pytest.mark.parametrize("module,name", [("coop", "CoOp"), ("zsclip", "ZeroshotCLIP"),
                                         ("linear_probe", "LinearProbeCLIP"),
                                         ("cocoop", "CoCoOp"), ("plip", "PLIP")])
def test_trainers_on_rn_match_jax(tiny_rn, module, name):
    """One batch (one padded row) on test-tiny-rn: loss and aux at rtol
    1e-4 / atol 1e-5; each gradient at rtol 1e-3 / atol 1e-6 of its
    largest entry, which must not be 0; the eval logits at rtol 1e-4 /
    atol 1e-5.  The text tower's d = 32 attention takes the blockwise
    family's plain version; nothing launches on the CPU."""
    import fsvlm_tpu_torch.trainers  # noqa: F401  (registers the trainers)

    jcfg, pcfg = _cfgs(TRAINER__COCOOP__PREC="fp32", TRAINER__PLIP__PREC="fp32")
    jt, pt = _jax_trainer(module, name, jcfg, tiny_rn), _port_trainer(name, pcfg, tiny_rn)
    batch = _batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = dict(flash_attention.LAUNCHES)
    if jt.params:
        (loss, aux), grads = jax.value_and_grad(jt.loss_fn, has_aux=True)(
            jt.params, jt.frozen, batch, jax.random.PRNGKey(0))
        p_loss, p_aux = pt.loss_fn(pt.params, pt.frozen, tbatch)
        p_grads = dict(zip(pt.params, torch.autograd.grad(p_loss, list(pt.params.values()))))
        ref = flatten(jax.tree.map(np.asarray, grads))
        assert sorted(ref) == sorted(p_grads)
        for k, g in ref.items():
            assert np.abs(g).max() > 0, k
            np.testing.assert_allclose(p_grads[k].numpy(), g, rtol=1e-3,
                                       atol=1e-6 * np.abs(g).max(), err_msg=k)
    else:
        loss, aux = jt.loss_fn(jt.params, jt.frozen, batch, jax.random.PRNGKey(0))
        with torch.no_grad():
            p_loss, p_aux = pt.loss_fn(pt.params, pt.frozen, tbatch)
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=1e-4, atol=1e-5)
    for k, v in aux.items():
        np.testing.assert_allclose(p_aux[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    with torch.no_grad():
        logits = pt.logits_fn(pt.params, pt.frozen, tbatch["img"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jt.logits_fn(jt.params, jt.frozen,
                                                                        batch["img"])),
                               rtol=1e-4, atol=1e-5)
    assert flash_attention.LAUNCHES == before


@pytest.mark.parametrize("module,name", [("ivlp", "IVLP"), ("promptsrc", "PromptSRC"),
                                         ("maple", "MaPLe"), ("lora", "LoRA")])
def test_vit_only_trainers_raise_on_rn_in_both_packages(tiny_rn, module, name):
    """The vision-prompt and LoRA trainers address the ViT's layers: on an
    RN tower JAX raises building them or in their first loss, and so does
    the port, with the same error type."""
    import fsvlm_tpu_torch.trainers  # noqa: F401

    jcfg, pcfg = _cfgs()
    batch = _batch()
    with pytest.raises((TypeError, NotImplementedError)) as ref:
        jt = _jax_trainer(module, name, jcfg, tiny_rn)
        jt.loss_fn(jt.params, jt.frozen, batch, jax.random.PRNGKey(0))
    with pytest.raises(ref.type):
        _port_trainer(name, pcfg, tiny_rn).train_step(batch)
