"""The port's MaPLe, zero-shot CLIP and linear-probe trainers against the
JAX package, on the CPU.

- MaPLe's init (drawn in JAX's order), loss, aux and the gradient of every
  prompt tensor at PROMPT_DEPTH 1 and 2, with CE and with focal (alpha from
  PER_CLASS_SHOTS), and its split eval;
- ZeroshotCLIP and ZeroshotCLIP2 (the template ensemble): class text
  features and logits; a train step with nothing to train;
- LinearProbeCLIP's init, loss, aux, gradients and softmax output, with and
  without the bias, CE and focal;
- the five new trainers through ``build_trainer``.

fp32 throughout, on the tiny CLIP of tests/test_torch_train.py (d = 64 in
both towers); each test states its tolerance.
"""

import types

import jax
import numpy as np
import pytest
import torch

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu_torch.config import get_cfg_default
from fsvlm_tpu_torch.engine.checkpoint import flatten
from fsvlm_tpu_torch.models.clip import CLIPConfig, random_clip_params
from fsvlm_tpu_torch.ops import preprocess
from fsvlm_tpu_torch.trainers.backbone import clip_from_params
from fsvlm_tpu_torch.trainers.linear_probe import LinearProbeCLIP
from fsvlm_tpu_torch.trainers.maple import MaPLe
from fsvlm_tpu_torch.trainers.zsclip import ZeroshotCLIP, ZeroshotCLIP2

TINY = (64, 32, 2, 128, 16, 77, 49408, 128, 2, 2)  # d = 64 in both towers
CLASSNAMES = ["cat", "golden_retriever", "aircraft carrier", "sea", "Ferrari 250 GTO"]
SHOTS = [1, 4, 0, 2, 8]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
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
    base = dict(SEED=2, OPTIM__NAME="sgd", OPTIM__LR=0.05, OPTIM__MAX_EPOCH=2,
                INPUT__SIZE=(32, 32), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD),
                DATALOADER__TRAIN_X__BATCH_SIZE=4, DATASET__NAME="Synthetic",
                TRAINER__MAPLE__PREC="fp32")
    base.update(kw)
    return _set(jax_get_cfg_default(), **base), _set(get_cfg_default(), **base)


@pytest.fixture(scope="module")
def tiny_params():
    return random_clip_params(CLIPConfig(*TINY), seed=3)


def _jax_trainer(module, name, jcfg, params):
    """A JAX trainer's state and functions, built without its DataManager."""
    import importlib

    from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig

    mod = importlib.import_module(f"fsvlm_tpu.trainers.{module}")
    t = getattr(mod, name).__new__(getattr(mod, name))
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=CLASSNAMES),
                                 num_classes=len(CLASSNAMES))
    saved = mod.load_clip_backbone
    mod.load_clip_backbone = lambda cfg: (params, JaxCLIPConfig(*TINY))
    try:
        t.build_model()
    finally:
        mod.load_clip_backbone = saved
    return t


def _port(cls, pcfg, params, **kw):
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    return cls(pcfg, CLASSNAMES, clip=clip, device="cpu", steps_per_epoch=2, **kw)


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(4, 32, 32, 3).astype(np.float32), "label": np.array([0, 3, 1, 4]),
            "valid": np.array([True, True, True, False])}


def _check_loss_and_grads(jt, pt, batch, flat_ref):
    """Loss and aux at rtol 1e-4 / atol 1e-5; each gradient at rtol 1e-3 /
    atol 1e-6 of its largest entry, which must not be 0."""
    (loss, aux), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        jt.params, jt.frozen, batch, jax.random.PRNGKey(0))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p_loss, p_aux = pt.loss_fn(pt.params, pt.frozen, tbatch)
    p_grads = dict(zip(pt.params, torch.autograd.grad(p_loss, list(pt.params.values()))))
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=1e-4, atol=1e-5)
    for k, v in aux.items():
        np.testing.assert_allclose(p_aux[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    ref = flat_ref(grads)
    assert sorted(ref) == sorted(p_grads)
    for k, g in ref.items():
        g = np.asarray(g)
        np.testing.assert_allclose(p_grads[k].numpy(), g, rtol=1e-3, atol=1e-6 * np.abs(g).max(),
                                   err_msg=k)
        assert np.abs(g).max() > 0, k


# -------------------------------------------------------------------- MaPLe
@pytest.mark.parametrize("focal", [False, True], ids=["ce", "focal"])
@pytest.mark.parametrize("depth", [1, 2])
def test_maple_loss_and_grads_match_jax(tiny_params, depth, focal):
    """MaPLe at PROMPT_DEPTH 1 (ctx and proj only) and 2 (plus one compound
    text prompt and its projection to the vision prompts): the init equal
    exactly, then one batch (one padded row) through _check_loss_and_grads'
    tolerances."""
    kw = dict(TRAINER__MAPLE__PROMPT_DEPTH=depth, TRAINER__MAPLE__USE_FOCAL_LOSS=focal,
              DATASET__PER_CLASS_SHOTS=SHOTS if focal else [])
    jcfg, pcfg = _cfgs(**kw)
    jt = _jax_trainer("maple", "MaPLe", jcfg, tiny_params)
    pt = _port(MaPLe, pcfg, tiny_params)
    init = flatten(jt.params)
    assert sorted(init) == sorted(pt.params)
    for k, v in init.items():
        np.testing.assert_array_equal(pt.params[k].detach().numpy(), np.asarray(v), err_msg=k)
    _check_loss_and_grads(jt, pt, _batch(), flatten)


def test_maple_split_eval_matches_jax(tiny_params):
    """Class text features once, then image logits (rtol 1e-4 / atol 1e-4),
    with the vision prompts at L = 5 + 2 shallow tokens."""
    jcfg, pcfg = _cfgs(TRAINER__MAPLE__PROMPT_DEPTH=2)
    jt = _jax_trainer("maple", "MaPLe", jcfg, tiny_params)
    pt = _port(MaPLe, pcfg, tiny_params)
    images = np.random.RandomState(3).randn(3, 32, 32, 3).astype(np.float32)
    ref_txf = jt.text_features_fn(jt.params, jt.frozen)
    ref = jt.image_logits_fn(jt.params, jt.frozen, images, ref_txf)
    with torch.no_grad():
        txf = pt.text_features_fn(pt.params, pt.frozen)
        logits = pt.image_logits_fn(pt.params, pt.frozen, torch.from_numpy(images), txf)
        whole = pt.logits_fn(pt.params, pt.frozen, torch.from_numpy(images))
    np.testing.assert_allclose(txf.numpy(), np.asarray(ref_txf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(whole, logits, rtol=0, atol=0)


# ---------------------------------------------------------------- zero-shot
@pytest.mark.parametrize("dataset", ["Synthetic", "OxfordPets", "ImageNet"])
@pytest.mark.parametrize("name", ["ZeroshotCLIP", "ZeroshotCLIP2"])
def test_zeroshot_text_features_and_logits_match_jax(tiny_params, name, dataset):
    """The class text features (one template, or the select ensemble plus
    the dataset's template; ImageNet adds none) at rtol 1e-5 / atol 1e-6, and
    the logits of one batch at rtol 1e-4 / atol 1e-4."""
    jcfg, pcfg = _cfgs(DATASET__NAME=dataset)
    jt = _jax_trainer("zsclip", name, jcfg, tiny_params)
    pt = _port({"ZeroshotCLIP": ZeroshotCLIP, "ZeroshotCLIP2": ZeroshotCLIP2}[name], pcfg,
               tiny_params)
    assert pt.params == {} and len(pt.templates_for(pcfg)) == len(jt.templates_for(jcfg))
    np.testing.assert_allclose(pt.frozen["text_features"].numpy(),
                               np.asarray(jt.frozen["text_features"]), rtol=1e-5, atol=1e-6)
    images = _batch()["img"]
    with torch.no_grad():
        logits = pt.logits_fn(pt.params, pt.frozen, torch.from_numpy(images))
    ref = jt.logits_fn(jt.params, jt.frozen, images)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_zeroshot_steps_with_nothing_to_train(tiny_params, tmp_path):
    """train(): each step computes the loss without a gradient (no optimizer
    step, nothing saved); the loss equals JAX's loss_fn at rtol 1e-4."""
    jcfg, pcfg = _cfgs(OUTPUT_DIR=str(tmp_path))
    jt = _jax_trainer("zsclip", "ZeroshotCLIP", jcfg, tiny_params)
    rng = np.random.RandomState(5)
    cache = rng.randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), 8)
    clip = clip_from_params(tiny_params, CLIPConfig(*TINY), device="cpu")
    pt = ZeroshotCLIP(pcfg, CLASSNAMES, cache, labels, clip=clip, device="cpu")
    assert pt.optim is None and pt.steps_per_epoch == 2
    m = pt.train_step_resident(torch.arange(4))
    assert not m["loss"].requires_grad
    imgs = ((cache[:4] / 255.0 - np.asarray(preprocess.CLIP_PIXEL_MEAN))
            / np.asarray(preprocess.CLIP_PIXEL_STD)).astype(np.float32)
    ref, _ = jt.loss_fn(jt.params, jt.frozen, {"img": imgs, "label": labels[:4]}, None)
    np.testing.assert_allclose(m["loss"].item(), float(ref), rtol=1e-4)
    history = pt.train()
    assert [len(h) for h in history] == [2, 2]
    pt.save_model(0, str(tmp_path))
    assert pt.resume_model_if_exist(str(tmp_path)) == 0 and not list(tmp_path.iterdir())


# ------------------------------------------------------------- linear probe
@pytest.mark.parametrize("loss_type", ["ce", "focal"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_linear_probe_loss_grads_and_softmax_match_jax(tiny_params, bias, loss_type):
    """The head's init equal exactly, the loss, aux and gradients through
    _check_loss_and_grads' tolerances, and logits_fn's softmax
    probabilities at rtol 1e-5 / atol 1e-6 (rows summing to 1); the image
    tower takes no gradient."""
    jcfg, pcfg = _cfgs(TRAINER__LINEAR_PROBE__USE_BIAS=bias,
                       TRAINER__LINEAR_PROBE__LOSS_TYPE=loss_type,
                       DATASET__PER_CLASS_SHOTS=SHOTS if loss_type == "focal" else [])
    jt = _jax_trainer("linear_probe", "LinearProbeCLIP", jcfg, tiny_params)
    pt = _port(LinearProbeCLIP, pcfg, tiny_params)
    assert sorted(pt.params) == sorted(jt.params) == (["b", "w"] if bias else ["w"])
    for k, v in jt.params.items():
        np.testing.assert_array_equal(pt.params[k].detach().numpy(), np.asarray(v), err_msg=k)
    # a trained head, so that the bias and the logits spread
    rng = np.random.RandomState(9)
    jt.params = {k: np.asarray(rng.randn(*np.shape(v)), np.float32) for k, v in jt.params.items()}
    with torch.no_grad():
        for k, v in jt.params.items():
            pt.params[k].copy_(torch.from_numpy(v))
    batch = _batch()
    _check_loss_and_grads(jt, pt, batch, dict)
    with torch.no_grad():
        probs = pt.logits_fn(pt.params, pt.frozen, torch.from_numpy(batch["img"]))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jt.logits_fn(jt.params, jt.frozen,
                                                                      batch["img"])),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(probs.sum(-1), torch.ones(4), rtol=0, atol=1e-6)


# ------------------------------------------------------------- the registry
@pytest.mark.parametrize("name", ["LoRA", "MaPLe", "ZeroshotCLIP", "ZeroshotCLIP2",
                                  "LinearProbeCLIP"])
def test_new_trainers_build_from_the_registry(name, tiny_params):
    """build_trainer gives each of the five new trainers on the synthetic
    dataset (tiny towers, one epoch), and one step runs finite."""
    import os

    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.engine.trainer import build_trainer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = get_cfg_base()
    cfg.merge_from_file(os.path.join(root, "configs/datasets/synthetic.yaml"))
    cfg.merge_from_file(os.path.join(root, "configs/trainers/tests/synthetic_tiny.yaml"))
    cfg.merge_from_list(["TRAINER.NAME", name, "SEED", 1, "DATALOADER.DEVICE_AUG", True,
                         "OPTIM.MAX_EPOCH", 1, "TRAINER.MAPLE.PREC", "fp32",
                         "TRAINER.LORA.PREC", "fp32"])
    t = build_trainer(cfg, device="cpu")
    assert type(t).__name__ == name
    index, valid = t.epoch_schedule() if t._maybe_device_cache() is not None else (None, None)
    m = t.train_step_resident(index[0], valid[0])
    assert np.isfinite(m["loss"].item())
