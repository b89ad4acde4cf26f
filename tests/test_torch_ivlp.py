"""The port's IVLP slice against the JAX package, on the CPU.

- the four losses the IVLP loss adds (mixup_batch, mixup_criterion, kd_loss,
  kl_logits) against fsvlm_tpu.trainers.losses;
- the TRAINER.IVLP config node against the JAX defaults overlaid with the
  _kd recipe's yaml;
- IVLP's loss, its aux and the prompt gradients on one batch against
  jax.value_and_grad of the JAX loss_fn (KD; KD + mixup, JAX's perm and lam
  from ``mixup_batch(rng_key, ...)`` injected; focal + SimCLR), on JAX's
  default attention and under FSVLM_FORCE_PALLAS=1, where both packages run
  the blockwise kernels #3-#5 (JAX's in interpret mode, the port's plain
  versions);
- a 4-step JAX-against-port IVLP trajectory with KD and mixup on a uint8
  cache, JAX's boxes, flips, perm and lam handed to the port;
- the trainer's own mixup draws, and INT8_TEACHER building the int8 KD teacher.

fp32 throughout (the tiny CLIP of test_torch_train.py: head dim 64 in both
towers); each test states its tolerance.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import CLASSNAMES, TINY, _both_cfgs, _loss_inputs

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.engine import optim as jax_optim
from fsvlm_tpu.ops import preprocess as jax_preprocess
from fsvlm_tpu.trainers import losses as jax_losses
from fsvlm_tpu_torch.config import get_cfg_default
from fsvlm_tpu_torch.models.clip import CLIPConfig, random_clip_params
from fsvlm_tpu_torch.ops import flash_attention, preprocess, quant
from fsvlm_tpu_torch.trainers import losses
from fsvlm_tpu_torch.trainers.backbone import clip_from_params
from fsvlm_tpu_torch.trainers.ivlp import IVLP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the gradient tests whose limits sit at the fp32 noise floor keep torch's
# default thread pool, with which those limits were measured: one thread sums
# in another order (one entry of 512 past its limit, 1.4e-6 against 1.2e-6)
DEFAULT_THREADS = ("test_ivlp_loss_and_prompt_grads_match_jax",)


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


# ------------------------------------------------------------------- losses
def _mixup_draws(key, n):
    """JAX's mixup draws for a batch of n: (perm, lam)."""
    _, perm, lam = jax_losses.mixup_batch(key, jnp.zeros((n, 1)), 1.0)
    return np.array(perm), np.float32(lam)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("name", ["kd_loss", "kd_loss_T1", "kl_logits", "kl_logits_T2",
                                  "mixup_criterion"])
def test_ivlp_losses_match_jax(name, masked):
    logits, labels, valid, z1, z2 = _loss_inputs()
    teacher = (2 * np.random.RandomState(9).randn(*logits.shape)).astype(np.float32)
    labels_b = labels[::-1].copy()
    v = valid if masked else None
    cases = {
        "kd_loss": lambda m, a, t, la, lb, vv: m.kd_loss(a, t, valid=vv),
        "kd_loss_T1": lambda m, a, t, la, lb, vv: m.kd_loss(a, t, T=1.0, valid=vv),
        "kl_logits": lambda m, a, t, la, lb, vv: m.kl_logits(a, t, valid=vv),
        "kl_logits_T2": lambda m, a, t, la, lb, vv: m.kl_logits(a, t, T=2.0, valid=vv),
        "mixup_criterion": lambda m, a, t, la, lb, vv: m.mixup_criterion(
            lambda lg, y: m.cross_entropy(lg, y, valid=vv), a, la, lb, 0.3),
    }
    ref = cases[name](jax_losses, jnp.asarray(logits), jnp.asarray(teacher), jnp.asarray(labels),
                      jnp.asarray(labels_b), None if v is None else jnp.asarray(v))
    t = torch.from_numpy
    got = cases[name](losses, t(logits), t(teacher), t(labels).long(), t(labels_b).long(),
                      None if v is None else t(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-6)


def test_mixup_batch_matches_jax_on_its_draws():
    images = np.random.RandomState(0).randn(6, 4, 4, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref, perm, lam = jax_losses.mixup_batch(key, jnp.asarray(images), 1.0)
    mixed, p, lm = losses.mixup_batch(torch.from_numpy(images), torch.from_numpy(np.array(perm)),
                                      torch.tensor(float(lam)))
    assert sorted(np.asarray(perm).tolist()) == list(range(6)) and 0 < float(lam) < 1
    np.testing.assert_allclose(mixed.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert p.tolist() == np.asarray(perm).tolist() and float(lm) == float(lam)


def test_ivlp_config_is_the_kd_recipe():
    """TRAINER.IVLP and DATASET.NAME equal the JAX defaults overlaid with
    configs/trainers/IVLP/vit_b16_c2_ep20_batch4_4+4ctx_kd.yaml; so do the
    sections the port shares with the PromptSRC recipe."""
    jcfg = jax_get_cfg_default()
    jcfg.merge_from_file(os.path.join(REPO, "configs/trainers/IVLP/"
                                            "vit_b16_c2_ep20_batch4_4+4ctx_kd.yaml"))
    cfg = get_cfg_default()
    for key, value in vars(cfg.TRAINER.IVLP).items():
        assert value == jcfg.TRAINER.IVLP[key], key
    assert set(vars(cfg.TRAINER.IVLP)) == set(jcfg.TRAINER.IVLP)
    assert cfg.DATASET.NAME == jcfg.DATASET.NAME == ""
    for key in ("NAME", "LR", "MAX_EPOCH", "LR_SCHEDULER", "WARMUP_EPOCH", "WARMUP_TYPE",
                "WARMUP_CONS_LR"):
        assert getattr(cfg.OPTIM, key) == jcfg.OPTIM[key], key
    assert cfg.DATALOADER.TRAIN_X.BATCH_SIZE == jcfg.DATALOADER.TRAIN_X.BATCH_SIZE
    assert cfg.MODEL.BACKBONE.NAME == jcfg.MODEL.BACKBONE.NAME


# --------------------------------------------------------------------- IVLP
NODE = dict(N_CTX_TEXT=4, N_CTX_VISION=4, PROMPT_DEPTH_TEXT=2, PROMPT_DEPTH_VISION=2,
            CTX_INIT="a photo of a", PREC="fp32", USE_MIXUP=False, USE_KD=True, KD_ALPHA=0.5,
            KD_T=4.0)


def _ivlp_cfgs(**kw):
    base = dict(SEED=2, OPTIM__NAME="sgd", OPTIM__LR=0.05, OPTIM__MAX_EPOCH=2,
                OPTIM__LR_SCHEDULER="cosine", OPTIM__WARMUP_EPOCH=1,
                OPTIM__WARMUP_TYPE="constant", OPTIM__WARMUP_CONS_LR=1e-3,
                INPUT__SIZE=(32, 32), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD), DATALOADER__TRAIN_X__BATCH_SIZE=4,
                DATASET__NAME="OxfordPets")
    base.update({f"TRAINER__IVLP__{k}": v for k, v in NODE.items()})
    return _both_cfgs(**dict(base, **kw))


@pytest.fixture(scope="module")
def tiny_params():
    return random_clip_params(CLIPConfig(*TINY), seed=3)


def _jax_ivlp(jcfg, params, classnames):
    """The JAX IVLP's model state and loss_fn, built without its DataManager."""
    import fsvlm_tpu.trainers.ivlp as jax_ivlp
    from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig

    t = jax_ivlp.IVLP.__new__(jax_ivlp.IVLP)
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=classnames))
    saved = jax_ivlp.load_clip_backbone
    jax_ivlp.load_clip_backbone = lambda cfg: (params, JaxCLIPConfig(*TINY))
    try:
        t.build_model()
    finally:
        jax_ivlp.load_clip_backbone = saved
    return t


def _port_ivlp(pcfg, params, classnames, **kw):
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    return IVLP(pcfg, classnames, clip=clip, device="cpu", **kw)


_CASES = {
    "kd": {},
    "kd_mixup": dict(TRAINER__IVLP__USE_MIXUP=True),
    "focal_simclr": dict(TRAINER__IVLP__USE_FOCAL_LOSS=True, TRAINER__IVLP__SIMCLR_ALPHA=0.5,
                         DATASET__PER_CLASS_SHOTS=[1, 4, 0, 2, 8]),
}


@pytest.mark.parametrize("attn", ["default", "force_pallas"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_ivlp_loss_and_prompt_grads_match_jax(tiny_params, case, attn, monkeypatch):
    """One batch (one padded row): loss and aux at rtol 1e-4 / atol 1e-5,
    gradients of every prompt tensor at rtol 1e-3 / atol 1e-6 of the largest
    gradient entry (test_torch_train.py's tolerances).  ``force_pallas``:
    FSVLM_FORCE_PALLAS=1 in both packages, so every attention is the
    blockwise family (JAX's Pallas kernels in interpret mode, the port's
    plain versions).

    That atol is at the fp32 noise floor of a mixed gradient, whose smallest
    entries come from the two CE terms partly cancelling: measured over the
    JAX keys 0-5, the worst entry sits at 0.4-1.4 of the tolerance on
    either route, the port's d = 64 default included, and JAX's own two
    routes differ by up to 5e-6 of the largest entry.  The key is 1 (lam
    0.096), where it sits at 0.6."""
    if attn == "force_pallas":
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", "1")
    jcfg, pcfg = _ivlp_cfgs(**_CASES[case])
    jt = _jax_ivlp(jcfg, tiny_params, CLASSNAMES)
    pt = _port_ivlp(pcfg, tiny_params, CLASSNAMES, steps_per_epoch=2)
    assert sorted(pt.params) == sorted(jt.params) == ["ctx", "text_deep", "vision_deep",
                                                      "vpt_shallow"]
    for k, v in jt.params.items():
        np.testing.assert_array_equal(pt.params[k].detach().numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_allclose(pt.frozen["teacher_text"].numpy(),
                               np.asarray(jt.frozen["teacher_text"]), rtol=1e-5, atol=1e-6)

    rng = np.random.RandomState(1)
    images = rng.randn(4, 32, 32, 3).astype(np.float32)
    batch = {"img": images, "label": np.array([0, 3, 1, 4]),
             "valid": np.array([True, True, True, False])}
    if case == "focal_simclr":
        batch["img2"] = rng.randn(4, 32, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        jt.params, jt.frozen, batch, key)

    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if case == "kd_mixup":
        perm, lam = _mixup_draws(key, 4)
        batch["perm"], batch["lam"] = torch.from_numpy(perm.copy()).long(), torch.tensor(lam)
    before = dict(flash_attention.LAUNCHES)
    p_loss, p_aux = pt.loss_fn(pt.params, pt.frozen, batch)
    p_grads = torch.autograd.grad(p_loss, list(pt.params.values()))
    assert flash_attention.LAUNCHES == before  # the CPU launches nothing
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=1e-4, atol=1e-5)
    assert sorted(p_aux) == sorted(aux) == ["acc"]
    for k, v in aux.items():
        np.testing.assert_allclose(p_aux[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    for (k, g), pg in zip(pt.params.items(), p_grads):
        ref = np.asarray(grads[k])
        np.testing.assert_allclose(pg.numpy(), ref, rtol=1e-3, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=k)
        assert np.abs(ref).max() > 0, k


def test_ivlp_trajectory_with_kd_and_mixup_matches_jax(tiny_params):
    """2 epochs of 2 resident steps on a uint8 cache under DEVICE_AUG, KD and
    mixup on; the port's boxes, flips, perm and lam taken from JAX's draws
    for each step.  Loss per step within 1e-4 * (1 + |loss|); every prompt
    tensor at rtol 1e-3 / atol 1e-6."""
    from fsvlm_tpu.ops.preprocess import random_resized_crop_flip_normalize

    jcfg, pcfg = _ivlp_cfgs(DATALOADER__DEVICE_AUG=True, TRAINER__IVLP__USE_MIXUP=True)
    rng = np.random.RandomState(5)
    cache = rng.randint(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), 8)
    jt = _jax_ivlp(jcfg, tiny_params, CLASSNAMES)
    pt = _port_ivlp(pcfg, tiny_params, CLASSNAMES, images=cache, labels=labels)
    assert pt.steps_per_epoch == 2 and pt.use_mixup and pt.use_kd
    tx, _ = jax_optim.build_optimizer(jcfg, steps_per_epoch=2)
    mean, std = jnp.asarray(jcfg.INPUT.PIXEL_MEAN), jnp.asarray(jcfg.INPUT.PIXEL_STD)
    scale = tuple(jcfg.INPUT.RRCROP_SCALE)

    @jax.jit
    def jax_step(params, opt_state, frozen, imgs_u8, labels_, key):
        k_aug, k_rest = jax.random.split(key)
        imgs = random_resized_crop_flip_normalize(imgs_u8, k_aug, out_size=32, scale=scale,
                                                  mean=mean, std=std)
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
    order = np.random.RandomState(6).permutation(8)
    for step in range(4):
        index = order[(step % 2) * 4:(step % 2) * 4 + 4]
        key = jax.random.PRNGKey(100 + step)
        params, opt_state, loss = jax_step(params, opt_state, jt.frozen, cache[index],
                                           labels[index], key)
        boxes, flips = (torch.from_numpy(np.array(a)) for a in jax_draws(key))
        perm, lam = _mixup_draws(jax.random.split(key)[1], 4)
        metrics = pt.train_step_resident(torch.from_numpy(index), aug=(boxes, flips),
                                         mix=(torch.from_numpy(perm), lam))
        assert abs(metrics["loss"].item() - float(loss)) <= 1e-4 * (1 + abs(float(loss))), step
        for k, v in params.items():
            np.testing.assert_allclose(pt.params[k].detach().numpy(), np.asarray(v), rtol=1e-3,
                                       atol=1e-6, err_msg=f"{k} at step {step}")
    assert int(pt.optim.count) == 4


def test_ivlp_trainer_draws_its_own_mixup():
    """train() with USE_MIXUP: each step's perm from the generator and the
    epoch's lams from the numpy generator seeded by SEED (Beta(1, 1) draws,
    one per step, drawn per epoch); the same seed gives the same run."""
    params = random_clip_params(CLIPConfig(*TINY), seed=3)
    runs = []
    for _ in range(2):
        _, pcfg = _ivlp_cfgs(DATALOADER__DEVICE_AUG=True, TRAINER__IVLP__USE_MIXUP=True)
        rng = np.random.RandomState(5)
        pt = _port_ivlp(pcfg, params, CLASSNAMES, images=rng.randint(0, 256, (8, 40, 40, 3),
                                                                     dtype=np.uint8),
                        labels=rng.randint(0, 5, 8))
        history = pt.train()
        assert [len(h) for h in history] == [2, 2] and int(pt.optim.count) == 4
        assert all(np.isfinite(m["loss"]) for h in history for m in h)
        want = np.random.default_rng(2).beta(1.0, 1.0, 4).astype(np.float32)
        np.testing.assert_array_equal(pt.epoch_lams.numpy(), want[2:])  # the last epoch's
        perm, lam = pt.mixup_draws(4)
        assert sorted(perm.tolist()) == [0, 1, 2, 3] and lam.dim() == 0
        runs.append(([m["loss"] for h in history for m in h],
                     {k: v.detach().clone() for k, v in pt.params.items()}))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        torch.testing.assert_close(runs[0][1][k], runs[1][1][k], rtol=0, atol=0)


def test_ivlp_without_kd_and_the_int8_teacher(tiny_params):
    """USE_KD off: no teacher text features and no teacher pass; the loss is
    the CE alone.  INT8_TEACHER under KD builds the int8 KD teacher tower
    (tests/test_torch_int8_teacher.py holds it against JAX's); without KD
    it builds none, as in JAX."""
    _, pcfg = _ivlp_cfgs(TRAINER__IVLP__USE_KD=False)
    pt = _port_ivlp(pcfg, tiny_params, CLASSNAMES, steps_per_epoch=1)
    assert "teacher_text" not in pt.frozen and not pt.use_kd
    loss, _ = pt.loss_fn(pt.params, pt.frozen, {"img": torch.zeros(2, 32, 32, 3),
                                                "label": torch.tensor([0, 1])})
    assert torch.isfinite(loss)
    _, pcfg = _ivlp_cfgs(TRAINER__IVLP__INT8_TEACHER=True)
    pt = _port_ivlp(pcfg, tiny_params, CLASSNAMES, steps_per_epoch=1)
    assert pt.int8_teacher and isinstance(pt.frozen["clip_teacher"].visual.blocks[0].mlp.w_fc,
                                          quant.Int8Weight)
    _, pcfg = _ivlp_cfgs(TRAINER__IVLP__INT8_TEACHER=True, TRAINER__IVLP__USE_KD=False)
    pt = _port_ivlp(pcfg, tiny_params, CLASSNAMES, steps_per_epoch=1)
    assert not pt.int8_teacher and "clip_teacher" not in pt.frozen
