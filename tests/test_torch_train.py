"""The port's PromptSRC train slice against the JAX package, on the CPU.

- losses, the LR schedule and SGD + apply_if_finite against
  fsvlm_tpu.trainers.losses / fsvlm_tpu.engine.optim (JAX and optax are the
  oracle);
- the crop-resize-flip-normalize against fsvlm_tpu.ops.preprocess, with the
  boxes JAX draws handed to both (JAX's threefry bits cannot be reproduced);
- the PromptSRC loss, its aux terms and the prompt gradients on one batch,
  against jax.value_and_grad of the JAX loss_fn, on JAX's default attention
  and on its head-packed Pallas kernels (#6-#8, interpret mode);
- a 4-step JAX-against-port trajectory with deep prompts on a uint8 cache;
- the committed golden PromptSRC trajectory (the reference optimizer stack,
  with GPA) replayed through the port's trainer.

fp32 throughout; each test states its tolerance.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.engine import optim as jax_optim
from fsvlm_tpu.ops import preprocess as jax_preprocess
from fsvlm_tpu.trainers import losses as jax_losses
from fsvlm_tpu_torch.config import get_cfg_default
from fsvlm_tpu_torch.engine import optim
from fsvlm_tpu_torch.models.clip import CLIPConfig, random_clip_params
from fsvlm_tpu_torch.ops import preprocess
from fsvlm_tpu_torch.trainers import losses
from fsvlm_tpu_torch.trainers.backbone import clip_from_params
from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

TINY = (64, 32, 2, 128, 16, 77, 49408, 128, 2, 2)  # d = 64 in both towers
CLASSNAMES = ["cat", "golden_retriever", "aircraft carrier", "sea", "Ferrari 250 GTO"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _set(cfg, **kw):
    """cfg.A.B = v for each A__B=v (works on the yacs tree and the dataclasses)."""
    for path, value in kw.items():
        *parents, leaf = path.split("__")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    return cfg


def _both_cfgs(**kw):
    return _set(jax_get_cfg_default(), **kw), _set(get_cfg_default(), **kw)


# ------------------------------------------------------------------- losses
def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(6, 5)).astype(np.float32)
    labels = rng.randint(0, 5, 6)
    valid = np.array([True, True, False, True, True, False])
    z1, z2 = rng.randn(6, 8).astype(np.float32), rng.randn(6, 8).astype(np.float32)
    return logits, labels, valid, z1, z2


LOSS_CASES = {
    "masked_mean": lambda m, a, lab, v, z1, z2: m.masked_mean(z1[:, 0], v),
    "masked_acc": lambda m, a, lab, v, z1, z2: m.masked_acc(a, lab, v),
    "cross_entropy": lambda m, a, lab, v, z1, z2: m.cross_entropy(a, lab, valid=v),
    "focal_loss": lambda m, a, lab, v, z1, z2: m.focal_loss(a, lab, valid=v),
    "focal_loss_alpha": lambda m, a, lab, v, z1, z2: m.focal_loss(
        a, lab, alpha=m.focal_alpha_from_shots([1, 4, 0, 2, 8]), valid=v),
    "nt_xent": lambda m, a, lab, v, z1, z2: m.nt_xent(z1, z2, valid=v),
    "l1_loss": lambda m, a, lab, v, z1, z2: m.l1_loss(z1, z2, valid=v),
}


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name, masked):
    logits, labels, valid, z1, z2 = _loss_inputs()
    v = valid if masked else None
    ref = LOSS_CASES[name](jax_losses, jnp.asarray(logits), jnp.asarray(labels),
                           None if v is None else jnp.asarray(v), jnp.asarray(z1), jnp.asarray(z2))
    t = torch.from_numpy
    got = LOSS_CASES[name](losses, t(logits), t(labels).long(), None if v is None else t(v),
                           t(z1), t(z2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-6)


def test_focal_alpha_from_shots_matches_jax():
    shots = [1, 4, 0, 2, 8]
    np.testing.assert_array_equal(losses.focal_alpha_from_shots(shots).numpy(),
                                  np.asarray(jax_losses.focal_alpha_from_shots(shots)))


# ----------------------------------------------------------------- schedule
SCHEDULES = [  # the six configs of tests/test_loss_and_schedule_parity.py:125-148
    dict(LR=0.0025, MAX_EPOCH=20, LR_SCHEDULER="cosine",
         WARMUP_EPOCH=1, WARMUP_TYPE="constant", WARMUP_CONS_LR=1e-5),
    dict(LR=0.0035, MAX_EPOCH=5, LR_SCHEDULER="cosine",
         WARMUP_EPOCH=1, WARMUP_TYPE="constant", WARMUP_CONS_LR=1e-5),
    dict(LR=0.002, MAX_EPOCH=12, LR_SCHEDULER="cosine",
         WARMUP_EPOCH=3, WARMUP_TYPE="linear", WARMUP_MIN_LR=1e-6),
    dict(LR=0.1, MAX_EPOCH=12, LR_SCHEDULER="multi_step", STEPSIZE=(4, 7), GAMMA=0.1,
         WARMUP_EPOCH=2, WARMUP_TYPE="constant", WARMUP_CONS_LR=1e-5),
    dict(LR=0.05, MAX_EPOCH=10, LR_SCHEDULER="single_step", STEPSIZE=(2, 3), GAMMA=0.5,
         WARMUP_EPOCH=-1),
    dict(LR=0.01, MAX_EPOCH=8, LR_SCHEDULER="cosine", WARMUP_EPOCH=-1),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=[f"cfg{i}" for i in range(len(SCHEDULES))])
def test_lr_schedule_matches_jax(kw):
    jcfg, pcfg = _both_cfgs(**{f"OPTIM__{k}": v for k, v in kw.items()})
    ref = jax_optim.make_lr_schedule(jcfg, steps_per_epoch=10)
    sched = optim.make_lr_schedule(pcfg, steps_per_epoch=10, device="cpu")
    epochs = range(kw["MAX_EPOCH"] + 1)
    assert [sched.lr_at_epoch(e) for e in epochs] == [ref.lr_at_epoch(e) for e in epochs]
    steps = np.arange(10 * kw["MAX_EPOCH"] + 15)
    np.testing.assert_array_equal(sched(torch.from_numpy(steps)).numpy(),
                                  np.asarray(ref(jnp.asarray(steps))))
    assert sched(7).shape == () and float(sched(7)) == float(ref(7))


# ---------------------------------------------------------------------- SGD
@pytest.mark.parametrize("bad_steps", [(4,), tuple(range(2, 11))], ids=["one_inf", "nine_in_a_row"])
@pytest.mark.parametrize("nesterov", [False, True], ids=["momentum", "nesterov"])
def test_sgd_with_apply_if_finite_matches_optax(nesterov, bad_steps):
    """12 steps of the optax chain (coupled decay -> trace -> lr schedule)
    under apply_if_finite(8): a non-finite step leaves parameters, momentum
    and the schedule's count as they were, unless it is the 9th in a row."""
    jcfg, pcfg = _both_cfgs(OPTIM__NAME="sgd", OPTIM__LR=0.1, OPTIM__MOMENTUM=0.9,
                            OPTIM__WEIGHT_DECAY=5e-4, OPTIM__SGD_NESTEROV=nesterov,
                            OPTIM__MAX_EPOCH=4, OPTIM__LR_SCHEDULER="cosine",
                            OPTIM__WARMUP_EPOCH=1, OPTIM__WARMUP_TYPE="constant",
                            OPTIM__WARMUP_CONS_LR=1e-2)
    rng = np.random.RandomState(0)
    init = {"a": rng.randn(4, 8).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    tx, _ = jax_optim.build_optimizer(jcfg, steps_per_epoch=3)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    sgd, _ = optim.build_optimizer(pcfg, params.values(), steps_per_epoch=3)
    for step in range(12):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
        if step in bad_steps:
            grads["b"][1] = np.inf
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        sgd.step([torch.from_numpy(grads[k]) for k in params])
        for k in params:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} at step {step}")
        assert int(sgd.notfinite_count) == int(state.notfinite_count)
    applied = 12 - len(bad_steps) + (1 if len(bad_steps) > 8 else 0)
    assert int(sgd.count) == applied


# --------------------------------------------------------------- preprocess
def test_crop_resize_flip_normalize_matches_jax_on_jax_boxes():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (4, 40, 48, 3), dtype=np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    boxes = np.stack([np.asarray(jax_preprocess._sample_crop_box(k, 40, 48, (0.08, 1.0)))
                      for k in keys]).astype(np.float32)
    flips = np.array([True, False, True, False])
    mean, std = jnp.asarray(preprocess.CLIP_PIXEL_MEAN), jnp.asarray(preprocess.CLIP_PIXEL_STD)
    ref = np.stack([
        (jax_preprocess._bilinear_crop_resize(jnp.asarray(images[b]), *boxes[b], 32, flips[b])
         / 255.0 - mean) / std for b in range(4)])
    got = preprocess.crop_resize_flip_normalize(torch.from_numpy(images), torch.from_numpy(boxes),
                                                torch.from_numpy(flips), 32)
    assert got.shape == (4, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_box_sampler_stays_in_range_and_falls_back_to_a_center_crop():
    gen = torch.Generator().manual_seed(0)
    for H, W in ((40, 48), (224, 224)):
        i, j, h, w = preprocess.sample_crop_boxes(2000, H, W, (0.08, 1.0), gen).unbind(1)
        assert ((h >= 1) & (w >= 1) & (i >= 0) & (j >= 0)).all()
        assert ((i + h <= H) & (j + w <= W)).all()
        assert (h * w <= H * W).all() and (h * w >= 0.08 * H * W * 0.8).all()
        assert (i == i.floor()).all() and (h == h.round()).all()
    flips = preprocess.sample_flips(2000, gen)
    assert 0.4 < flips.float().mean().item() < 0.6
    # no try can fit: the clamped-aspect center crop, as JAX's sampler gives it
    for H, W in ((40, 48), (40, 80), (90, 40)):
        got = preprocess.sample_crop_boxes(3, H, W, (2.0, 3.0), gen)
        ref = np.asarray(jax_preprocess._sample_crop_box(jax.random.PRNGKey(0), H, W, (2.0, 3.0)))
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(ref, (3, 4)))


# ----------------------------------------------------------------- PromptSRC
NODE = dict(N_CTX_TEXT=4, N_CTX_VISION=4, PROMPT_DEPTH_TEXT=2, PROMPT_DEPTH_VISION=2,
            CTX_INIT="a photo of a", PREC="fp32", GPA_MEAN=1, GPA_STD=1)


def _promptsrc_cfgs(**kw):
    base = dict(SEED=2, OPTIM__NAME="sgd", OPTIM__LR=0.05, OPTIM__MAX_EPOCH=2,
                OPTIM__LR_SCHEDULER="cosine", OPTIM__WARMUP_EPOCH=1,
                OPTIM__WARMUP_TYPE="constant", OPTIM__WARMUP_CONS_LR=1e-3,
                INPUT__SIZE=(32, 32), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD), DATALOADER__TRAIN_X__BATCH_SIZE=4)
    base.update({f"TRAINER__PROMPTSRC__{k}": v for k, v in NODE.items()})
    return _both_cfgs(**dict(base, **kw))


@pytest.fixture(scope="module")
def tiny_params():
    return random_clip_params(CLIPConfig(*TINY), seed=3)


def _jax_promptsrc(jcfg, params, classnames):
    """The JAX PromptSRC's model state and loss_fn, built without its
    DataManager."""
    import fsvlm_tpu.trainers.ivlp as jax_ivlp
    from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig
    from fsvlm_tpu.trainers.promptsrc import PromptSRC as JaxPromptSRC

    t = JaxPromptSRC.__new__(JaxPromptSRC)
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=classnames))
    saved = jax_ivlp.load_clip_backbone
    jax_ivlp.load_clip_backbone = lambda cfg: (params, JaxCLIPConfig(*TINY))
    try:
        t.build_model()
    finally:
        jax_ivlp.load_clip_backbone = saved
    return t


def _port_promptsrc(pcfg, params, classnames, **kw):
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    return PromptSRC(pcfg, classnames, clip=clip, device="cpu", **kw)


@pytest.mark.parametrize("case", ["default", "packed", "focal_simclr"])
def test_promptsrc_loss_and_prompt_grads_match_jax(tiny_params, case, monkeypatch):
    """One batch (one padded row): loss and aux at rtol 1e-4 / atol 1e-5,
    gradients of every prompt tensor at rtol 1e-3 / atol 1e-6 of the largest
    gradient entry.  ``packed``: JAX's attention is the head-packed Pallas
    forward and backward (kernels #6-#8) in interpret mode.
    ``focal_simclr``: the focal loss with per-class alpha, plus the SimCLR
    term on a second view."""
    kw = {}
    if case == "packed":
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", "packed")
    if case == "focal_simclr":
        kw = dict(TRAINER__PROMPTSRC__LOSS_TYPE="focal", TRAINER__PROMPTSRC__SIMCLR_ALPHA=0.5,
                  DATASET__PER_CLASS_SHOTS=[1, 4, 0, 2, 8])
    jcfg, pcfg = _promptsrc_cfgs(**kw)
    jt = _jax_promptsrc(jcfg, tiny_params, CLASSNAMES)
    pt = _port_promptsrc(pcfg, tiny_params, CLASSNAMES, steps_per_epoch=2)
    assert sorted(pt.params) == sorted(jt.params) == ["ctx", "text_deep", "vision_deep",
                                                      "vpt_shallow"]
    for k, v in jt.params.items():
        np.testing.assert_array_equal(pt.params[k].detach().numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_allclose(pt.frozen["zs_text"].numpy(), np.asarray(jt.frozen["zs_text"]),
                               rtol=1e-5, atol=1e-6)

    rng = np.random.RandomState(1)
    images = rng.randn(4, 32, 32, 3).astype(np.float32)
    labels = np.array([0, 3, 1, 4])
    valid = np.array([True, True, True, False])
    batch = {"img": images, "label": labels, "valid": valid}
    if case == "focal_simclr":
        batch["img2"] = rng.randn(4, 32, 32, 3).astype(np.float32)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        jt.params, jt.frozen, batch, jax.random.PRNGKey(0))

    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p_loss, p_aux = pt.loss_fn(pt.params, pt.frozen, batch)
    p_grads = torch.autograd.grad(p_loss, list(pt.params.values()))
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=1e-4, atol=1e-5)
    for k, v in aux.items():
        np.testing.assert_allclose(p_aux[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    for (k, g), pg in zip(pt.params.items(), p_grads):
        ref = np.asarray(grads[k])
        np.testing.assert_allclose(pg.numpy(), ref, rtol=1e-3, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=k)
        assert np.abs(ref).max() > 0, k


def test_split_eval_matches_jax(tiny_params):
    """IVLP's split eval, inherited by PromptSRC: class text features once,
    then image logits per batch (rtol 1e-4 / atol 1e-4)."""
    jcfg, pcfg = _promptsrc_cfgs()
    jt = _jax_promptsrc(jcfg, tiny_params, CLASSNAMES)
    pt = _port_promptsrc(pcfg, tiny_params, CLASSNAMES, steps_per_epoch=1)
    images = np.random.RandomState(3).randn(3, 32, 32, 3).astype(np.float32)
    ref_txf = jt.text_features_fn(jt.params, jt.frozen)
    ref = jt.image_logits_fn(jt.params, jt.frozen, images, ref_txf)
    with torch.no_grad():
        txf = pt.text_features_fn(pt.params, pt.frozen)
        logits = pt.image_logits_fn(pt.params, pt.frozen, torch.from_numpy(images), txf)
    np.testing.assert_allclose(txf.numpy(), np.asarray(ref_txf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_promptsrc_trajectory_with_deep_prompts_matches_jax(tiny_params):
    """2 epochs of 2 resident steps on a uint8 cache under DEVICE_AUG, the
    port's boxes and flips taken from JAX's draws for each step.  Loss per
    step within 1e-4 * (1 + |loss|); every prompt tensor at rtol 1e-3 /
    atol 1e-6."""
    from fsvlm_tpu.ops.preprocess import random_resized_crop_flip_normalize

    jcfg, pcfg = _promptsrc_cfgs(DATALOADER__DEVICE_AUG=True)
    rng = np.random.RandomState(5)
    cache = rng.randint(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), 8)
    jt = _jax_promptsrc(jcfg, tiny_params, CLASSNAMES)
    pt = _port_promptsrc(pcfg, tiny_params, CLASSNAMES, images=cache, labels=labels)
    assert pt.steps_per_epoch == 2
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
        metrics = pt.train_step_resident(torch.from_numpy(index), aug=(boxes, flips))
        assert abs(metrics["loss"].item() - float(loss)) <= 1e-4 * (1 + abs(float(loss))), step
        for k, v in params.items():
            np.testing.assert_allclose(pt.params[k].detach().numpy(), np.asarray(v), rtol=1e-3,
                                       atol=1e-6, err_msg=f"{k} at step {step}")
    assert int(pt.optim.count) == 4 and pt.get_current_lr() == 1e-3


def test_trainer_runs_epochs_on_its_own_draws(tiny_params):
    """train(): epochs of resident steps on the generator's permutation,
    boxes and flips; the same seed gives the same run; GPA is swapped in
    after the last epoch."""
    runs = []
    for _ in range(2):
        _, pcfg = _promptsrc_cfgs(DATALOADER__DEVICE_AUG=True)
        rng = np.random.RandomState(5)
        cache = rng.randint(0, 256, (10, 40, 40, 3), dtype=np.uint8)
        pt = _port_promptsrc(pcfg, tiny_params, CLASSNAMES, images=cache,
                             labels=rng.randint(0, 5, 10))
        index, valid = pt.epoch_schedule()
        assert index.shape == valid.shape == (2, 4) and bool(valid.all())
        assert len(set(index.flatten().tolist())) == 8
        history = pt.train()
        assert [len(h) for h in history] == [2, 2] and int(pt.optim.count) == 4
        assert all(np.isfinite(m["loss"]) for h in history for m in h)
        runs.append(([m["loss"] for h in history for m in h],
                     {k: v.detach().clone() for k, v in pt.params.items()}))
        state = pt.extra_state()
        for k, p in pt.params.items():  # the aggregate, not the last step's prompts
            torch.testing.assert_close(p.detach(), pt.gpa_params[k], rtol=0, atol=0)
            np.testing.assert_array_equal(state["gpa_params"][k], p.detach().numpy())
        assert abs(pt.gauss.sum() - 1) < 1e-12
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        torch.testing.assert_close(runs[0][1][k], runs[1][1][k], rtol=0, atol=0)
    _, pcfg = _promptsrc_cfgs(DATALOADER__TRAIN_X__BATCH_SIZE=8)
    pt = _port_promptsrc(pcfg, tiny_params, CLASSNAMES, images=cache[:5], labels=np.zeros(5))
    index, valid = pt.epoch_schedule()  # fewer items than a batch: padded, masked
    assert pt.steps_per_epoch == 1 and valid.tolist() == [[True] * 5 + [False] * 3]
    assert (index[0, 5:] == index[0, 4]).all()


def test_golden_promptsrc_trajectory_replays_through_the_port(tmp_path):
    """tests/golden_pack/promptsrc_trajectory.npz: 10 steps / 5 epochs of
    the reference PromptSRC (CE + SCL losses, dassl SGD, warmup + cosine,
    GPA), replayed through the port's trainer at the tolerances of
    tests/test_golden_pack.py:331-344."""
    from test_golden_pack import _load
    from test_trajectory_parity import BATCH, N_CLS, N_EPOCHS, STEPS_PER_EPOCH, _batches

    from fsvlm_tpu.models.clip import clip_params_from_state_dict

    z = _load("promptsrc_trajectory.npz")
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd.")}
    params, jax_clip_cfg = clip_params_from_state_dict(sd)
    clip_cfg = CLIPConfig(**{f: getattr(jax_clip_cfg, f) for f in CLIPConfig.__dataclass_fields__})
    _, cfg = _both_cfgs(
        SEED=1, MODEL__TEXT_TRUNCATE=False, DATALOADER__TRAIN_X__BATCH_SIZE=BATCH,
        OPTIM__NAME="sgd", OPTIM__LR=0.05, OPTIM__MOMENTUM=0.9, OPTIM__WEIGHT_DECAY=5e-4,
        OPTIM__LR_SCHEDULER="cosine", OPTIM__MAX_EPOCH=N_EPOCHS, OPTIM__WARMUP_EPOCH=1,
        OPTIM__WARMUP_TYPE="constant", OPTIM__WARMUP_CONS_LR=1e-3,
        TRAINER__PROMPTSRC__N_CTX_TEXT=4, TRAINER__PROMPTSRC__N_CTX_VISION=0,
        TRAINER__PROMPTSRC__CTX_INIT="a picture of a", TRAINER__PROMPTSRC__PREC="fp32",
        TRAINER__PROMPTSRC__PROMPT_DEPTH_TEXT=1, TRAINER__PROMPTSRC__PROMPT_DEPTH_VISION=0,
        TRAINER__PROMPTSRC__TEXT_LOSS_WEIGHT=25.0, TRAINER__PROMPTSRC__IMAGE_LOSS_WEIGHT=10.0,
        TRAINER__PROMPTSRC__GPA_MEAN=3, TRAINER__PROMPTSRC__GPA_STD=1,
        TRAINER__PROMPTSRC__USE_GPA=True)
    clip = clip_from_params(params, clip_cfg, device="cpu")
    trainer = PromptSRC(cfg, [f"synthetic class {i}" for i in range(N_CLS)], clip=clip,
                        device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
    assert set(trainer.params) == {"ctx"}
    np.testing.assert_allclose(trainer.gauss, z["gauss"], rtol=1e-6)

    batches = _batches(seed=7)
    our_losses, our_ctx = [], []
    for ep in range(N_EPOCHS):
        trainer.epoch = ep
        for bi in range(STEPS_PER_EPOCH):
            imgs, labels = batches[ep * STEPS_PER_EPOCH + bi]
            trainer.batch_idx = bi
            metrics = trainer.forward_backward({"img": imgs, "label": labels,
                                                "valid": np.ones(len(labels), bool)})
            our_losses.append(metrics["loss"].item())
            our_ctx.append(trainer.params["ctx"].detach().numpy().copy())
        trainer.after_epoch()  # GPA accumulation (+ final swap-in)

    ref_losses, ref_ctx = z["losses"], z["ctx"]
    assert len(our_losses) == N_EPOCHS * STEPS_PER_EPOCH == len(ref_losses)
    last = len(ref_losses) - 1
    for k in range(len(ref_losses)):
        assert abs(our_losses[k] - ref_losses[k]) < 1e-3 * (1 + abs(ref_losses[k])), (
            f"loss diverged at step {k}: {our_losses[k]} vs {ref_losses[k]}")
        if k == last:
            continue  # ref_ctx[-1] is the GPA aggregate, compared below
        np.testing.assert_allclose(our_ctx[k], ref_ctx[k], rtol=2e-3, atol=2e-5,
                                   err_msg=f"ctx diverged at step {k}")
    np.testing.assert_allclose(trainer.params["ctx"].detach().numpy(), z["final_ctx"],
                               rtol=2e-3, atol=2e-5, err_msg="GPA aggregate diverged")
