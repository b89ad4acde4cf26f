"""The int8 frozen teacher (TRAINER.PROMPTSRC.INT8_TEACHER, and IVLP's KD
teacher under TRAINER.IVLP.INT8_TEACHER) against the JAX package's, on the
CPU (test_torch_train.py's tiny CLIP, fp32).  Mirrors
tests/test_int8_teacher.py.

The teacher's int8 rounding can flip one step where the two packages'
fp32 activations differ by an ulp at a rounding tie, so what depends on the
teacher (its features, the loss, the prompt gradients) is held to JAX's
int8-teacher value at a distance at most a third of that value's distance
to JAX's fp-teacher value (test_torch_quant.py's RATIO rule).  Static
activation scales agree within 1e-5 relative; with DEVICE_AUG the step's
boxes and flips are JAX's draws, handed to the port.
"""

import io
import os
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quant import RATIO
from test_torch_train import CLASSNAMES, TINY, _both_cfgs

from fsvlm_tpu_torch.models.clip import CLIPConfig, encode_image, random_clip_params
from fsvlm_tpu_torch.ops import preprocess
from fsvlm_tpu_torch.ops import quant as pq
from fsvlm_tpu_torch.trainers.backbone import clip_from_params
from fsvlm_tpu_torch.trainers.ivlp import IVLP
from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_params():
    return random_clip_params(CLIPConfig(*TINY), seed=3)


def _cfgs(key, **kw):
    base = dict(SEED=2, OPTIM__NAME="sgd", OPTIM__LR=0.05, OPTIM__MAX_EPOCH=2,
                OPTIM__LR_SCHEDULER="cosine", OPTIM__WARMUP_EPOCH=1,
                OPTIM__WARMUP_TYPE="constant", OPTIM__WARMUP_CONS_LR=1e-3,
                INPUT__SIZE=(32, 32), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD), DATALOADER__TRAIN_X__BATCH_SIZE=4,
                DATASET__NAME="OxfordPets", MODEL__QUANT_INT8_CALIB_BATCHES=2)
    node = dict(N_CTX_TEXT=2, N_CTX_VISION=2, PROMPT_DEPTH_TEXT=2, PROMPT_DEPTH_VISION=2,
                CTX_INIT="a photo of a", PREC="fp32")
    if key == "PROMPTSRC":
        node.update(TEXT_LOSS_WEIGHT=1.0, IMAGE_LOSS_WEIGHT=0.5, GPA_MEAN=1, GPA_STD=1)
    else:
        node.update(USE_MIXUP=False, USE_KD=True, KD_ALPHA=0.5, KD_T=4.0)
    base.update({f"TRAINER__{key}__{k}": v for k, v in node.items()})
    return _both_cfgs(**dict(base, **kw))


def _norm(u8):
    return ((u8 / np.float32(255) - np.float32(preprocess.CLIP_PIXEL_MEAN))
            / np.float32(preprocess.CLIP_PIXEL_STD)).astype(np.float32)


CAL_U8 = np.random.RandomState(12).randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)


def _jax_trainer(cls_name, jcfg, params):
    """The JAX trainer built without its DataManager; its train loader (for
    static scales) the normalized views of CAL_U8 in batches of 4."""
    import fsvlm_tpu.trainers.ivlp as jax_ivlp
    import fsvlm_tpu.trainers.promptsrc as jax_promptsrc
    from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig

    cls = getattr(jax_ivlp if cls_name == "IVLP" else jax_promptsrc, cls_name)
    t = cls.__new__(cls)
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=CLASSNAMES))
    t.train_loader_x = [{"img": _norm(CAL_U8[i:i + 4])} for i in (0, 4)]
    t.parse_batch_train = lambda batch: batch
    saved = jax_ivlp.load_clip_backbone
    jax_ivlp.load_clip_backbone = lambda cfg: (params, JaxCLIPConfig(*TINY))
    try:
        t.build_model()
    finally:
        jax_ivlp.load_clip_backbone = saved
    return t


def _port_trainer(cls, pcfg, params, static):
    """The port's trainer fed tensors; under ``static`` its teacher is
    rebuilt on the uint8 views of CAL_U8 as a loader gives them (a trainer
    fed tensors has no loader of its own)."""
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    t = cls(pcfg, CLASSNAMES, clip=clip, device="cpu", steps_per_epoch=2)
    if static:
        t.cfg.MODEL.QUANT_INT8_STATIC = True
        t.train_loader_x = [{"img": CAL_U8[i:i + 4]} for i in (0, 4)]
        t.frozen["clip_teacher"] = t.int8_teacher_tower("[test]")
    return t


def _gap_rule(got, ref_q, ref_fp, what):
    gap = np.linalg.norm(np.asarray(ref_q) - np.asarray(ref_fp))
    assert gap > 0, what
    dist = np.linalg.norm(np.asarray(got) - np.asarray(ref_q))
    assert dist <= RATIO * gap, (what, dist, gap)


def _batch():
    rng = np.random.RandomState(1)
    return {"img": rng.randn(4, 32, 32, 3).astype(np.float32), "label": np.array([0, 3, 1, 4]),
            "valid": np.array([True, True, True, False])}


def _jax_loss_grads(t, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(t.loss_fn, has_aux=True))(
        t.params, t.frozen, batch, jax.random.PRNGKey(1))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_grads(t, batch):
    loss, _ = t.loss_fn(t.params, t.frozen, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(t.params.values()))
    return loss.item(), {k: g.numpy() for k, g in zip(t.params, grads)}


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("trainer", ["PromptSRC", "IVLP"])
def test_int8_teacher_first_step_matches_jax(tiny_params, trainer, static):
    """The int8 teacher (attn + mlp; static scales from the train loader's
    first 2 batches) against JAX's: the teacher records (xs within 1e-5),
    the teacher image features (PromptSRC) or KD logits (IVLP), the loss
    and every prompt gradient by the RATIO rule against JAX's fp teacher;
    the float CLIP is shared, and the log line is JAX's."""
    key = trainer.upper()
    jcfg, pcfg = _cfgs(key, **{f"TRAINER__{key}__INT8_TEACHER": True})
    jcfg.MODEL.QUANT_INT8_STATIC = static
    jfp_cfg, _ = _cfgs(key)
    jt = _jax_trainer(trainer, jcfg, tiny_params)
    jt_fp = _jax_trainer(trainer, jfp_cfg, tiny_params)
    with redirect_stdout(io.StringIO()) as out:
        pt = _port_trainer(PromptSRC if trainer == "PromptSRC" else IVLP, pcfg, tiny_params,
                           static)
    label = "[PromptSRC] int8 teacher" if trainer == "PromptSRC" else "[IVLP] int8 KD teacher"
    assert f"{label} image tower (INT8_TEACHER, act=dynamic)" in out.getvalue()

    teacher = pt.frozen["clip_teacher"]
    assert teacher.text is pt.clip.text and teacher.logit_scale is pt.clip.logit_scale
    ref = jt.frozen["clip_teacher"]["visual"]["blocks"]
    for i, b in enumerate(teacher.visual.blocks):
        for group, name in pq._TOWER_GEMMS:
            rec, jrec = getattr(getattr(b, group), name), ref[group][name]
            np.testing.assert_array_equal(rec.q8.numpy(), np.asarray(jrec["q8"][i]))
            assert (rec.xs is not None) == static == ("xs" in jrec)
            if static:
                np.testing.assert_allclose(rec.xs.item(), float(jrec["xs"][i]), rtol=1e-5)

    batch = _batch()
    if trainer == "PromptSRC":
        from fsvlm_tpu.models.clip import encode_image as jax_encode_image

        jcc = jt.clip_cfg
        ref_q = jax_encode_image(jt.frozen["clip_teacher"], jcc, jnp.asarray(batch["img"]))
        ref_fp = jax_encode_image(jt.frozen["clip"], jcc, jnp.asarray(batch["img"]))
        with torch.no_grad():
            got = encode_image(teacher, torch.from_numpy(batch["img"]))
        _gap_rule(got.numpy(), ref_q, ref_fp, "teacher image features")
    else:
        with torch.no_grad():
            got = pt.teacher_logits(pt.frozen, torch.from_numpy(batch["img"]))
        from fsvlm_tpu.models.clip import encode_image as jax_encode_image
        from fsvlm_tpu.models.clip import l2_normalize as jax_l2

        def jax_teacher(clip_tree):
            zs = jax_encode_image(clip_tree, jt.clip_cfg, jnp.asarray(batch["img"]))
            return jnp.exp(jt.frozen["clip"]["logit_scale"]) * jax_l2(zs) @ jt.frozen[
                "teacher_text"].T

        _gap_rule(got.numpy(), jax_teacher(jt.frozen["clip_teacher"]),
                  jax_teacher(jt.frozen["clip"]), "KD teacher logits")

    loss_q, grads_q = _jax_loss_grads(jt, batch)
    loss_fp, grads_fp = _jax_loss_grads(jt_fp, batch)
    loss, grads = _port_loss_grads(pt, batch)
    _gap_rule(loss, loss_q, loss_fp, "loss")
    assert sorted(grads) == sorted(grads_q)
    for k in grads:
        _gap_rule(grads[k], grads_q[k], grads_fp[k], f"gradient {k}")
        assert np.isfinite(grads[k]).all() and np.abs(grads[k]).max() > 0, k


def test_promptsrc_int8_teacher_step_on_jax_draws_matches_jax(tiny_params):
    """One DEVICE_AUG resident step of PromptSRC with the int8 teacher, the
    port's boxes and flips taken from JAX's draws: the loss and every
    updated prompt tensor by the RATIO rule against JAX's fp-teacher step."""
    import optax

    from fsvlm_tpu.engine import optim as jax_optim
    from fsvlm_tpu.ops import preprocess as jax_preprocess

    jcfg, pcfg = _cfgs("PROMPTSRC", DATALOADER__DEVICE_AUG=True,
                       TRAINER__PROMPTSRC__INT8_TEACHER=True)
    jfp_cfg, _ = _cfgs("PROMPTSRC", DATALOADER__DEVICE_AUG=True)
    rng = np.random.RandomState(5)
    cache = rng.randint(0, 256, (4, 40, 40, 3), dtype=np.uint8)
    labels = np.array([0, 3, 1, 4])
    jt, jt_fp = _jax_trainer("PromptSRC", jcfg, tiny_params), _jax_trainer(
        "PromptSRC", jfp_cfg, tiny_params)
    clip = clip_from_params(tiny_params, CLIPConfig(*TINY), device="cpu")
    with redirect_stdout(io.StringIO()):
        pt = PromptSRC(pcfg, CLASSNAMES, cache, labels, clip=clip, device="cpu")
    tx, _ = jax_optim.build_optimizer(jcfg, steps_per_epoch=1)
    mean, std = jnp.asarray(jcfg.INPUT.PIXEL_MEAN), jnp.asarray(jcfg.INPUT.PIXEL_STD)
    scale = tuple(jcfg.INPUT.RRCROP_SCALE)
    key = jax.random.PRNGKey(100)

    def jax_step(t):
        k_aug, k_rest = jax.random.split(key)
        imgs = jax_preprocess.random_resized_crop_flip_normalize(
            jnp.asarray(cache), k_aug, out_size=32, scale=scale, mean=mean, std=std)
        (loss, _), grads = jax.value_and_grad(t.loss_fn, has_aux=True)(
            t.params, t.frozen, {"img": imgs, "label": jnp.asarray(labels)}, k_rest)
        updates, _ = tx.update(grads, tx.init(t.params), t.params)
        return float(loss), optax.apply_updates(t.params, updates)

    keys = jax.random.split(jax.random.split(key)[0], 5)
    flips = torch.from_numpy(np.array(jax.random.bernoulli(keys[0], 0.5, (4,))))
    boxes = torch.from_numpy(np.array(jax.vmap(
        lambda k: jnp.stack(jax_preprocess._sample_crop_box(k, 40, 40, scale)))(keys[1:])))
    (loss_q, params_q), (loss_fp, params_fp) = jax_step(jt), jax_step(jt_fp)
    metrics = pt.train_step_resident(torch.arange(4), aug=(boxes, flips))
    _gap_rule(metrics["loss"].item(), loss_q, loss_fp, "loss")
    for k, v in params_q.items():
        _gap_rule(pt.params[k].detach().numpy(), v, params_fp[k], k)


def test_int8_teacher_trains_and_tracks_the_fp_teacher(tiny_params):
    """PromptSRC's train() end to end with the int8 teacher on the
    trainer's own draws: finite losses, the first step's loss within 5% of
    the fp teacher's on the same draws (test_int8_teacher.py's rule)."""
    _, pcfg = _cfgs("PROMPTSRC", DATALOADER__DEVICE_AUG=True, TRAINER__PROMPTSRC__INT8_TEACHER=True)
    _, pcfg_fp = _cfgs("PROMPTSRC", DATALOADER__DEVICE_AUG=True)
    cache = np.random.RandomState(7).randint(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = np.arange(8) % len(CLASSNAMES)
    runs = []
    for cfg in (pcfg, pcfg_fp):
        clip = clip_from_params(tiny_params, CLIPConfig(*TINY), device="cpu")
        with redirect_stdout(io.StringIO()):
            t = PromptSRC(cfg, CLASSNAMES, cache, labels, clip=clip, device="cpu")
            runs.append([m["loss"] for h in t.train() for m in h])
    assert len(runs[0]) == 4 and np.isfinite(runs[0]).all()
    assert abs(runs[0][0] - runs[1][0]) / abs(runs[1][0]) < 0.05


def _cfg_built(tmp_path, **kw):
    """Both packages' configs on Synthetic (test-tiny, the host pipeline at
    one loader thread), PromptSRC with the int8 teacher at static scales."""
    from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
    from fsvlm_tpu_torch.config import get_cfg_base

    opts = {"TRAINER.NAME": "PromptSRC", "SEED": 1, "VERBOSE": False,
            "OUTPUT_DIR": str(tmp_path), "DATASET.NUM_SHOTS": 4,
            "DATALOADER.TRAIN_X.BATCH_SIZE": 8, "DATALOADER.NUM_WORKERS": 1,
            "OPTIM.MAX_EPOCH": 1, "TRAINER.PROMPTSRC.PREC": "fp32",
            "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT": 2, "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION": 2,
            "TRAINER.PROMPTSRC.INT8_TEACHER": True, "MODEL.QUANT_INT8_STATIC": True,
            "MODEL.QUANT_INT8_CALIB_BATCHES": 2}
    opts.update(kw)
    flat = [x for kv in opts.items() for x in kv]
    jcfg, pcfg = jax_get_cfg_default(), get_cfg_base()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(os.path.join(ROOT, "configs/datasets/synthetic.yaml"))
        cfg.merge_from_file(os.path.join(ROOT, "configs/trainers/tests/synthetic_tiny.yaml"))
        cfg.merge_from_list(flat)
    return jcfg, pcfg


def test_static_teacher_calibrates_on_the_train_views_as_jax(tmp_path):
    """Built from cfg on Synthetic with the host pipeline (DEVICE_AUG
    False): JAX calibrates on its loader's normalized float views, the port
    on its uint8 views normalized as the step normalizes them, so the
    static scales agree within 1e-5.  Under CACHED_TEACHER the int8 teacher
    is off in both packages."""
    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    import fsvlm_tpu.trainers  # noqa: F401
    from fsvlm_tpu_torch.engine.trainer import build_trainer

    jcfg, pcfg = _cfg_built(tmp_path)
    with redirect_stdout(io.StringIO()):
        jt, pt = jax_build_trainer(jcfg), build_trainer(pcfg, device="cpu")
    assert next(iter(pt.train_loader_x))["img"].dtype == np.uint8
    ref = jt.frozen["clip_teacher"]["visual"]["blocks"]
    for i, b in enumerate(pt.frozen["clip_teacher"].visual.blocks):
        for group, name in pq._TOWER_GEMMS:
            np.testing.assert_allclose(getattr(getattr(b, group), name).xs.item(),
                                       float(ref[group][name]["xs"][i]), rtol=1e-5,
                                       err_msg=f"{group}.{name}[{i}]")
    jcfg, pcfg = _cfg_built(tmp_path, **{"TRAINER.PROMPTSRC.CACHED_TEACHER": True})
    with redirect_stdout(io.StringIO()):
        jt, pt = jax_build_trainer(jcfg), build_trainer(pcfg, device="cpu")
    assert "clip_teacher" not in jt.frozen and "clip_teacher" not in pt.frozen
    assert not pt.int8_teacher


def test_static_teacher_under_device_aug_raises(tmp_path):
    """Under DATALOADER.DEVICE_AUG the train loader gives raw uint8
    PRE_SIZE views: JAX fails on them at PRE_SIZE 256 (a shape mismatch in
    the tower) and calibrates on unnormalized pixels at PRE_SIZE =
    INPUT.SIZE; the port raises ValueError naming the combination, at any
    PRE_SIZE, in PromptSRC and IVLP (ROADMAP C.2)."""
    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    import fsvlm_tpu.trainers  # noqa: F401
    from fsvlm_tpu_torch.engine.trainer import build_trainer

    jcfg, _ = _cfg_built(tmp_path, **{"DATALOADER.DEVICE_AUG": True})
    with redirect_stdout(io.StringIO()), pytest.raises((ValueError, TypeError)):
        jax_build_trainer(jcfg)
    for pre in (256, 32):
        _, pcfg = _cfg_built(tmp_path, **{"DATALOADER.DEVICE_AUG": True,
                                          "DATALOADER.PRE_SIZE": pre})
        with redirect_stdout(io.StringIO()), pytest.raises(ValueError, match="DEVICE_AUG"):
            build_trainer(pcfg, device="cpu")
    _, pcfg = _cfgs("IVLP", DATALOADER__DEVICE_AUG=True, MODEL__QUANT_INT8_STATIC=True,
                    TRAINER__IVLP__INT8_TEACHER=True)
    clip = clip_from_params(random_clip_params(CLIPConfig(*TINY), seed=3), CLIPConfig(*TINY),
                            device="cpu")
    with pytest.raises(ValueError, match="TRAINER.IVLP.INT8_TEACHER under DATALOADER.DEVICE_AUG"):
        IVLP(pcfg, CLASSNAMES, clip=clip, device="cpu", steps_per_epoch=1)
