"""The port's CoOp and CoCoOp slice against the JAX package, on the CPU.

- the CoOp and CoCoOp ViT-B/16 recipe lists, through the port's
  ``merge_from_list``, against JAX's cfg after ``merge_from_file`` of their
  yaml files, and ``merge_from_list`` itself against JAX's;
- CoOp's loss and ctx gradient on one batch against jax.value_and_grad of
  the JAX loss_fn (ce, focal with PER_CLASS_SHOTS, simclr, CSC, class token
  middle and front), with FSVLM_FORCE_PALLAS unset and under ``legacy`` in
  both packages (the whole-sequence kernels #1-#2: JAX's in interpret mode,
  the port's plain versions);
- CoCoOp's init, and its loss and gradients on the batched path, on the
  class-chunked path (CLASS_CHUNK 3 over 5 classes, TRAIN.REMAT) and on the
  automatic chunk past BATCHED_TEXT_LIMIT under ``legacy``;
- remat: the same outputs and gradients, and the forwards it recomputes;
- test(): its logits against JAX's split eval and full logits, and its
  accuracy, macro-F1, per-class results and confusion matrix against the
  JAX evaluator on the same logits;
- the golden CoOp and CoCoOp trajectories (the reference trainers' frozen
  traces) replayed through the port.

fp32 throughout (test_torch_train.py's tiny CLIP, head dim 64); each test
states its tolerance.
"""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch
from test_torch_train import CLASSNAMES, TINY, _both_cfgs

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu_torch.config import RECIPES, get_cfg_default
from fsvlm_tpu_torch.models.clip import CLIPConfig, encode_image_vit, encode_text_embeds
from fsvlm_tpu_torch.models.clip import random_clip_params
from fsvlm_tpu_torch.ops import flash_attention, preprocess
from fsvlm_tpu_torch.trainers import cocoop
from fsvlm_tpu_torch.trainers.backbone import clip_from_params
from fsvlm_tpu_torch.trainers.coop import CoOp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- config
def _leaves(node, prefix=""):
    """(dotted key, value) of every leaf of a port config node."""
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            yield from _leaves(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


def _jax_value(jcfg, key):
    node = jcfg
    for part in key.split("."):
        node = node[part]
    return node


def _same(a, b):
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return list(a) == list(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_lists_give_the_yaml_values(recipe):
    """Every key of the sections CoOp and CoCoOp read, after the port's
    get_cfg_default() + merge_from_list(RECIPES[recipe]), equals JAX's
    get_cfg_default() + merge_from_file(recipe)."""
    jcfg = jax_get_cfg_default()
    jcfg.merge_from_file(os.path.join(REPO, recipe))
    cfg = get_cfg_default()
    cfg.merge_from_list(RECIPES[recipe])
    sections = ("SEED", "OPTIM.", "INPUT.", "DATALOADER.", "MODEL.", "TRAIN.", "TEST.", "DATASET.",
                "TRAINER.COOP.", "TRAINER.COCOOP.")
    checked = 0
    for key, value in _leaves(cfg):
        if key.startswith(sections):
            assert _same(value, _jax_value(jcfg, key)), (key, value, _jax_value(jcfg, key))
            checked += 1
    assert checked > 40
    assert set(vars(cfg.TRAINER.COOP)) == set(jcfg.TRAINER.COOP)
    assert set(vars(cfg.TRAINER.COCOOP)) == set(jcfg.TRAINER.COCOOP)


def test_merge_from_list_decodes_and_types_as_jax_does():
    opts = ["OPTIM.LR", "1e-3", "TRAIN.REMAT", "true", "INPUT.SIZE", "[32, 32]",
            "TRAINER.COOP.CTX_INIT", "a photo of a", "OPTIM.MAX_EPOCH", 3, "OPTIM.WARMUP_CONS_LR", 0,
            "TRAINER.COCOOP.CLASS_CHUNK", "7", "DATASET.PER_CLASS_SHOTS", "[1, 2]"]
    jcfg, cfg = jax_get_cfg_default(), get_cfg_default()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    for key in opts[0::2]:
        assert _same(_jax_value(jcfg, key), eval(f"cfg.{key}")), key
    assert cfg.INPUT.SIZE == (32, 32) and isinstance(cfg.OPTIM.WARMUP_CONS_LR, float)
    for bad, err in ((["OPTIM.NOPE", 1], KeyError), (["OPTIM", 1], KeyError),
                     (["OPTIM.MAX_EPOCH", "many"], ValueError), (["OPTIM.LR"], ValueError)):
        with pytest.raises(err):
            get_cfg_default().merge_from_list(bad)


# --------------------------------------------------------------------- CoOp
@pytest.fixture(scope="module")
def tiny_params():
    return random_clip_params(CLIPConfig(*TINY), seed=3)


def _cfgs(trainer_key, **kw):
    """Both packages' configs for ``trainer_key``.  CoCoOp's seed 4 leaves 11
    of the tiny meta-net's 16 hidden ReLU outputs (4 images x 4 units) on
    _batch() active; at seed 2 none is, and w1, b1 get no gradient."""
    base = dict(SEED=4 if trainer_key == "COCOOP" else 2, OPTIM__NAME="sgd", OPTIM__LR=0.05,
                OPTIM__MAX_EPOCH=2, OPTIM__LR_SCHEDULER="cosine", OPTIM__WARMUP_EPOCH=1,
                OPTIM__WARMUP_TYPE="constant", OPTIM__WARMUP_CONS_LR=1e-3,
                INPUT__SIZE=(32, 32), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD), DATALOADER__TRAIN_X__BATCH_SIZE=4,
                DATALOADER__TEST__BATCH_SIZE=4)
    base.update({f"TRAINER__{trainer_key}__{k}": v
                 for k, v in dict(N_CTX=4, CTX_INIT="", PREC="fp32").items()})
    return _both_cfgs(**dict(base, **kw))


def _jax_trainer(module_name, cls_name, jcfg, params, classnames):
    """A JAX trainer's model state and functions, built without its
    DataManager, on the tiny CLIP."""
    import importlib

    from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig

    mod = importlib.import_module(f"fsvlm_tpu.trainers.{module_name}")
    t = getattr(mod, cls_name).__new__(getattr(mod, cls_name))
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=classnames))
    saved = mod.load_clip_backbone
    mod.load_clip_backbone = lambda cfg: (params, JaxCLIPConfig(*TINY))
    try:
        t.build_model()
    finally:
        mod.load_clip_backbone = saved
    return t


def _port_trainer(cls, pcfg, params, classnames, **kw):
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    return cls(pcfg, classnames, clip=clip, device="cpu", **kw)


def _batch(simclr=False):
    rng = np.random.RandomState(1)
    batch = {"img": rng.randn(4, 32, 32, 3).astype(np.float32), "label": np.array([0, 3, 1, 4]),
             "valid": np.array([True, True, True, False])}
    if simclr:
        batch["img2"] = rng.randn(4, 32, 32, 3).astype(np.float32)
    return batch


def _check_loss_and_grads(jt, pt, batch):
    """Loss and aux at rtol 1e-4 / atol 1e-5; each gradient at rtol 1e-3 /
    atol 1e-6 of its largest entry (test_torch_train.py's tolerances)."""
    (loss, aux), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        jt.params, jt.frozen, batch, jax.random.PRNGKey(0))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = dict(flash_attention.LAUNCHES)
    p_loss, p_aux = pt.loss_fn(pt.params, pt.frozen, tbatch)
    p_grads = dict(zip(pt.params, torch.autograd.grad(p_loss, list(pt.params.values()))))
    assert flash_attention.LAUNCHES == before  # the CPU launches nothing
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=1e-4, atol=1e-5)
    assert sorted(p_aux) == sorted(aux)
    for k, v in aux.items():
        np.testing.assert_allclose(p_aux[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    return grads, p_grads


_COOP_CASES = {
    "ce": {},
    "focal_shots": dict(TRAINER__COOP__LOSS_TYPE="focal", DATASET__PER_CLASS_SHOTS=[1, 4, 0, 2, 8]),
    "simclr": dict(TRAINER__COOP__LOSS_TYPE="simclr"),
    "csc": dict(TRAINER__COOP__CSC=True),
    "middle": dict(TRAINER__COOP__CLASS_TOKEN_POSITION="middle"),
    "front": dict(TRAINER__COOP__CLASS_TOKEN_POSITION="front", TRAINER__COOP__CTX_INIT="a photo of a"),
}


@pytest.mark.parametrize("attn", ["default", "legacy"])
@pytest.mark.parametrize("case", sorted(_COOP_CASES))
def test_coop_loss_and_ctx_grad_match_jax(tiny_params, case, attn, monkeypatch):
    """One batch (one padded row), the same ctx init from the same seed;
    ``legacy``: FSVLM_FORCE_PALLAS=legacy in both packages."""
    if attn == "legacy":
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", "legacy")
    jcfg, pcfg = _cfgs("COOP", **_COOP_CASES[case])
    jt = _jax_trainer("coop", "CoOp", jcfg, tiny_params, CLASSNAMES)
    pt = _port_trainer(CoOp, pcfg, tiny_params, CLASSNAMES, steps_per_epoch=2)
    assert list(pt.params) == list(jt.params) == ["ctx"]
    np.testing.assert_array_equal(pt.params["ctx"].detach().numpy(), np.asarray(jt.params["ctx"]))
    grads, p_grads = _check_loss_and_grads(jt, pt, _batch(simclr=case == "simclr"))
    ref = np.asarray(grads["ctx"])
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(p_grads["ctx"].numpy(), ref, rtol=1e-3,
                               atol=1e-6 * np.abs(ref).max())


# ------------------------------------------------------------------- CoCoOp
def test_cocoop_init_equals_jax(tiny_params):
    """ctx and the meta-net (w1, b1, w2, b2, (in, out) layout) drawn from the
    shared RandomState after build_prompt_context's draws: equal to JAX's."""
    jcfg, pcfg = _cfgs("COCOOP")
    jt = _jax_trainer("cocoop", "CoCoOp", jcfg, tiny_params, CLASSNAMES)
    pt = _port_trainer(cocoop.CoCoOp, pcfg, tiny_params, CLASSNAMES, steps_per_epoch=1)
    assert list(pt.params) == ["ctx", *cocoop.META_NET_KEYS]
    np.testing.assert_array_equal(pt.params["ctx"].detach().numpy(), np.asarray(jt.params["ctx"]))
    for key in cocoop.META_NET_KEYS:
        np.testing.assert_array_equal(pt.params[key].detach().numpy(),
                                      np.asarray(jt.params["meta_net"][key.split(".")[1]]))


_COCOOP_CASES = {  # (config overrides, BATCHED_TEXT_LIMIT, FSVLM_FORCE_PALLAS, block size)
    "batched": ({}, None, None, 0),
    "chunk3_remat": (dict(TRAINER__COCOOP__CLASS_CHUNK=3, TRAIN__REMAT=True), None, None, 3),
    "auto_chunk_remat_legacy": (dict(TRAIN__REMAT=True), 12, "legacy", 3),
}


@pytest.mark.parametrize("case", sorted(_COCOOP_CASES))
def test_cocoop_loss_and_grads_match_jax(tiny_params, case, monkeypatch):
    """ctx and meta-net gradients on one batch: the batched text pass; 5
    classes in blocks of 3 (padded with the first class to 6, trimmed) with
    every block and layer rematerialized; and the automatic block past a
    BATCHED_TEXT_LIMIT of 12 (4 x 5 = 20 > 12: blocks of 12 // 4 = 3)
    under ``legacy`` in both packages."""
    import fsvlm_tpu.trainers.cocoop as jax_cocoop

    overrides, limit, force, chunk = _COCOOP_CASES[case]
    if limit is not None:
        monkeypatch.setattr(jax_cocoop, "BATCHED_TEXT_LIMIT", limit)
        monkeypatch.setattr(cocoop, "BATCHED_TEXT_LIMIT", limit)
    if force is not None:
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", force)
    jcfg, pcfg = _cfgs("COCOOP", **overrides)
    jt = _jax_trainer("cocoop", "CoCoOp", jcfg, tiny_params, CLASSNAMES)
    pt = _port_trainer(cocoop.CoCoOp, pcfg, tiny_params, CLASSNAMES, steps_per_epoch=1)
    assert pt.class_chunk_for(4) == chunk and pt.remat == pcfg.TRAIN.REMAT
    grads, p_grads = _check_loss_and_grads(jt, pt, _batch())
    for key in pt.params:
        ref = np.asarray(grads["ctx"] if key == "ctx" else grads["meta_net"][key.split(".")[1]])
        assert np.abs(ref).max() > 0, key
        np.testing.assert_allclose(p_grads[key].numpy(), ref, rtol=1e-3,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=key)


def _count_forwards(monkeypatch, family):
    """Wrap ``family``'s plain forward with a call counter."""
    fa = flash_attention
    calls = []
    fwd = fa._FAMILIES[family][0]

    def counted(*args):
        calls.append(1)
        return fwd(*args)

    monkeypatch.setitem(fa._FAMILIES, family, (counted,) + fa._FAMILIES[family][1:])
    return calls


@pytest.mark.parametrize("remat,chunk,want", [(False, 0, 4), (True, 0, 6), (False, 2, 8),
                                              (True, 2, 20)])
def test_cocoop_step_runs_the_derived_number_of_attention_forwards(tiny_params, remat, chunk,
                                                                   want, monkeypatch):
    """Under ``legacy``, one CoCoOp step on 5 classes runs the whole-sequence
    forward image_layers + text_layers * n_blocks * (1 + remat recomputes)
    times, and its backward text_layers * n_blocks times: with blocks of 2
    (3 blocks) and TRAIN.REMAT, every text layer runs three times (the
    forward, the block's recompute, the layer's recompute inside it).
    chip_smoke.py derives the full-width step's launch counts this way."""
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", "legacy")
    calls = _count_forwards(monkeypatch, "fused")
    _, pcfg = _cfgs("COCOOP", TRAIN__REMAT=remat, TRAINER__COCOOP__CLASS_CHUNK=chunk)
    pt = _port_trainer(cocoop.CoCoOp, pcfg, tiny_params, CLASSNAMES, steps_per_epoch=1)
    pt.train_step({k: v for k, v in _batch().items() if k != "valid"})
    n_blocks = 3 if chunk else 1
    assert len(calls) == want == 2 + 2 * n_blocks * (1 + (2 if chunk and remat else int(remat)))


@pytest.mark.parametrize("tower", ["text", "vision"])
def test_remat_gives_the_same_outputs_and_gradients(tiny_params, tower, monkeypatch):
    """remat=True checkpoints each layer: the outputs and the gradients to
    the tower's input equal remat=False's exactly, and each layer's attention
    forward runs twice (the recompute in the backward)."""
    clip = clip_from_params(tiny_params, CLIPConfig(*TINY), device="cpu")
    rng = np.random.RandomState(4)
    if tower == "text":
        x0 = torch.from_numpy(rng.randn(3, 16, 128).astype(np.float32))
        eot = torch.tensor([5, 9, 15])

        def run(x, remat):
            return encode_text_embeds(clip, x, eot, remat=remat)
    else:
        x0 = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))

        def run(x, remat):
            return encode_image_vit(clip, x, remat=remat)

    calls = _count_forwards(monkeypatch, "packed")
    outs = {}
    for remat in (False, True):
        calls.clear()
        x = x0.clone().requires_grad_()
        out = run(x, remat)
        outs[remat] = (out.detach(), *torch.autograd.grad(out.square().sum(), x))
        assert len(calls) == 2 * (1 + remat)
    for a, b in zip(outs[False], outs[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_encode_image_takes_the_vit_and_names_a9_for_the_resnet_towers(tiny_params):
    """encode_image takes the ViT's tower, and (ported since the RN towers
    landed) a ModifiedResNet's, dropping the ViT-only keywords as JAX
    does."""
    from fsvlm_tpu_torch.models.clip import ARCHS, encode_image, encode_image_resnet

    clip = clip_from_params(tiny_params, CLIPConfig(*TINY), device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32))
    torch.testing.assert_close(encode_image(clip, x), encode_image_vit(clip, x), rtol=0, atol=0)
    rn_cfg = ARCHS["test-tiny-rn"]
    resnet = clip_from_params(random_clip_params(rn_cfg, seed=3), rn_cfg, device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32))
    want = encode_image_resnet(resnet, x)
    assert want.shape == (2, rn_cfg.embed_dim)
    torch.testing.assert_close(encode_image(resnet, x, attn_impl="plain", remat=True), want,
                               rtol=0, atol=0)


# -------------------------------------------------------------------- test()
@pytest.mark.parametrize("trainer", ["coop", "cocoop"])
def test_test_matches_jax_logits_and_evaluator(tiny_params, trainer, tmp_path, capsys):
    """test() on a uint8 cache in batches of 4 (the last one short):
    CoOp's split eval (text features once) and CoCoOp's full logits against
    JAX's on the same normalized images (rtol 1e-4 / atol 1e-4); accuracy,
    macro-F1, the per-class results and the confusion matrix against the
    JAX evaluator on the port's logits (rtol 1e-12)."""
    from fsvlm_tpu.engine.evaluator import Classification as JaxClassification

    key = trainer.upper()
    jcfg, pcfg = _cfgs(key, TEST__PER_CLASS_RESULT=True, TEST__COMPUTE_CMAT=True)
    jcfg.OUTPUT_DIR = str(tmp_path)
    module, cls = ("coop", "CoOp") if trainer == "coop" else ("cocoop", "CoCoOp")
    jt = _jax_trainer(module, cls, jcfg, tiny_params, CLASSNAMES)
    pt = _port_trainer(CoOp if trainer == "coop" else cocoop.CoCoOp, pcfg, tiny_params,
                       CLASSNAMES, steps_per_epoch=1)
    rng = np.random.RandomState(6)
    images = rng.randint(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), 10)

    text_calls, logits = [], []
    if trainer == "coop":
        inner_txf, inner_img = pt.text_features_fn, pt.image_logits_fn
        pt.text_features_fn = lambda *a: text_calls.append(1) or inner_txf(*a)
        pt.image_logits_fn = lambda *a: logits.append(inner_img(*a)) or logits[-1]
    else:
        inner = pt.logits_fn
        pt.logits_fn = lambda *a: logits.append(inner(*a)) or logits[-1]
    acc = pt.test(images, labels)
    port_results = pt.evaluator.evaluate()
    got = torch.cat(logits).numpy()
    assert len(logits) == 3 and len(text_calls) == (trainer == "coop")

    norm = (images / np.float32(255) - np.float32(preprocess.CLIP_PIXEL_MEAN)) / np.float32(
        preprocess.CLIP_PIXEL_STD)
    norm = norm.astype(np.float32)
    if trainer == "coop":
        txf = jt.text_features_fn(jt.params, jt.frozen)
        ref = np.asarray(jt.image_logits_fn(jt.params, jt.frozen, norm, txf))
    else:
        ref = np.asarray(jt.logits_fn(jt.params, jt.frozen, norm))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    ev = JaxClassification(jcfg, lab2cname=dict(enumerate(CLASSNAMES)))
    for i in range(0, 10, 4):
        ev.process(got[i:i + 4], labels[i:i + 4])
    jax_results = ev.evaluate()
    assert acc == port_results["accuracy"] == jax_results["accuracy"]
    assert list(port_results) == list(jax_results)
    for k in jax_results:
        np.testing.assert_allclose(port_results[k], jax_results[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(pt.evaluator.cmat, np.load(tmp_path / "cmat.npy"), rtol=1e-12)
    assert "* accuracy:" in capsys.readouterr().out
    y_true, y_pred = pt.test(images, labels, return_pred=True)
    assert y_true == labels.tolist() and y_pred == got.argmax(1).tolist()


# ------------------------------------------------------------------ goldens
def _golden_clip(name):
    from test_golden_pack import _load

    from fsvlm_tpu.models.clip import clip_params_from_state_dict

    z = _load(name)
    params, jax_clip_cfg = clip_params_from_state_dict(
        {k[3:]: z[k] for k in z.files if k.startswith("sd.")})
    clip_cfg = CLIPConfig(**{f: getattr(jax_clip_cfg, f) for f in CLIPConfig.__dataclass_fields__})
    return z, clip_from_params(params, clip_cfg, device="cpu")


def _golden_cfg(n_epochs, batch, **kw):
    _, cfg = _both_cfgs(
        SEED=1, MODEL__TEXT_TRUNCATE=False, DATALOADER__TRAIN_X__BATCH_SIZE=batch,
        OPTIM__NAME="sgd", OPTIM__LR=0.05, OPTIM__MOMENTUM=0.9, OPTIM__WEIGHT_DECAY=5e-4,
        OPTIM__LR_SCHEDULER="cosine", OPTIM__MAX_EPOCH=n_epochs, OPTIM__WARMUP_EPOCH=1,
        OPTIM__WARMUP_TYPE="constant", OPTIM__WARMUP_CONS_LR=1e-3, **kw)
    return cfg


def _replay(trainer, batches, n_epochs, steps, snap):
    losses, snaps = [], []
    for ep in range(n_epochs):
        trainer.epoch = ep
        for bi in range(steps):
            imgs, labels = batches[ep * steps + bi]
            trainer.batch_idx = bi
            metrics = trainer.forward_backward({"img": imgs, "label": labels,
                                                "valid": np.ones(len(labels), bool)})
            losses.append(metrics["loss"].item())
            snaps.append(snap())
    return losses, snaps


def test_golden_coop_trajectory_replays_through_the_port():
    """tests/golden_pack/coop_trajectory.npz: 10 steps / 5 epochs of the
    reference CoOp (CE, dassl SGD, warmup + cosine), replayed through the
    port's trainer at the tolerances of tests/test_golden_pack.py:247-256."""
    from test_trajectory_parity import BATCH, N_CLS, N_EPOCHS, STEPS_PER_EPOCH, _batches

    z, clip = _golden_clip("coop_trajectory.npz")
    cfg = _golden_cfg(N_EPOCHS, BATCH, TRAINER__COOP__N_CTX=4,
                      TRAINER__COOP__CTX_INIT="a photo of a", TRAINER__COOP__PREC="fp32",
                      TRAINER__COOP__CSC=False, TRAINER__COOP__CLASS_TOKEN_POSITION="end",
                      TRAINER__COOP__LOSS_TYPE="ce")
    trainer = CoOp(cfg, [f"synthetic class {i}" for i in range(N_CLS)], clip=clip, device="cpu",
                   steps_per_epoch=STEPS_PER_EPOCH)
    losses, ctx = _replay(trainer, _batches(), N_EPOCHS, STEPS_PER_EPOCH,
                          lambda: trainer.params["ctx"].detach().numpy().copy())
    ref_losses, ref_ctx = z["losses"], z["ctx"]
    assert len(losses) == N_EPOCHS * STEPS_PER_EPOCH == len(ref_losses)
    for k in range(len(ref_losses)):
        assert abs(losses[k] - ref_losses[k]) < 5e-4 * (1 + abs(ref_losses[k])), (
            f"loss diverged at step {k}: {losses[k]} vs {ref_losses[k]}")
        np.testing.assert_allclose(ctx[k], ref_ctx[k], rtol=2e-3, atol=2e-5,
                                   err_msg=f"ctx diverged at step {k}")


def test_golden_cocoop_trajectory_replays_through_the_port():
    """tests/golden_pack/cocoop_trajectory.npz: 8 steps / 4 epochs of the
    reference CoCoOp (per-image text-encoder loops, dassl SGD), from its
    ctx and meta-net init (torch's (out, in) weights, transposed by
    meta_net_from_torch), replayed through the port's batched trainer at
    the tolerances of tests/test_cocoop_trajectory_parity.py:225-238."""
    from test_cocoop_trajectory_parity import (
        BATCH,
        CLASSNAMES as COCOOP_CLASSNAMES,
        N_EPOCHS,
        STEPS_PER_EPOCH,
        _assert_cocoop_match,
        _cocoop_batches,
    )

    z, clip = _golden_clip("cocoop_trajectory.npz")
    cfg = _golden_cfg(N_EPOCHS, BATCH, INPUT__SIZE=(32, 32), TRAINER__COCOOP__N_CTX=4,
                      TRAINER__COCOOP__CTX_INIT="a photo of a", TRAINER__COCOOP__PREC="fp32")
    trainer = cocoop.CoCoOp(cfg, COCOOP_CLASSNAMES, clip=clip, device="cpu",
                            steps_per_epoch=STEPS_PER_EPOCH)
    np.testing.assert_allclose(trainer.params["ctx"].detach().numpy(), z["init_ctx"], rtol=1e-6,
                               atol=1e-6)
    init = cocoop.meta_net_from_torch({"linear1.weight": z["init_w1"], "linear1.bias": z["init_b1"],
                                       "linear2.weight": z["init_w2"], "linear2.bias": z["init_b2"]})
    with torch.no_grad():  # in place: the optimizer holds these tensors
        for key, value in init.items():
            trainer.params[key].copy_(value)

    def snap():
        p = {k: v.detach().numpy().copy() for k, v in trainer.params.items()}
        return {"ctx": p["ctx"], "w1": p["meta_net.w1"].T, "w2": p["meta_net.w2"].T}

    losses, snaps = _replay(trainer, _cocoop_batches(), N_EPOCHS, STEPS_PER_EPOCH, snap)
    ref_snaps = [{"ctx": z["ctx"][k], "w1": z["w1"][k], "w2": z["w2"][k]}
                 for k in range(len(z["losses"]))]
    _assert_cocoop_match(losses, snaps, z["losses"], ref_snaps)
