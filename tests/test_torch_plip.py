"""The port's PLIP trainer and its twice-differentiable layers against the JAX
package, on the CPU.

- LayerNorm and QuickGELU second derivatives: the gradient of <dx, u> (dx
  the backward of <f(x), g>) with respect to x, g and LayerNorm's scale,
  against JAX's reverse-over-reverse of ``fsvlm_tpu.ops.layers``, for x in
  fp32 and bf16; LayerNorm's first-order outputs and gradients bit-equal
  to the formula of its saved statistics (the path every other trainer
  runs);
- PLIP's init (svd's U, S, Vh equal to JAX's), loss, penalty, accuracy and
  the gradient of ctx (or S) on one batch in all three REG_TYPEs, against
  jax.value_and_grad of the JAX loss_fn (spectral_norm with JAX's start
  vector handed in), with FSVLM_FORCE_PALLAS unset and set (the gradient
  penalty's text tower takes the reference route whatever it says);
- a 3-step grad-mode trajectory against JAX's optimizer steps;
- the penalty's gradient against a central finite difference;
- PLIP through ``build_trainer``, its split eval, and its checkpoints
  read by the JAX package and the reverse.

fp32 unless stated, on the tiny CLIP of tests/test_torch_train.py (d = 64
in both towers); each test states its tolerance.
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
from fsvlm_tpu.ops import layers as jax_layers
from fsvlm_tpu_torch.config import get_cfg_default
from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.models.clip import CLIPConfig, random_clip_params
from fsvlm_tpu_torch.ops import flash_attention, layers, preprocess
from fsvlm_tpu_torch.trainers.backbone import clip_from_params
from fsvlm_tpu_torch.trainers.plip import PLIP

TINY = (64, 32, 2, 128, 16, 77, 49408, 128, 2, 2)  # d = 64 in both towers
CLASSNAMES = ["cat", "golden_retriever", "aircraft carrier", "sea", "Ferrari 250 GTO"]
REG_TYPES = ["grad", "svd", "spectral_norm"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------- second derivatives
def _second_order_torch(fn, x, g, u, extra=()):
    """d<dx, u>/d(x, g, *extra), dx the backward of <fn(x, *extra), g>."""
    x = x.clone().requires_grad_()
    g = g.clone().requires_grad_()
    extra = [e.clone().requires_grad_() for e in extra]
    dx, = torch.autograd.grad(fn(x, *extra), x, g, create_graph=True)
    return torch.autograd.grad((dx.float() * u).sum(), [x, g, *extra])


def _second_order_jax(fn, x, g, u, extra=()):
    def inner(x, g, *extra):
        _, vjp = jax.vjp(lambda x_: fn(x_, *extra), x)
        return jnp.sum(vjp(g)[0].astype(jnp.float32) * u)

    return jax.grad(inner, argnums=tuple(range(2 + len(extra))))(x, g, *extra)


# (dtype, rtol, atol as a fraction of the reference's largest entry): fp32
# differs by the order of sums; in bf16 x, g and the cast-back dx round
# to 8 bits, and the two packages' rounding points differ by one ulp here
# and there
_SECOND_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["layer_norm", "quick_gelu"])
def test_second_derivatives_match_jax(op, dtype):
    rng = np.random.RandomState(7)
    shape = (3, 5, 48)
    x, g = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    u = rng.randn(*shape).astype(np.float32)
    extra = ()
    if op == "layer_norm":
        extra = (1.0 + 0.3 * rng.randn(48).astype(np.float32),)
        bias = 0.1 * rng.randn(48).astype(np.float32)
        t_fn = lambda x_, s: layers.layer_norm(x_, s, torch.from_numpy(bias))  # noqa: E731
        j_fn = lambda x_, s: jax_layers.layer_norm(x_, s, jnp.asarray(bias))  # noqa: E731
    else:
        t_fn, j_fn = layers.quick_gelu, jax_layers.quick_gelu
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = _second_order_torch(t_fn, torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
                              torch.from_numpy(u), [torch.from_numpy(e) for e in extra])
    ref = _second_order_jax(j_fn, jnp.asarray(x, jdt), jnp.asarray(g, jdt), jnp.asarray(u),
                            [jnp.asarray(e) for e in extra])
    rtol, atol = _SECOND_TOL[dtype]
    for name, a, b in zip(("x", "g", "scale"), got, ref):
        b = np.asarray(b, np.float32)
        assert a.dtype == tdt or name == "scale"
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol, atol=atol * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_first_order_is_the_saved_statistics_formula(dtype):
    """Outside create_graph the backward reads the forward's saved mean and
    rstd, as before it became twice differentiable: outputs and gradients
    bit-equal to that formula."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 7, 32, generator=gen).to(dtype).requires_grad_()
    scale = (1 + 0.2 * torch.randn(32, generator=gen)).requires_grad_()
    bias = (0.1 * torch.randn(32, generator=gen)).requires_grad_()
    g = torch.randn(4, 7, 32, generator=gen).to(dtype)
    y = layers.layer_norm(x, scale, bias)
    dx, dscale, dbias = torch.autograd.grad(y, [x, scale, bias], g)
    y_ref, mean, rstd = torch.native_layer_norm(x.detach().float(), (32,), scale.detach(),
                                                bias.detach(), 1e-5)
    xhat = (x.detach().float() - mean) * rstd
    dxhat = g.float() * scale.detach()
    want = (rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(-1, keepdim=True))).to(dtype)
    assert torch.equal(y, y_ref.to(dtype)) and torch.equal(dx, want)
    assert torch.equal(dscale, (g.float() * xhat).sum(dim=(0, 1)))
    assert torch.equal(dbias, g.float().sum(dim=(0, 1)))


# -------------------------------------------------------------------- PLIP
def _set(cfg, **kw):
    for path, value in kw.items():
        *parents, leaf = path.split("__")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    return cfg


def _cfgs(reg_type="grad", **kw):
    base = dict(SEED=2, OPTIM__NAME="sgd", OPTIM__LR=0.05, OPTIM__MAX_EPOCH=2,
                OPTIM__LR_SCHEDULER="cosine", OPTIM__WARMUP_EPOCH=1,
                OPTIM__WARMUP_TYPE="constant", OPTIM__WARMUP_CONS_LR=0.02,
                INPUT__SIZE=(32, 32), INPUT__PIXEL_MEAN=list(preprocess.CLIP_PIXEL_MEAN),
                INPUT__PIXEL_STD=list(preprocess.CLIP_PIXEL_STD),
                DATALOADER__TRAIN_X__BATCH_SIZE=4, DATASET__NAME="Synthetic",
                MODEL__BACKBONE__NAME="test-tiny", TRAINER__PLIP__PREC="fp32",
                TRAINER__PLIP__REG_TYPE=reg_type, TRAINER__PLIP__REG_COEFF=0.5,
                TRAINER__PLIP__K=2)
    base.update(kw)
    return _set(jax_get_cfg_default(), **base), _set(get_cfg_default(), **base)


@pytest.fixture(scope="module")
def tiny_params():
    return random_clip_params(CLIPConfig(*TINY), seed=3)


def _jax_plip(jcfg, params):
    """The JAX PLIP's state and functions, built without its DataManager."""
    import fsvlm_tpu.trainers.plip as jax_plip
    from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig

    t = jax_plip.PLIP.__new__(jax_plip.PLIP)
    t.cfg = jcfg
    t.dm = types.SimpleNamespace(dataset=types.SimpleNamespace(classnames=CLASSNAMES))
    saved = jax_plip.load_clip_backbone
    jax_plip.load_clip_backbone = lambda cfg: (params, JaxCLIPConfig(*TINY))
    try:
        t.build_model()
    finally:
        jax_plip.load_clip_backbone = saved
    return t


def _port_plip(pcfg, params, **kw):
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    return PLIP(pcfg, CLASSNAMES, clip=clip, device="cpu", steps_per_epoch=2, **kw)


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(4, 32, 32, 3).astype(np.float32), "label": np.array([0, 3, 1, 4]),
            "valid": np.array([True, True, True, False])}


def _jax_start(key, dim):
    """JAX's spectral_norm start vector for the step key (plip.py:119)."""
    return np.array(jax.random.normal(key, (dim,), jnp.float32))


@pytest.mark.parametrize("force", [None, "1"], ids=["unset", "force1"])
@pytest.mark.parametrize("reg_type", REG_TYPES)
def test_plip_loss_penalty_and_grads_match_jax(tiny_params, reg_type, force, monkeypatch):
    """One batch (one padded row): the loss and the penalty at rtol 1e-4 /
    atol 1e-5, the accuracy exactly; the gradient of ctx (S under svd) at
    rtol 1e-3 / atol 1e-6 of its largest entry, which must not be 0.  Under
    FSVLM_FORCE_PALLAS=1 JAX's grad mode is left unset (its Pallas kernels
    are first order; the port's text tower takes the reference route
    whatever the variable says) and the port's other towers take the
    blockwise family."""
    jcfg, pcfg = _cfgs(reg_type)
    jt = _jax_plip(jcfg, tiny_params)
    if force:
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", force)
    pt = _port_plip(pcfg, tiny_params)
    assert list(pt.params) == list(jt.params) == (["S"] if reg_type == "svd" else ["ctx"])
    for k in jt.params:
        np.testing.assert_array_equal(pt.params[k].detach().numpy(), np.asarray(jt.params[k]))
    if reg_type == "svd":
        for k in ("U", "Vh"):
            np.testing.assert_array_equal(pt.frozen[k].numpy(), np.asarray(jt.frozen[k]))
    batch = _batch()
    key = jax.random.PRNGKey(11)
    monkeypatch.delenv("FSVLM_FORCE_PALLAS", raising=False)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        jt.params, jt.frozen, batch, key)
    if force:
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", force)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["v0"] = torch.from_numpy(_jax_start(key, pt.frozen["base_embed"].shape[-1]))
    p_loss, p_aux = pt.loss_fn(pt.params, pt.frozen, tbatch)
    p_grads = dict(zip(pt.params, torch.autograd.grad(p_loss, list(pt.params.values()))))
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p_aux["penalty"].item(), float(aux["penalty"]), rtol=1e-4,
                               atol=1e-5)
    assert p_aux["acc"].item() == float(aux["acc"])
    assert (float(aux["penalty"]) == 0.0) == (reg_type == "svd")
    for k, g in grads.items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(p_grads[k].numpy(), g, rtol=1e-3, atol=1e-6 * np.abs(g).max(),
                                   err_msg=k)


def test_plip_grad_penalty_is_second_order(tiny_params):
    """The penalty's own gradient is nonzero, and along a fixed direction
    it equals a central finite difference of the penalty within 1e-2
    relative (the second-order term is live; fp32, step 1e-3)."""
    _, pcfg = _cfgs("grad")
    pt = _port_plip(pcfg, tiny_params)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ctx = pt.params["ctx"]
    direction = torch.from_numpy(np.random.RandomState(4).randn(*ctx.shape).astype(np.float32))
    direction /= direction.norm()

    def penalty(c):
        return pt.loss_fn({"ctx": c}, pt.frozen, batch)[1]["penalty"]

    grad, = torch.autograd.grad(penalty(ctx), ctx)
    eps = 1e-3
    with torch.no_grad():
        c_plus, c_minus = ctx + eps * direction, ctx - eps * direction
    fd = (penalty(c_plus.requires_grad_()).item()
          - penalty(c_minus.requires_grad_()).item()) / (2 * eps)
    analytic = (grad * direction).sum().item()
    assert grad.abs().max() > 0
    assert abs(analytic - fd) <= 1e-2 * abs(fd), (analytic, fd)


def test_plip_grad_trajectory_matches_jax(tiny_params):
    """3 steps of grad mode (warmup LR, then the cosine's first) on fixed
    float batches through the port's train_step and JAX's value_and_grad +
    optax: the loss and penalty per step within 1e-4 * (1 + |x|), ctx after
    each step at rtol 1e-3 / atol 1e-6 of its largest entry, and moved; no
    kernel launched on the CPU."""
    import optax

    jcfg, pcfg = _cfgs("grad")
    jt, pt = _jax_plip(jcfg, tiny_params), _port_plip(pcfg, tiny_params)
    tx, _ = jax_optim.build_optimizer(jcfg, steps_per_epoch=2)

    @jax.jit
    def jax_step(params, opt_state, batch):
        (loss, aux), grads = jax.value_and_grad(jt.loss_fn, has_aux=True)(
            params, jt.frozen, batch, jax.random.PRNGKey(0))
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, aux["penalty"]

    params, opt_state = jt.params, tx.init(jt.params)
    before = dict(flash_attention.LAUNCHES)
    for step in range(3):
        pt.epoch, pt.batch_idx = step // 2, step % 2
        batch = _batch(20 + step)
        params, opt_state, loss, penalty = jax_step(params, opt_state, batch)
        metrics = pt.train_step(batch)
        for name, ref in (("loss", loss), ("penalty", penalty)):
            assert abs(metrics[name].item() - float(ref)) <= 1e-4 * (1 + abs(float(ref))), \
                (name, step)
        ref = np.asarray(params["ctx"])
        np.testing.assert_allclose(pt.params["ctx"].detach().numpy(), ref, rtol=1e-3,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=f"ctx at step {step}")
    assert not np.array_equal(ref, np.asarray(jt.params["ctx"]))
    assert flash_attention.LAUNCHES == before


def test_plip_split_eval_matches_jax(tiny_params):
    """test()'s split eval: the class text features and the image logits
    against JAX's text_features_fn / image_logits_fn at rtol 1e-4 / atol
    1e-5, and their product the full logits_fn's."""
    jcfg, pcfg = _cfgs("svd")
    jt, pt = _jax_plip(jcfg, tiny_params), _port_plip(pcfg, tiny_params)
    images = _batch()["img"]
    txf_ref = np.asarray(jt.text_features_fn(jt.params, jt.frozen))
    logits_ref = np.asarray(jt.image_logits_fn(jt.params, jt.frozen, images, txf_ref))
    with torch.no_grad():
        txf = pt.text_features_fn(pt.params, pt.frozen)
        logits = pt.image_logits_fn(pt.params, pt.frozen, torch.from_numpy(images), txf)
        full = pt.logits_fn(pt.params, pt.frozen, torch.from_numpy(images))
    np.testing.assert_allclose(txf.numpy(), txf_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), logits_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(full.numpy(), logits.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reg_type", REG_TYPES)
def test_plip_builds_and_checkpoints_both_ways(tmp_path, reg_type):
    """build_trainer("PLIP") on the synthetic dataset trains a step; its
    checkpoint loads into the JAX package's PLIP and a JAX-written one into
    the port's (ctx or S equal exactly)."""
    from fsvlm_tpu.engine.trainer import build_trainer as jax_build_trainer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opts = dict(TRAINER__NAME="PLIP", DATASET__NAME="Synthetic", DATASET__NUM_SHOTS=2,
                DATALOADER__DEVICE_AUG=True, DATALOADER__NUM_WORKERS=1,
                DATASET__ROOT=str(tmp_path), OPTIM__MAX_EPOCH=1)
    jcfg, pcfg = _cfgs(reg_type, OUTPUT_DIR=str(tmp_path / "port"), **opts)
    jcfg.OUTPUT_DIR = str(tmp_path / "jax")
    jcfg.merge_from_file(os.path.join(root, "configs/datasets/synthetic.yaml"))
    pcfg.merge_from_file(os.path.join(root, "configs/datasets/synthetic.yaml"))
    pt = build_trainer(pcfg, device="cpu")
    assert type(pt).__name__ == "PLIP" and pt.reg_type == reg_type
    assert np.isfinite(pt.run_epoch()[0]["loss"])
    pt.save_model(0, pcfg.OUTPUT_DIR)
    jt = jax_build_trainer(jcfg)
    (name,) = jt.params
    jt.load_model(pcfg.OUTPUT_DIR, epoch=1)
    np.testing.assert_array_equal(np.asarray(jt.params[name]), pt.params[name].detach().numpy())
    with torch.no_grad():
        pt.params[name].mul_(0.5)
    jt.save_model(0, jcfg.OUTPUT_DIR)
    pt.load_model(jcfg.OUTPUT_DIR, epoch=1)
    np.testing.assert_array_equal(pt.params[name].detach().numpy(), np.asarray(jt.params[name]))
