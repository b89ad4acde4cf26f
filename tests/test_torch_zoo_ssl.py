"""The port's SSL zoo against the JAX package's, on the CPU.

- wide_resnet_28_2 and wide_resnet_16_4: the same seed draws the JAX
  package's weights and statistics bit for bit; the eval forward, and the
  train forward, its new BatchNorm statistics and the input gradient of a
  random cotangent, in float32 (JAX's float32 train forward and input
  gradient sit within 2.7e-6 of its float64 ones here, measured);
- SupBaseline, EntMin, MeanTeacher, MixMatch (K = 2) and FixMatch built by
  both packages on SyntheticDA (target d2) with wide_resnet_28_2 at 8x8
  (the blocks and statistics of the 32x32 net at a sixteenth of its cost)
  and an MLP head with BatchNorm: the initial weights, statistics and
  MeanTeacher's teacher equal, then N_STEPS steps, each from the JAX
  trainer's state (weights, statistics, momentum, step count, ``extra``),
  held to the JAX step at test_torch_zoo_trainers.py's limits (metrics,
  every weight, statistic and momentum, the teacher); MixMatch's
  permutation and two Beta draws are JAX's, handed in through ``Replay``.
  The batches (24 labeled, 8 unlabeled) are multiples of the JAX package's
  8 CPU devices, so that its mesh pads no row into its statistics;
- MeanTeacher's teacher and its statistics over 3 steps of the port alone
  against JAX's 3 steps (the EMA weight and the epoch ramp at steps 0-2);
- FixMatch's mask and metrics on a batch whose probabilities are set so
  that rows fall on both sides of CONF_THRE, with pad rows.

The JAX trainers are built once per trainer for the file (the
``jax_trainers`` fixture): its jitted step compiles once; each test sets
the port's state from it.
"""

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.models.backbones import build_backbone
from fsvlm_tpu_torch.models.convert import flatten, load_state, params_tree, state_tree, zoo_trees
from fsvlm_tpu_torch.models.draws import Replay
from test_torch_zoo_da_trainers import _cfgs, _extra_trees, _sync
from test_torch_zoo_trainers import METRIC_TOL, WEIGHT_ATOL, _assert_trees, _traces

N_STEPS, N_CLS, K = 2, 4, 2
WRN = {"MODEL.BACKBONE.NAME": "wide_resnet_28_2", "INPUT.SIZE": (8, 8)}
CASES = {
    "SupBaseline": {},
    "EntMin": {},
    "MeanTeacher": {"TRAINER.MEANTEACHER.RAMPUP": 2},
    # MixMatch at a tenth of the others' learning rate: its WEIGHT_U (100)
    # scales the u term's gradient a hundredfold, and with it JAX's float32
    # rounding (measured from JAX's state at step 1, one thread, lr 0.01: JAX's
    # float32 weights 2.9e-5 from a float64 port step, the port's 9.9e-6)
    "MixMatch": {"DATALOADER.K_TRANSFORMS": K, "TRAINER.MIXMATCH.RAMPUP": 2, "OPTIM.LR": 0.001},
    "FixMatch": {"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("normalize",),
                 "TRAINER.FIXMATCH.CONF_THRE": 0.3},
}
# name: (input size, batch)
WRN_CASES = {"wide_resnet_28_2": (16, 4), "wide_resnet_16_4": (16, 4)}
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # pragma: no cover
        threadpool_limits = None
    if threadpool_limits is None:
        yield
    else:
        with threadpool_limits(1):
            yield
    torch.set_num_threads(threads)


def rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max(initial=0.0)) / max(float(np.abs(ref).max(initial=0.0)),
                                                            1e-30)


@pytest.mark.parametrize("name", list(WRN_CASES))
def test_wide_resnet_matches_jax(name):
    import jax
    import jax.numpy as jnp

    from fsvlm_tpu.models.backbones import build_backbone as jax_build

    size, B = WRN_CASES[name]
    jb, pb = jax_build(name, seed=3), build_backbone(name, seed=3)
    assert pb.out_features == jb.out_features
    ref, mine = flatten(jax.tree.map(np.asarray, jb.params)), flatten(params_tree(pb))
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=f"{name} init {k}")
    state = jax.tree.map(np.asarray, jb.state)
    init = flatten(state_tree(pb.init_state()))
    assert set(init) == set(flatten(state))
    for k, v in flatten(state).items():
        np.testing.assert_array_equal(init[k], v, err_msg=f"{name} init state {k}")

    x = np.random.RandomState(0).randn(B, size, size, 3).astype(np.float32)
    f_eval = jax.jit(lambda p, xx: jb.apply(p, state, xx, train=False)[0])(jb.params, x)
    got, _ = pb(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), load_state(state, "cpu"))
    assert rel(got.detach(), f_eval) <= FWD_TOL, name

    g = np.random.RandomState(1).randn(*f_eval.shape).astype(np.float32)

    @jax.jit
    def train_vjp(p, s, xx, gg):
        (f, ns), vjp = jax.vjp(lambda v: jb.apply(p, s, v, train=True), xx)
        return f, ns, vjp((gg, jax.tree.map(jnp.zeros_like, ns)))[0]

    f_ref, ns_ref, gx_ref = jax.tree.map(np.asarray, train_vjp(jb.params, state, x, g))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    f_port, ns_port = pb(xt, load_state(state, "cpu"), train=True)
    (gx,) = torch.autograd.grad(f_port, xt, torch.from_numpy(g))
    assert rel(f_port.detach(), f_ref) <= GRAD_TOL, f"{name} train forward"
    assert rel(gx.permute(0, 2, 3, 1), gx_ref) <= GRAD_TOL, f"{name} input gradient"
    new, want = flatten(state_tree(ns_port)), flatten(ns_ref)
    assert set(new) == set(want)
    for k, v in want.items():
        std = np.sqrt(np.abs(want[k[:-4] + "var"])).max() if k.endswith("mean") else np.abs(v).max()
        assert np.abs(new[k] - v).max() <= GRAD_TOL * max(std, 1e-30), f"{name} statistics {k}"


def _batches(name, seed=11, size=8, n_steps=N_STEPS):
    rng = np.random.RandomState(seed)
    bx_n, bu_n = 24, 8
    views = K if name == "MixMatch" else 1

    def img(n):
        a = rng.randn(n, views, size, size, 3).astype(np.float32)
        return a if views > 1 else a[:, 0]

    out = []
    for _ in range(n_steps):
        bx = {"img": img(bx_n), "label": rng.randint(0, N_CLS, bx_n).astype(np.int32),
              "domain": rng.randint(0, 2, bx_n).astype(np.int32),
              "index": np.arange(bx_n, dtype=np.int32), "valid": np.ones(bx_n, bool)}
        bu = {"img": img(bu_n), "label": rng.randint(0, N_CLS, bu_n).astype(np.int32),
              "domain": np.zeros(bu_n, np.int32), "index": np.arange(bu_n, dtype=np.int32),
              "valid": np.ones(bu_n, bool)}
        if name == "FixMatch":
            bx["img2"], bu["img2"] = img(bx_n), img(bu_n)
        out.append((bx, bu))
    return out


def mixmatch_draws(key, beta, bx, bu, k=K):
    """The permutation and the two Beta draws of the JAX MixMatch step at
    ``key`` (ssl.py:197-205), in the port's order."""
    import jax

    k_perm, k_mix1, k_mix2 = jax.random.split(key, 3)
    return [np.asarray(jax.random.permutation(k_perm, bx + k * bu)),
            np.asarray(jax.random.beta(k_mix1, beta, beta, shape=(bx,))),
            np.asarray(jax.random.beta(k_mix2, beta, beta, shape=(k * bu,)))]


@pytest.fixture(scope="module")
def jax_trainers():
    """Trainer name -> the JAX trainer, built once for the file."""
    return {}


def _build(jax_trainers, tmp_path, name, fresh=False):
    """(the file's JAX trainer of ``name``, built anew with ``fresh``; a new
    port trainer of the same config)."""
    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    import fsvlm_tpu.trainers  # noqa: F401

    jcfg, pcfg = _cfgs(tmp_path, name, {**WRN, **CASES[name]})
    if fresh or name not in jax_trainers:
        jax_trainers[name] = jax_build_trainer(jcfg)
    return jax_trainers[name], build_trainer(pcfg, device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_ssl_trainer_steps_match_jax(jax_trainers, tmp_path, name):
    import jax

    from fsvlm_tpu.parallel.mesh import shard_batch

    jt, pt = _build(jax_trainers, tmp_path, name, fresh=True)  # at its initial state
    assert set(pt.nets) == set(jt.params) and pt.steps_per_epoch == jt.steps_per_epoch
    params, state = zoo_trees(pt)
    _assert_trees(params, jax.tree.map(np.asarray, jt.params), f"{name} init weights")
    _assert_trees(state, jax.tree.map(np.asarray, jt.model_state), f"{name} init state")
    _assert_trees(_extra_trees(pt), jax.tree.map(np.asarray, jt.extra), f"{name} init extra")

    beta = float(pt.cfg.TRAINER.MIXMATCH.MIXUP_BETA)
    for step, (bx, bu) in enumerate(_batches(name)):
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        _sync(pt, jt)
        jt.params, jt.opt_state, jt.model_state, jt.extra, jm = jt._train_step_xu(
            jt.params, jt.opt_state, jt.model_state, jt.extra, shard_batch(bx, jt.mesh),
            shard_batch(bu, jt.mesh), key, np.asarray(step, np.int32))
        pt.epoch, pt.batch_idx = divmod(step, pt.steps_per_epoch)
        draws = mixmatch_draws(key, beta, 24, 8) if name == "MixMatch" else []
        replay = Replay(draws, "cpu")
        pm = pt.train_step(bx, draws=replay, batch_u=bu)
        assert replay.used == len(draws)
        assert set(pm) == set(jm)
        for k in jm:
            ref = float(jm[k])
            assert abs(float(pm[k]) - ref) <= METRIC_TOL * (1 + abs(ref)), (
                name, step, k, float(pm[k]), ref)
        params, state = zoo_trees(pt)
        _assert_trees(params, jax.tree.map(np.asarray, jt.params), f"{name} step {step}")
        _assert_trees(state, jax.tree.map(np.asarray, jt.model_state), f"{name} step {step}")
        _assert_trees(_extra_trees(pt), jax.tree.map(np.asarray, jt.extra),
                      f"{name} step {step} extra")
        _assert_trees(*_traces(pt, jt), f"{name} step {step} momentum",
                      WEIGHT_ATOL / float(pt.cfg.OPTIM.LR))


def test_mean_teacher_teacher_over_three_steps(jax_trainers, tmp_path):
    """The port's own 3 steps (no state taken from JAX between them): the
    teacher's weights and statistics and the student's against JAX's."""
    import jax

    from fsvlm_tpu.parallel.mesh import shard_batch

    jt, pt = _build(jax_trainers, tmp_path, "MeanTeacher")
    _sync(pt, jt)
    for step, (bx, bu) in enumerate(_batches("MeanTeacher", seed=5, n_steps=3)):
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        jt.params, jt.opt_state, jt.model_state, jt.extra, jm = jt._train_step_xu(
            jt.params, jt.opt_state, jt.model_state, jt.extra, shard_batch(bx, jt.mesh),
            shard_batch(bu, jt.mesh), key, np.asarray(step, np.int32))
        pt.epoch, pt.batch_idx = divmod(step, pt.steps_per_epoch)
        pm = pt.train_step(bx, draws=Replay([], "cpu"), batch_u=bu)
        for k in ("loss_x", "loss_u"):
            assert abs(float(pm[k]) - float(jm[k])) <= 1e-4 * (1 + abs(float(jm[k]))), (step, k)
    extra = jax.tree.map(np.asarray, jt.extra)
    _assert_trees(params_tree(pt.extra_nets["teacher"]), extra["teacher"], "teacher")
    _assert_trees(state_tree(pt.extra["teacher_state"]), extra["teacher_state"], "teacher state")
    _assert_trees(zoo_trees(pt)[0], jax.tree.map(np.asarray, jt.params), "student")


def test_fixmatch_mask_and_metrics_match_jax(jax_trainers, tmp_path):
    """A weak pass whose classifier is scaled, by the first factor that does
    so, until the top probabilities spread across CONF_THRE (some rows kept,
    some not); the batches end in pad rows (valid False)."""
    import jax
    import jax.numpy as jnp

    from fsvlm_tpu.parallel.mesh import shard_batch

    jt, pt = _build(jax_trainers, tmp_path, "FixMatch")  # CONF_THRE 0.3
    base = jax.tree.map(np.asarray, jt.params)
    (bx, bu), = _batches("FixMatch", seed=7)[:1]
    bx["valid"][-8:] = False
    bu["valid"][-3:] = False
    for scale in (1.0, 2.0, 3.0, 5.0, 8.0, 0.5):
        params = jax.tree.map(jnp.asarray, base)
        params["net"]["classifier"]["w"] = jnp.asarray(base["net"]["classifier"]["w"] * scale)
        jt.params = params
        _sync(pt, jt)
        jt.params, jt.opt_state, jt.model_state, jt.extra, jm = jt._train_step_xu(
            jt.params, jt.opt_state, jt.model_state, jt.extra, shard_batch(bx, jt.mesh),
            shard_batch(bu, jt.mesh), jax.random.PRNGKey(3), np.asarray(0, np.int32))
        keep = float(jm["y_u_pred_keep"])
        if 0.0 < keep < 1.0:  # rows on both sides of the threshold
            break
    else:
        pytest.fail(f"no scale put rows on both sides of CONF_THRE (keep {keep})")
    pm = pt.train_step(bx, draws=Replay([], "cpu"), batch_u=bu)
    for k in ("y_u_pred_acc_raw", "y_u_pred_acc_thre", "y_u_pred_keep", "loss_u", "loss_x"):
        assert abs(float(pm[k]) - float(jm[k])) <= METRIC_TOL * (1 + abs(float(jm[k]))), k
