"""The port's adam, amsgrad, adamw, rmsprop and radam
(fsvlm_tpu_torch/engine/optim.py) against the JAX package's optax chains
(``fsvlm_tpu.engine.optim.build_optimizer``), on the CPU in fp32.

- 12 steps of the same numpy parameters and gradients through both, under
  the same warmup + cosine schedule, at WEIGHT_DECAY 0 and 5e-4 (rmsprop
  also at MOMENTUM 0 and 0.9), with one non-finite step, or nine in a row
  (the 9th is applied anyway: apply_if_finite(..., 8)).  radam rectifies
  from the 6th applied step on, so 12 steps reach both of its branches.
  Tolerance: per tensor, the largest difference at most 1e-6 of the
  tensor's largest magnitude (fp32; the two compute the same expressions
  and differ by the rounding of pow, sqrt, rsqrt and division, which a
  momentum trace's cancellations make large against a small element).  The
  optimizer's moment buffers are held to optax's state leaves too, and the
  step counts exactly.
- ``state_dict`` / ``load_state_dict``: 3 steps, a round trip into a fresh
  optimizer, then 3 more steps on both: bitwise equal; another
  optimizer's state is refused, and the trainer's resume says so and
  restarts the moments.
- OPTIM.ADAM_BETA1 / ADAM_BETA2 / RMSPROP_ALPHA are read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.engine import optim as jax_optim
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine import optim

NAMES = ["adam", "amsgrad", "adamw", "rmsprop", "radam"]
N_STEPS = 12
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both_cfgs(**optim_kw):
    jcfg, pcfg = jax_get_cfg_default(), get_cfg_base()
    base = dict(LR=0.01, MAX_EPOCH=4, LR_SCHEDULER="cosine", WARMUP_EPOCH=1,
                WARMUP_TYPE="constant", WARMUP_CONS_LR=1e-3)
    opts = [x for k, v in {**base, **optim_kw}.items() for x in (f"OPTIM.{k}", v)]
    jcfg.merge_from_list(opts)
    pcfg.merge_from_list(opts)
    return jcfg, pcfg


def _init(seed=0):
    rng = np.random.RandomState(seed)
    return rng, {"a": rng.randn(4, 8).astype(np.float32), "b": rng.randn(3).astype(np.float32)}


def _grads(rng, init, bad):
    g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
    if bad:
        g["b"][1] = np.inf
    return g


def _assert_close(got, ref, msg):
    """max |got - ref| <= RTOL * max |ref| over ref's finite entries; the
    others (inf, NaN after the 9th non-finite step) equal."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    assert np.array_equal(got[~fin], ref[~fin], equal_nan=True), msg
    if fin.any():
        err = np.max(np.abs(got[fin] - ref[fin]))
        assert err <= RTOL * np.max(np.abs(ref[fin])), (msg, err)


def _optax_buffers(state):
    """{buffer name: {param: array}} from the optax chain's state leaves
    (apply_if_finite's inner chain): mu/nu (and nu_max) of the adam family
    and radam, nu (and the momentum trace) of rmsprop."""
    out = {}
    for s in state.inner_state:
        if isinstance(s, dict) and "nu_max" in s:  # the JAX package's amsgrad
            out.update(mu=s["mu"], nu=s["nu"], nu_max=s["nu_max"])
        elif hasattr(s, "mu"):
            out.update(mu=s.mu, nu=s.nu)
        elif hasattr(s, "nu"):
            out["nu"] = s.nu
        elif hasattr(s, "trace"):
            out["trace"] = s.trace
    return out


CASES = [(n, wd, 0.9) for n in NAMES for wd in (0.0, 5e-4)] + [("rmsprop", 5e-4, 0.0),
                                                               ("rmsprop", 0.0, 0.0)]


@pytest.mark.parametrize("bad_steps", [(4,), tuple(range(2, 11))], ids=["one_inf", "nine_in_a_row"])
@pytest.mark.parametrize("name,wd,momentum", CASES,
                         ids=[f"{n}-wd{wd:g}-m{m:g}" for n, wd, m in CASES])
def test_optimizer_matches_the_optax_chain(name, wd, momentum, bad_steps):
    jcfg, pcfg = _both_cfgs(NAME=name, WEIGHT_DECAY=wd, MOMENTUM=momentum)
    rng, init = _init()
    tx, _ = jax_optim.build_optimizer(jcfg, steps_per_epoch=3)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt, _ = optim.build_optimizer(pcfg, params.values(), steps_per_epoch=3)
    assert opt.name == name
    for step in range(N_STEPS):
        grads = _grads(rng, init, step in bad_steps)
        updates, state = update({k: jnp.asarray(g) for k, g in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in params])
        for k in params:
            _assert_close(params[k].numpy(), jparams[k], f"{name} {k} at step {step}")
        ref = _optax_buffers(state)
        assert set(ref) == set(opt.buffers), (set(ref), opt.buffers)
        for b in opt.buffers:
            for i, k in enumerate(params):
                _assert_close(getattr(opt, b)[i].numpy(), ref[b][k], f"{name} {b}[{k}] at {step}")
        assert int(opt.notfinite_count) == int(state.notfinite_count)
    applied = N_STEPS - len(bad_steps) + (1 if len(bad_steps) > 8 else 0)
    assert int(opt.count) == applied


def _stepped(name, steps, rng, init, opt=None, params=None):
    _, pcfg = _both_cfgs(NAME=name, WEIGHT_DECAY=5e-4, MOMENTUM=0.9)
    if opt is None:
        params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
        opt, _ = optim.build_optimizer(pcfg, params.values(), steps_per_epoch=3)
    for _ in range(steps):
        opt.step([torch.from_numpy(g) for g in _grads(rng, init, False).values()])
    return opt, params


@pytest.mark.parametrize("name", NAMES + ["sgd"])
def test_state_dict_round_trip_is_exact(name):
    rng, init = _init(1)
    opt, params = _stepped(name, 3, rng, init)
    saved = opt.state_dict(list(params))
    assert saved["name"] == name and set(opt.buffers) <= set(saved)
    opt2, params2 = _stepped(name, 0, rng, init)
    with torch.no_grad():
        for k in params:
            params2[k].copy_(params[k])
    opt2.load_state_dict(saved, list(params2))
    state = rng.get_state()
    _stepped(name, 3, rng, init, opt, params)
    rng.set_state(state)
    _stepped(name, 3, rng, init, opt2, params2)
    for k in params:
        assert torch.equal(params[k], params2[k]), k
    for b in opt.buffers:
        for x, y in zip(getattr(opt, b), getattr(opt2, b)):
            assert torch.equal(x, y), b
    assert int(opt2.count) == int(opt.count) == 6


@pytest.mark.parametrize("saved_by,loaded_by", [("adam", "adamw"), ("sgd", "rmsprop"),
                                                 ("radam", "sgd")])
def test_another_optimizers_state_is_refused(saved_by, loaded_by):
    rng, init = _init(2)
    opt, params = _stepped(saved_by, 2, rng, init)
    other, _ = _stepped(loaded_by, 0, rng, init)
    state = opt.state_dict(list(params))
    assert not other.accepts(state)
    with pytest.raises(ValueError, match=f"'{saved_by}'"):
        other.load_state_dict(state, list(params))


def test_an_unnamed_sgd_state_still_loads():
    """SGD states written before states were named hold only "trace"."""
    rng, init = _init(3)
    opt, params = _stepped("sgd", 2, rng, init)
    state = opt.state_dict(list(params))
    del state["name"]
    opt2, _ = _stepped("sgd", 0, rng, init)
    assert opt2.accepts(state)
    opt2.load_state_dict(state, list(params))
    assert int(opt2.count) == 2
    assert all(torch.equal(x, y) for x, y in zip(opt.trace, opt2.trace))


def test_the_betas_and_alpha_are_read():
    _, pcfg = _both_cfgs(NAME="adam", ADAM_BETA1=0.5, ADAM_BETA2=0.75)
    opt, _ = optim.build_optimizer(pcfg, [torch.zeros(2)], steps_per_epoch=1)
    assert (opt.b1, opt.b2) == (0.5, 0.75)
    _, pcfg = _both_cfgs(NAME="rmsprop", RMSPROP_ALPHA=0.5, MOMENTUM=0.0)
    opt, _ = optim.build_optimizer(pcfg, [torch.zeros(2)], steps_per_epoch=1)
    assert opt.alpha == 0.5 and opt.buffers == ("nu",)
    _, pcfg = _both_cfgs(NAME="lamb")
    with pytest.raises(ValueError, match="Unknown OPTIM.NAME"):
        optim.build_optimizer(pcfg, [torch.zeros(2)], steps_per_epoch=1)


def _bare_trainer(name, params):
    """A SimpleTrainer holding only what a checkpoint save and resume touch."""
    from fsvlm_tpu_torch.engine.trainer import SimpleTrainer

    t = SimpleTrainer.__new__(SimpleTrainer)
    t.model_name, t.params, t.best_result = "PromptLearner", params, -np.inf
    t.generator = torch.Generator().manual_seed(0)
    t.mix_rng = np.random.default_rng(0)
    _, pcfg = _both_cfgs(NAME=name, WEIGHT_DECAY=5e-4, MOMENTUM=0.9)
    t.optim, _ = optim.build_optimizer(pcfg, params.values(), steps_per_epoch=3)
    return t


@pytest.mark.parametrize("resumed_by", ["adam", "rmsprop"])
def test_the_trainers_resume_refuses_another_optimizers_state(tmp_path, capsys, resumed_by):
    rng, init = _init(4)
    t = _bare_trainer("adam", {k: torch.from_numpy(v.copy()) for k, v in init.items()})
    for _ in range(2):
        t.optim.step([torch.from_numpy(g) for g in _grads(rng, init, False).values()])
    t.save_model(0, str(tmp_path))
    t2 = _bare_trainer(resumed_by, {k: torch.from_numpy(v.copy()) for k, v in init.items()})
    assert t2.resume_model_if_exist(str(tmp_path)) == 1
    out = capsys.readouterr().out
    for k in init:  # the prompts are restored either way
        assert torch.equal(t2.params[k], t.params[k])
    if resumed_by == "adam":
        assert int(t2.optim.count) == 2 and "Warning" not in out
        assert all(torch.equal(x, y) for x, y in zip(t2.optim.nu, t.optim.nu))
    else:
        assert "optimizer 'adam', and this run's is 'rmsprop': not loaded" in out
        assert int(t2.optim.count) == 0 and not any(x.any() for x in t2.optim.nu)


STAGED = [("sgd", 0.9), ("adam", 0.9), ("rmsprop", 0.9)]


@pytest.mark.parametrize("name,momentum", STAGED, ids=[n for n, _ in STAGED])
@pytest.mark.parametrize("override", [False, True], ids=["staircase", "override"])
def test_staged_lr_and_schedule_override_match_the_optax_chain(name, momentum, override):
    """``param_labels``/``lr_mult`` (optax.multi_transform of a "base" chain
    at lr_mult and a "new" one at 1.0) and ``schedule_override`` (lr(step)
    instead of the staircase; here the zoo's lr(count // 2) for a group
    stepped twice per iteration), 12 steps with one non-finite step."""
    jcfg, pcfg = _both_cfgs(NAME=name, WEIGHT_DECAY=5e-4, MOMENTUM=momentum)
    rng, init = _init(3)
    labels = {"a": "base", "b": "new"}
    jsched = jax_optim.make_lr_schedule(jcfg, 3)
    psched = optim.make_lr_schedule(pcfg, 3, device="cpu")
    tx, _ = jax_optim.build_optimizer(
        jcfg, 3, param_labels=labels, lr_mult=0.1,
        schedule_override=(lambda c: jsched(c // 2)) if override else None)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt, _ = optim.build_optimizer(
        pcfg, params.values(), 3, param_labels=[labels[k] for k in params], lr_mult=0.1,
        schedule_override=(lambda c: psched(c // 2)) if override else None)
    assert opt.lr_scales == [0.1, 1.0]
    for step in range(N_STEPS):
        grads = _grads(rng, init, step == 5)
        updates, state = update({k: jnp.asarray(g) for k, g in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in params])
        for k in params:
            _assert_close(params[k].numpy(), jparams[k], f"{name} {k} at step {step}")
    assert int(opt.count) == N_STEPS - 1


def test_staged_lr_labels_are_checked():
    _, pcfg = _both_cfgs(NAME="sgd")
    params = [torch.zeros(2), torch.zeros(3)]
    with pytest.raises(ValueError, match="param_labels"):
        optim.build_optimizer(pcfg, params, 3, param_labels=["base"], lr_mult=0.1)
    with pytest.raises(ValueError, match="param_labels"):
        optim.build_optimizer(pcfg, params, 3, param_labels=["base", "old"], lr_mult=0.1)
