"""The port's DG zoo trainers against the JAX package's, on the CPU.

- each of Vanilla, CrossGrad, DDAIG (fcn_3x32_gctx; the STN generator is
  held to JAX's in test_torch_zoo_ops.py), DomainMix (crossdomain and
  random) and DAELDG,
  built by both packages from one config on SyntheticDA with
  cnn_digitsdg at 32x32 and an MLP head with BatchNorm (so that F's and
  D's statistics are threaded too), starts from the same weights (the
  port draws the JAX package's from the seed: checked) and takes 8 steps
  on the same seeded batches, DomainMix with the JAX step's own draws
  handed in; per step the metrics, every weight and every BatchNorm
  statistic must agree (limits below: fp32 on both sides, reductions in
  another order; CrossGrad and DDAIG step from the JAX trainer's state);
- the committed reference traces tests/golden_pack/zoo/{vanilla,
  crossgrad,ddaig,daeldg,domainmix_crossdomain,domainmix_random}.npz
  (the reference Dassl trainers' losses and weight snapshots) are
  replayed against the port alone, at test_zoo_trajectory_parity.py's
  tolerances (loss 5e-4 relative, metrics 1e-3; weights rtol 2e-3, atol
  3e-5); DomainMix's partner and weight draws are the JAX ones that the
  trace was recorded with;
- build_trainer: the DG names on the CPU when asked (the DA names:
  test_torch_zoo_da_trainers.py; the SSL names and the wide ResNets raise
  KeyError naming ROADMAP A9: test_torch_zoo_cli.py, test_torch_zoo_models.py),
  DEVICE_AUG raising ValueError.
"""

import os

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.models.convert import load_zoo, zoo_trees
from fsvlm_tpu_torch.models.draws import Replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK = os.path.join(ROOT, "tests", "golden_pack", "zoo")
N_STEPS, BX, N_CLS = 8, 16, 4
# Trajectories of these nets part chaotically from rounding: a ReLU or max-pool
# choice that flips on a last-bit difference (in CrossGrad's input-gradient
# perturbation, in DDAIG's min-max, or simply in a later step's input) moves
# weights by 1e-3 of their scale within 8 steps, in either package against a
# rerun in another summation order, and flips accuracy metrics.  So each step
# starts from the JAX trainer's state (weights, statistics, momentum, count)
# and is held to the JAX step: |dmetric| <= METRIC_TOL * (1 + |m|), each weight
# and statistic within WEIGHT_RTOL of itself plus WEIGHT_ATOL (measured: 9.1e-6
# where a flip fell in a step, 2e-7 otherwise; the reference traces' own atol).
# The reference-trace replays below hold the 8-step trajectories.
METRIC_TOL, WEIGHT_RTOL, WEIGHT_ATOL = 1e-5, 1e-4, 3e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SETTINGS = {
    "SEED": 1, "VERBOSE": False, "DATASET.NAME": "SyntheticDA",
    "DATASET.SOURCE_DOMAINS": ["d0", "d1"], "DATASET.TARGET_DOMAINS": [],
    "INPUT.SIZE": (32, 32), "INPUT.TRANSFORMS": ["normalize"],
    "MODEL.BACKBONE.NAME": "cnn_digitsdg", "MODEL.BACKBONE.PRETRAINED": False,
    "DATALOADER.TRAIN_X.BATCH_SIZE": BX, "DATALOADER.TEST.BATCH_SIZE": 16,
    "DATALOADER.NUM_WORKERS": 1, "OPTIM.NAME": "sgd", "OPTIM.LR": 0.01,
    "OPTIM.MOMENTUM": 0.9, "OPTIM.WEIGHT_DECAY": 5e-4, "OPTIM.LR_SCHEDULER": "cosine",
    "OPTIM.MAX_EPOCH": 4, "OPTIM.WARMUP_EPOCH": 0, "TEST.NO_TEST": True,
    "TRAIN.PRINT_FREQ": 1000,
}
HEAD = {"MODEL.HEAD.NAME": "mlp", "MODEL.HEAD.HIDDEN_LAYERS": (32,)}
CASES = {
    "Vanilla": {},
    "CrossGrad": {},
    "DDAIG": {"TRAINER.DDAIG.G_ARCH": "fcn_3x32_gctx", "TRAINER.DDAIG.WARMUP": 1,
              "TRAINER.DDAIG.CLAMP": True},
    "DomainMix-crossdomain": {"TRAINER.DOMAINMIX.TYPE": "crossdomain"},
    "DomainMix-random": {"TRAINER.DOMAINMIX.TYPE": "random"},
    "DAELDG": {"DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler",
               "DATALOADER.TRAIN_X.N_DOMAIN": 2,
               "TRAINER.DAELDG.STRONG_TRANSFORMS": ("normalize",)},
}


def _cfgs(tmp_path, name, settings):
    """(JAX cfg, port cfg) of the same settings."""
    from fsvlm_tpu.config import get_cfg_default

    kv = dict(SETTINGS, **settings, **{"TRAINER.NAME": name.split("-")[0],
                                       "OUTPUT_DIR": str(tmp_path / "out")})
    jcfg, pcfg = get_cfg_default(), get_cfg_base()
    for k, v in kv.items():
        node = jcfg
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v
    pcfg.merge_from_list([x for pair in kv.items() for x in pair])
    return jcfg, pcfg


def _batches(seed, n_domains=2, strong=False, blocked=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(N_STEPS):
        b = {"img": rng.randn(BX, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, N_CLS, BX).astype(np.int32),
             "domain": (np.repeat(rng.permutation(n_domains), BX // n_domains) if blocked
                        else rng.randint(0, n_domains, BX)).astype(np.int32),
             "index": np.arange(BX, dtype=np.int32), "valid": np.ones(BX, bool)}
        if strong:
            b["img2"] = rng.randn(BX, 32, 32, 3).astype(np.float32)
        out.append(b)
    return out


def _jax_draws(name, key, batch):
    """The random values the JAX step draws from ``key`` (DomainMix's)."""
    import jax
    import jax.numpy as jnp

    if not name.startswith("DomainMix"):
        return []
    k_lam, k_perm = jax.random.split(key)
    lam = np.asarray(jax.random.beta(k_lam, 1.0, 1.0))
    d = jnp.asarray(batch["domain"])
    if name.endswith("crossdomain"):
        other = (d[None, :] != d[:, None]).astype(jnp.float32)
        w = jnp.where(other.sum(1, keepdims=True) > 0, other, jnp.ones_like(other))
        perm = jax.random.categorical(k_perm, jnp.log(w + 1e-9), axis=1)
    else:
        perm = jax.random.permutation(k_perm, len(batch["label"]))
    return [lam, np.asarray(perm)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif hasattr(v, "shape"):
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees(port, ref, what, atol=WEIGHT_ATOL):
    p, r = _flat(port), _flat(ref)
    assert set(p) == set(r), (what, sorted(set(p) ^ set(r))[:5])
    for k in r:
        np.testing.assert_allclose(p[k], r[k], rtol=WEIGHT_RTOL, atol=atol, err_msg=f"{what} {k}")


def _sync_from_jax(pt, jt):
    """Set the port trainer's weights, BN statistics and optimizer state
    (momentum and step count) to the JAX trainer's."""
    import jax

    from fsvlm_tpu_torch.models.backbones.common import TO_PORT
    from fsvlm_tpu_torch.models.convert import _named, flatten

    load_zoo(pt, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.model_state))
    groups = pt.param_groups or [None]
    for g in groups:
        st = jt.opt_state if g is None else jt.opt_state[g]
        trace = flatten(jax.tree.map(np.asarray, st.inner_state[1].trace))
        nets = pt.nets.items() if g is None else [(g, pt.nets[g])]
        named = [(f"{gg}.{n}" if g is None else n, layout) for gg, m in nets
                 for n, _, layout in _named(m)]
        optim = pt.optims[g]
        with torch.no_grad():
            for t, (n, layout) in zip(optim.trace, named):
                a = trace[n]
                t.copy_(torch.from_numpy(np.array(TO_PORT[layout](a) if layout else a)))
        optim.count = torch.tensor(int(st.inner_state[2].count))


def _traces(pt, jt):
    """(the port's momentum, the JAX trainer's) as JAX-layout trees."""
    import jax

    from fsvlm_tpu_torch.models.convert import params_tree

    if pt.param_groups is None:
        it = iter(pt.optim.trace)
        port = {g: params_tree(m, {n: next(it) for n, _ in m.named_parameters()})
                for g, m in pt.nets.items()}
        ref = jt.opt_state.inner_state[1].trace
    else:
        port = {g: params_tree(pt.nets[g], dict(zip((n for n, _ in pt.nets[g].named_parameters()),
                                                    pt.optims[g].trace)))
                for g in pt.param_groups}
        ref = {g: jt.opt_state[g].inner_state[1].trace for g in pt.param_groups}
    return port, jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_steps_match_jax(tmp_path, name):
    import jax

    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    from fsvlm_tpu.parallel.mesh import shard_batch
    import fsvlm_tpu.trainers  # noqa: F401

    jcfg, pcfg = _cfgs(tmp_path, name, dict(HEAD, **CASES[name]))
    jt = jax_build_trainer(jcfg)
    pt = build_trainer(pcfg, device="cpu")
    assert set(pt.nets) == set(jt.params) and pt.steps_per_epoch == jt.steps_per_epoch
    params, state = zoo_trees(pt)
    _assert_trees(params, jax.tree.map(np.asarray, jt.params), f"{name} init weights")
    _assert_trees(state, jax.tree.map(np.asarray, jt.model_state), f"{name} init state")

    batches = _batches(7, strong=name == "DAELDG", blocked=name == "DAELDG")
    for step, batch in enumerate(batches):
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        _sync_from_jax(pt, jt)
        jt.params, jt.opt_state, jt.model_state, jt.extra, jm = jt._train_step_xu(
            jt.params, jt.opt_state, jt.model_state, jt.extra, shard_batch(batch, jt.mesh), None,
            key, np.asarray(step, np.int32))
        pt.epoch, pt.batch_idx = divmod(step, pt.steps_per_epoch)
        pm = pt.train_step(batch, draws=Replay(_jax_draws(name, key, batch), "cpu"))
        assert set(pm) == set(jm)
        for k in jm:
            ref = float(jm[k])
            assert abs(float(pm[k]) - ref) <= METRIC_TOL * (1 + abs(ref)), (name, step, k)
        params, state = zoo_trees(pt)
        _assert_trees(params, jax.tree.map(np.asarray, jt.params), f"{name} step {step}")
        _assert_trees(state, jax.tree.map(np.asarray, jt.model_state), f"{name} step {step}")
        # the momentum at the weights' bound on the step's change: lr * trace
        _assert_trees(*_traces(pt, jt), f"{name} step {step} momentum",
                      WEIGHT_ATOL / SETTINGS["OPTIM.LR"])


# --------------------------------------------------- reference-trace replays

GOLDEN_SETTINGS = dict(SETTINGS, **{
    "INPUT.TRANSFORMS": ["normalize"], "DATALOADER.TRAIN_X.BATCH_SIZE": 24,
    "DATALOADER.TRAIN_U.BATCH_SIZE": 8, "OPTIM.LR": 0.005, "TRAIN.COUNT_ITER": "smaller_one"})
GOLDEN_STEPS, GOLDEN_BX = 8, 24


def _golden_batches(name):
    """test_zoo_trajectory_parity.py's batches for each trace."""
    seed = {"vanilla": 3, "crossgrad": 31, "ddaig": 113, "daeldg": 123,
            "domainmix_crossdomain": 141, "domainmix_random": 141}[name]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(GOLDEN_STEPS):
        b = {}
        if name == "daeldg":
            doms = rng.permutation(2)
            b["img"] = rng.randn(GOLDEN_BX, 32, 32, 3).astype(np.float32)
            b["img2"] = rng.randn(GOLDEN_BX, 32, 32, 3).astype(np.float32)
            b["label"] = rng.randint(0, N_CLS, size=GOLDEN_BX)
            b["domain"] = np.repeat(doms, GOLDEN_BX // 2)
        else:
            b["img"] = rng.randn(GOLDEN_BX, 32, 32, 3).astype(np.float32)
            b["label"] = rng.randint(0, N_CLS, size=GOLDEN_BX)
            b["domain"] = (np.zeros(GOLDEN_BX, np.int64) if name == "vanilla"
                           else rng.randint(0, 2, size=GOLDEN_BX))
        b["valid"] = np.ones(GOLDEN_BX, bool)
        out.append(b)
    return out


GOLDEN = {
    "vanilla": ("Vanilla", {}, ("loss",), 5e-4),
    "crossgrad": ("CrossGrad", {}, ("loss_f", "loss_d"), 1e-3),
    "ddaig": ("DDAIG", {"TRAINER.DDAIG.G_ARCH": "fcn_3x32_gctx", "TRAINER.DDAIG.WARMUP": 1,
                        "TRAINER.DDAIG.CLAMP": True}, ("loss_g", "loss_f", "loss_d"), 1e-3),
    "daeldg": ("DAELDG", {"DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler",
                          "DATALOADER.TRAIN_X.N_DOMAIN": 2,
                          "TRAINER.DAELDG.STRONG_TRANSFORMS": ("normalize",)},
               ("loss_x", "loss_cr", "acc"), 1e-3),
    "domainmix_crossdomain": ("DomainMix", {"TRAINER.DOMAINMIX.TYPE": "crossdomain"},
                              ("loss", "acc"), 1e-3),
    "domainmix_random": ("DomainMix", {"TRAINER.DOMAINMIX.TYPE": "random"}, ("loss", "acc"),
                         1e-3),
}


def _golden_draws(name, step, batch):
    """DomainMix's draws in the trace: the JAX step's from fold_in(key 0, step)
    (test_domainmix_trajectory_parity fed them to the reference)."""
    import jax

    if not name.startswith("domainmix"):
        return []
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    return _jax_draws("DomainMix-" + name.split("_")[1], key, batch)


@pytest.mark.parametrize("name", list(GOLDEN))
def test_reference_trace_replays_on_the_port(tmp_path, name):
    """The port alone against the reference Dassl trainer's recorded losses
    and weights, from the trace's initial weights, 8 steps over 4 epochs."""
    trainer, settings, metrics, metric_tol = GOLDEN[name]
    flat = dict(np.load(os.path.join(PACK, f"{name}.npz")))
    pcfg = get_cfg_base()
    kv = dict(GOLDEN_SETTINGS, **settings, **{"TRAINER.NAME": trainer,
                                              "OUTPUT_DIR": str(tmp_path / "out")})
    pcfg.merge_from_list([x for pair in kv.items() for x in pair])
    pt = build_trainer(pcfg, device="cpu")
    assert pt.steps_per_epoch == 2

    def tree(prefix):
        out = {}
        for k, v in flat.items():
            if k.startswith(prefix + "/"):
                node = out
                *parents, leaf = k[len(prefix) + 1:].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = v
        return out

    init = tree("init")
    load_zoo(pt, init)
    single = set(init) == {"net"}
    for step, batch in enumerate(_golden_batches(name)):
        pt.epoch, pt.batch_idx = divmod(step, pt.steps_per_epoch)
        m = pt.train_step(batch, draws=Replay(_golden_draws(name, step, batch), "cpu"))
        for k in metrics:
            ref = float(flat[f"out/{k}"][step])
            assert abs(float(m[k]) - ref) < metric_tol * (1 + abs(ref)), (name, step, k, float(m[k]))
        params = zoo_trees(pt)[0]
        snap = _flat(params["net"] if single else params)
        for k in (k for k in flat if k.startswith("snap/")):
            np.testing.assert_allclose(snap[k[5:]], flat[k][step].astype(np.float32),
                                       rtol=2e-3, atol=3e-5, err_msg=f"{name} {k} step {step}")
