"""The port's DA zoo trainers against the JAX package's, on the CPU.

Each of SourceOnly, DANN, ADDA, AdaBN, MCD, MME, SE, M3SDA, CDAC and DAEL
is built by both packages from one config on SyntheticDA (target d2) with
cnn_digitsdg at 32x32 and an MLP head with BatchNorm, so that the feature
net's statistics are threaded too; M3SDA and DAEL sample 3 source domains
with RandomDomainSampler, SE and CDAC take two views, CDAC and DAEL their
strong views.  The batches (24 source, 8 target rows) are multiples of
the JAX package's 8 CPU devices, so that its mesh pads no row (a padding
row would enter its BatchNorm statistics).  ADDA and AdaBN start from a source checkpoint through
MODEL.INIT_WEIGHTS (weights only, as the JAX package reads it).  The
initial weights and statistics must be equal; then N_STEPS steps, each
from the JAX trainer's state (weights, statistics, every group's momentum
and step count, ``extra``: ADDA's source model, SE's teacher), are held to
the JAX step at test_torch_zoo_trainers.py's limits: the metrics, every
weight, statistic and momentum, and ``extra``.  Last, the port's ``infer``
against JAX's ``infer_core`` on the same state.  The backbone draws no
random value here (cnn_digitsdg has no dropout).

Also: CDAC's top-k similarity breaks ties as ``jax.lax.top_k`` (the lower
index first) on rows with many equal values; ADDA and AdaBN without
MODEL.INIT_WEIGHTS fail as the JAX trainers do; with a zoo checkpoint that
holds BatchNorm statistics, MODEL.INIT_WEIGHTS restores them in the port
and not in the JAX package (ROADMAP C.2): ADDA's frozen source model runs
on the checkpoint's statistics here and on its initial ones there.
"""

import pickle

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.models.convert import load_params, load_state, params_tree, state_tree, zoo_trees
from fsvlm_tpu_torch.models.draws import Replay
from test_torch_zoo_trainers import (METRIC_TOL, WEIGHT_ATOL, WEIGHT_RTOL, _assert_trees,
                                     _sync_from_jax, _traces)

N_STEPS, N_CLS = 4, 4
# CDAC runs at test_zoo_trajectory_parity.py's CDAC learning rate, 0.005: at
# 0.01 its prototypes (x CLASS_LR_MULTI 10) collapse in one step so that P =
# p_u p_us^T rounds to 1.0 in fp32 for most target pairs, and log(1 - P +
# 1e-7) and its gradient are then decided by P's last bit, which the two
# packages' softmax and matmul round differently (measured from JAX's state
# at step 1: aac_loss 0.14 apart, the prototypes 0.07 apart after one update,
# while the port against itself with every weight of F moved by one ulp
# stays within 2e-6).

SETTINGS = {
    "SEED": 1, "VERBOSE": False, "DATASET.NAME": "SyntheticDA",
    "DATASET.SOURCE_DOMAINS": ["d0", "d1"], "DATASET.TARGET_DOMAINS": ["d2"],
    "INPUT.SIZE": (32, 32), "INPUT.TRANSFORMS": ["normalize"],
    "MODEL.BACKBONE.NAME": "cnn_digitsdg", "MODEL.BACKBONE.PRETRAINED": False,
    "MODEL.HEAD.NAME": "mlp", "MODEL.HEAD.HIDDEN_LAYERS": (32,),
    "DATALOADER.TRAIN_X.BATCH_SIZE": 24, "DATALOADER.TRAIN_U.BATCH_SIZE": 8,
    "DATALOADER.TRAIN_U.SAME_AS_X": False, "DATALOADER.TEST.BATCH_SIZE": 16,
    "DATALOADER.NUM_WORKERS": 1, "OPTIM.NAME": "sgd", "OPTIM.LR": 0.01,
    "OPTIM.MOMENTUM": 0.9, "OPTIM.WEIGHT_DECAY": 5e-4, "OPTIM.LR_SCHEDULER": "cosine",
    "OPTIM.MAX_EPOCH": 4, "OPTIM.WARMUP_EPOCH": 0, "TEST.NO_TEST": True,
    "TRAIN.PRINT_FREQ": 1000, "TRAIN.COUNT_ITER": "smaller_one",
}
THREE = {"DATASET.SOURCE_DOMAINS": ["d0", "d1", "d2"],
         "DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler", "DATALOADER.TRAIN_X.N_DOMAIN": 3}
CASES = {
    "SourceOnly": {},
    "DANN": {},
    "ADDA": {},
    "AdaBN": {},
    "MCD": {"TRAINER.MCD.N_STEP_F": 2},
    "MME": {},
    "SE": {"DATALOADER.K_TRANSFORMS": 2, "TRAINER.SE.CONF_THRE": 0.3},
    "M3SDA": dict(THREE, **{"TRAINER.M3SDA.N_STEP_F": 2}),
    "CDAC": {"DATALOADER.K_TRANSFORMS": 2, "TRAINER.CDAC.STRONG_TRANSFORMS": ("normalize",),
             "TRAINER.CDAC.RAMPUP_ITRS": 4, "TRAINER.CDAC.P_THRESH": 0.5, "OPTIM.LR": 0.005},
    "DAEL": dict(THREE, **{"TRAINER.DAEL.STRONG_TRANSFORMS": ("normalize",),
                           "TRAINER.DAEL.CONF_THRE": 0.3}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(tmp_path, name, settings):
    """(JAX cfg, port cfg) of the same settings."""
    from fsvlm_tpu.config import get_cfg_default

    kv = dict(SETTINGS, **settings, **{"TRAINER.NAME": name, "OUTPUT_DIR": str(tmp_path / "out")})
    jcfg, pcfg = get_cfg_default(), get_cfg_base()
    for k, v in kv.items():
        node = jcfg
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v
    pcfg.merge_from_list([x for pair in kv.items() for x in pair])
    return jcfg, pcfg


def _source_checkpoint(tmp_path):
    """A SourceOnly net's weights (the JAX package's at seed 5) as a
    checkpoint that holds weights alone, as the JAX trajectory tests write it."""
    import jax

    from fsvlm_tpu.engine import build_trainer as jax_build_trainer

    jcfg, _ = _cfgs(tmp_path / "src", "SourceOnly", {"SEED": 5})
    path = tmp_path / "source.pkl"
    with open(path, "wb") as f:
        pickle.dump({"state_dict": jax.tree.map(np.asarray, jax_build_trainer(jcfg).params),
                     "epoch": 1}, f)
    return str(path)


def _batches(name, seed=11):
    rng = np.random.RandomState(seed)
    three = name in ("M3SDA", "DAEL")
    bx_n, bu_n = SETTINGS["DATALOADER.TRAIN_X.BATCH_SIZE"], SETTINGS["DATALOADER.TRAIN_U.BATCH_SIZE"]
    views = 2 if name in ("SE", "CDAC") else 1

    def img(n, k=views):
        a = rng.randn(n, k, 32, 32, 3).astype(np.float32)
        return a if k > 1 else a[:, 0]

    out = []
    for _ in range(N_STEPS):
        bx = {"img": img(bx_n), "label": rng.randint(0, N_CLS, bx_n).astype(np.int32),
              "domain": (np.repeat(rng.permutation(3), bx_n // 3) if three
                         else rng.randint(0, 2, bx_n)).astype(np.int32),
              "index": np.arange(bx_n, dtype=np.int32), "valid": np.ones(bx_n, bool)}
        bu = {"img": img(bu_n), "label": rng.randint(0, N_CLS, bu_n).astype(np.int32),
              "domain": np.zeros(bu_n, np.int32), "index": np.arange(bu_n, dtype=np.int32),
              "valid": np.ones(bu_n, bool)}
        if name in ("CDAC", "DAEL"):
            bx["img2"], bu["img2"] = img(bx_n), img(bu_n)
        out.append((bx, bu))
    return out


def _extra_trees(pt):
    return {**state_tree(pt.extra), **{k: params_tree(m) for k, m in pt.extra_nets.items()}}


def _sync_extra(pt, jt):
    import jax

    extra = dict(jax.tree.map(np.asarray, jt.extra))
    for k, m in pt.extra_nets.items():
        load_params(m, extra.pop(k))
    pt.extra = load_state(extra, "cpu")


def _sync(pt, jt):
    if pt.param_groups == []:  # AdaBN: nothing to update
        import jax

        from fsvlm_tpu_torch.models.convert import load_zoo

        load_zoo(pt, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray,
                                                                       jt.model_state))
    else:
        _sync_from_jax(pt, jt)
    _sync_extra(pt, jt)


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_steps_match_jax(tmp_path, name):
    import jax

    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    from fsvlm_tpu.parallel.mesh import shard_batch
    import fsvlm_tpu.trainers  # noqa: F401

    settings = dict(CASES[name])
    if name in ("ADDA", "AdaBN"):
        settings["MODEL.INIT_WEIGHTS"] = _source_checkpoint(tmp_path)
    jcfg, pcfg = _cfgs(tmp_path, name, settings)
    jt = jax_build_trainer(jcfg)
    pt = build_trainer(pcfg, device="cpu")
    assert set(pt.nets) == set(jt.params) and pt.steps_per_epoch == jt.steps_per_epoch
    assert set(pt.optims if pt.param_groups is not None else {}) == set(
        jt.opt_state if pt.param_groups is not None else {})
    params, state = zoo_trees(pt)
    _assert_trees(params, jax.tree.map(np.asarray, jt.params), f"{name} init weights")
    _assert_trees(state, jax.tree.map(np.asarray, jt.model_state), f"{name} init state")
    _assert_trees(_extra_trees(pt), jax.tree.map(np.asarray, jt.extra), f"{name} init extra")

    batches = _batches(name)
    for step, (bx, bu) in enumerate(batches):
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        _sync(pt, jt)
        jt.params, jt.opt_state, jt.model_state, jt.extra, jm = jt._train_step_xu(
            jt.params, jt.opt_state, jt.model_state, jt.extra, shard_batch(bx, jt.mesh),
            shard_batch(bu, jt.mesh), key, np.asarray(step, np.int32))
        pt.epoch, pt.batch_idx = divmod(step, pt.steps_per_epoch)
        pm = pt.train_step(bx, draws=Replay([], "cpu"), batch_u=bu)
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
                      WEIGHT_ATOL / SETTINGS["OPTIM.LR"])

    _sync(pt, jt)
    x = batches[0][0]["img"]
    x = x[:, 0] if x.ndim == 5 else x
    ref = np.asarray(jt.infer_core(jt.params, jt.model_state, x))
    with torch.no_grad():
        got = pt.infer(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, ref, rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL,
                               err_msg=f"{name} infer")


def test_cdac_top_k_breaks_ties_as_jax():
    """Rows of ReLU-like features with many exact zeros and equal positives:
    the port's similarity matrix is JAX's (jax.lax.top_k takes the lower
    index first among equal values)."""
    import jax
    import jax.numpy as jnp

    from fsvlm_tpu_torch.trainers.zoo.da import topk_similarity

    rng = np.random.RandomState(3)
    f = np.maximum(rng.randint(-3, 3, (16, 12)), 0).astype(np.float32)
    f[4] = 0.0
    f[5, :7] = 1.0
    _, idx = jax.lax.top_k(jnp.asarray(f), 5)
    idx = jnp.sort(idx, axis=1)
    ref = np.asarray((idx[:, None, :] == idx[None, :, :]).all(-1), np.float32)
    np.testing.assert_array_equal(topk_similarity(torch.from_numpy(f), 5).numpy(), ref)
    assert ref.sum() > 16  # ties make some rows share their top-5 indices


@pytest.mark.parametrize("name", ["ADDA", "AdaBN"])
def test_without_init_weights_fails_as_jax(tmp_path, name):
    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    import fsvlm_tpu.trainers  # noqa: F401

    jcfg, pcfg = _cfgs(tmp_path, name, {})
    with pytest.raises(AssertionError, match="MODEL.INIT_WEIGHTS"):
        jax_build_trainer(jcfg)
    with pytest.raises(AssertionError, match="MODEL.INIT_WEIGHTS"):
        build_trainer(pcfg, device="cpu")


def test_init_weights_restore_the_statistics_in_the_port_alone(tmp_path):
    """ROADMAP C.2: a zoo checkpoint with BatchNorm statistics; the port's
    ADDA freezes its source model on them, the JAX package's on the net's
    initial statistics."""
    import jax

    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    import fsvlm_tpu.trainers  # noqa: F401

    _, scfg = _cfgs(tmp_path / "src", "SourceOnly", {"SEED": 5})
    src = build_trainer(scfg, device="cpu")
    src.model_state = {"net": {"head": {"bn0": {"mean": torch.full((32,), 0.25),
                                                "var": torch.full((32,), 2.0)}},
                               "backbone": {}}}
    src.save_model(0, str(tmp_path / "src_run"))
    path = str(tmp_path / "src_run" / "model" / "model.pkl-1")
    jcfg, pcfg = _cfgs(tmp_path, "ADDA", {"MODEL.INIT_WEIGHTS": path})
    jt, pt = jax_build_trainer(jcfg), build_trainer(pcfg, device="cpu")
    port_bn = pt.extra["source_state"]["head"]["bn0"]
    jax_bn = jax.tree.map(np.asarray, jt.extra["source_state"])["head"]["bn0"]
    np.testing.assert_array_equal(port_bn["mean"].numpy(), np.full(32, 0.25, np.float32))
    np.testing.assert_array_equal(jax_bn["mean"], np.zeros(32, np.float32))
    np.testing.assert_array_equal(jax_bn["var"], np.ones(32, np.float32))
    # the weights load alike in both
    _assert_trees(params_tree(pt.extra_nets["source"]),
                  jax.tree.map(np.asarray, jt.extra["source"]), "source weights")
