"""The committed reference traces of the Dassl SSL trainers replayed on the
port, on the CPU.

tests/golden_pack/zoo/{entmin,mean_teacher,mixmatch,fixmatch}.npz hold the
reference Dassl trainers' losses and weight snapshots over 8 steps (4
epochs of 2) from the trace's initial weights (MeanTeacher's teacher
too).  Each replay takes test_zoo_trajectory_parity.py's config and
batches (its seeds) and its assertions at its tolerances: losses within
1e-3 relative, weights rtol 2e-3 / atol 3e-5.  The backbone (cnn_digitsdg)
draws nothing; MixMatch's permutation and Beta draws in the trace are the
JAX package's (jax.random at fold_in(PRNGKey(0), step)), so this file asks
jax.random for them and hands them to the port through ``Replay``; nothing
else of JAX runs.
"""

import os

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.models.convert import load_params, load_zoo, params_tree, zoo_trees
from fsvlm_tpu_torch.models.draws import Replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK = os.path.join(ROOT, "tests", "golden_pack", "zoo")
N_EPOCHS, STEPS, BX, BU, N_CLS, K = 4, 2, 24, 8, 4, 2
SETTINGS = {
    "SEED": 1, "VERBOSE": False, "DATASET.NAME": "SyntheticDA",
    "DATASET.SOURCE_DOMAINS": ["d0", "d1"], "DATASET.TARGET_DOMAINS": ["d2"],
    "DATALOADER.TRAIN_U.SAME_AS_X": False, "INPUT.SIZE": (32, 32),
    "INPUT.TRANSFORMS": ["normalize"], "MODEL.BACKBONE.NAME": "cnn_digitsdg",
    "MODEL.BACKBONE.PRETRAINED": False, "DATALOADER.TRAIN_X.BATCH_SIZE": BX,
    "DATALOADER.TRAIN_U.BATCH_SIZE": BU, "DATALOADER.TEST.BATCH_SIZE": 16,
    "DATALOADER.NUM_WORKERS": 1, "OPTIM.NAME": "sgd", "OPTIM.LR": 0.005,
    "OPTIM.MOMENTUM": 0.9, "OPTIM.WEIGHT_DECAY": 5e-4, "OPTIM.LR_SCHEDULER": "cosine",
    "OPTIM.MAX_EPOCH": N_EPOCHS, "OPTIM.WARMUP_EPOCH": 0, "TEST.NO_TEST": True,
    "TRAIN.PRINT_FREQ": 1000, "TRAIN.COUNT_ITER": "smaller_one",
}
# trace: (trainer, settings, metrics)
CASES = {
    "entmin": ("EntMin", {}, ("loss_x", "loss_u", "acc_x")),
    "mean_teacher": ("MeanTeacher", {"TRAINER.MEANTEACHER.RAMPUP": 3}, ("loss_x", "loss_u")),
    "mixmatch": ("MixMatch", {"DATALOADER.K_TRANSFORMS": K, "TRAINER.MIXMATCH.RAMPUP": 5},
                 ("loss_x", "loss_u")),
    "fixmatch": ("FixMatch", {"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("random_flip", "normalize"),
                              "TRAINER.FIXMATCH.CONF_THRE": 0.3},
                 ("loss_x", "loss_u", "y_u_pred_keep")),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            node = out
            *parents, leaf = k[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _pairs(n, bsz, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(bsz, 32, 32, 3).astype(np.float32),
             rng.randint(0, N_CLS, size=bsz).astype(np.int64)) for _ in range(n)]


def _batch(img, label):
    n = len(label)
    return {"img": img, "label": label, "domain": np.zeros(n, np.int32),
            "index": np.arange(n, dtype=np.int32), "valid": np.ones(n, bool)}


def _batches(name):
    """test_zoo_trajectory_parity.py's batches of each trace."""
    n = N_EPOCHS * STEPS
    if name in ("entmin", "mean_teacher"):
        sx, su = (41, 42) if name == "entmin" else (13, 14)
        return [(_batch(*x), _batch(*u)) for x, u in zip(_pairs(n, BX, sx), _pairs(n, BU, su))]
    if name == "fixmatch":
        out = []
        for xw, xs, uw, us in zip(_pairs(n, BX, 15), _pairs(n, BX, 16), _pairs(n, BU, 17),
                                  _pairs(n, BU, 18)):
            bx, bu = _batch(*xw), _batch(*uw)
            bx["img2"], bu["img2"] = xs[0], us[0]
            out.append((bx, bu))
        return out
    rng = np.random.RandomState(131)
    xv = [rng.randn(BX, K, 32, 32, 3).astype(np.float32) for _ in range(n)]
    xl = [rng.randint(0, N_CLS, size=BX).astype(np.int64) for _ in range(n)]
    uv = [rng.randn(BU, K, 32, 32, 3).astype(np.float32) for _ in range(n)]
    return [(_batch(x, lab), _batch(u, np.zeros(BU, np.int64))) for x, lab, u in zip(xv, xl, uv)]


def _draws(name, step, beta):
    if name != "mixmatch":
        return []
    import jax

    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    k_perm, k_mix1, k_mix2 = jax.random.split(key, 3)
    return [np.asarray(jax.random.permutation(k_perm, BX + K * BU)),
            np.asarray(jax.random.beta(k_mix1, beta, beta, shape=(BX,))),
            np.asarray(jax.random.beta(k_mix2, beta, beta, shape=(K * BU,)))]


@pytest.mark.parametrize("name", list(CASES))
def test_reference_trace_replays_on_the_port(tmp_path, name):
    trainer, settings, metrics = CASES[name]
    flat = dict(np.load(os.path.join(PACK, f"{name}.npz")))
    cfg = get_cfg_base()
    kv = dict(SETTINGS, **settings, **{"TRAINER.NAME": trainer, "OUTPUT_DIR": str(tmp_path)})
    cfg.merge_from_list([x for pair in kv.items() for x in pair])
    pt = build_trainer(cfg, device="cpu")
    assert pt.steps_per_epoch == STEPS
    init = _tree(flat, "init/net/")
    load_zoo(pt, {"net": init})
    if name == "mean_teacher":  # the teacher starts at the trace's initial net
        load_params(pt.extra_nets["teacher"], init)
    beta = float(cfg.TRAINER.MIXMATCH.MIXUP_BETA)

    out = {k: [] for k in metrics}
    for step, (bx, bu) in enumerate(_batches(name)):
        pt.epoch, pt.batch_idx = divmod(step, STEPS)
        m = pt.train_step(bx, draws=Replay(_draws(name, step, beta), "cpu"), batch_u=bu)
        for k in metrics:
            out[k].append(float(m[k]))
        snap = {"net": zoo_trees(pt)[0]["net"]}
        if name == "mean_teacher":
            snap["teacher"] = params_tree(pt.extra_nets["teacher"])
        snap = _flat(snap if name == "mean_teacher" else snap["net"])
        for k in (k for k in flat if k.startswith("snap/")):
            np.testing.assert_allclose(snap[k[5:]], flat[k][step].astype(np.float32), rtol=2e-3,
                                       atol=3e-5, err_msg=f"{name} {k} step {step}")
    for k in metrics:
        ref = flat[f"out/{k}"]
        for s in range(N_EPOCHS * STEPS):
            assert abs(out[k][s] - ref[s]) < 1e-3 * (1 + abs(ref[s])), (name, k, s, out[k][s],
                                                                      ref[s])
