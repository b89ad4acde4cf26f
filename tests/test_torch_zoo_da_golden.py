"""The committed reference traces of the Dassl DA trainers replayed on the
port alone, on the CPU (no JAX).

tests/golden_pack/zoo/{source_only,dann,adda,mcd,mme,se,m3sda,cdac,dael}.npz
hold the reference Dassl trainers' losses and weight snapshots over 8 steps
(4 epochs of 2) from the trace's initial weights, and
tests/golden_pack/dann_trajectory.npz the DANN trace of the golden pack.
Each replay takes test_zoo_trajectory_parity.py's config, batches (its
seeds) and assertions, at that file's tolerances: losses within 1e-3
relative, weights rtol 2e-3 / atol 3e-5; M3SDA tight for 3 steps and then
within twice the reference's own spread against a 3e-6-perturbed copy of
itself; CDAC's weights at atol 1e-4 (F) / 8e-4 (prototypes), its step 0
at 1e-4, its well-conditioned losses within 3x the reference's own spread
and its aac value within the saturation band (test_cdac_trajectory_parity's
docstring).  No random value is drawn (cnn_digitsdg has no dropout).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.models.convert import load_state, load_zoo, params_tree, state_tree, zoo_trees
from fsvlm_tpu_torch.models.draws import Replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK = os.path.join(ROOT, "tests", "golden_pack")
N_EPOCHS, STEPS, BX, BU, N_CLS = 4, 2, 24, 8, 4
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
DOMAINS2 = {"DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler", "DATALOADER.TRAIN_X.N_DOMAIN": 2}
# trace: (trainer, settings, {trace group: port group}, metrics, batch seed)
CASES = {
    "source_only": ("SourceOnly", {}, {"net": "net"}, ("loss", "acc"), 181),
    "dann": ("DANN", {}, {"net": "net", "critic": "critic"}, ("loss_x", "loss_d"), 5),
    "adda": ("ADDA", {}, {"net": "net", "critic": "critic"}, ("loss_critic", "loss_model"), 91),
    "mcd": ("MCD", {"TRAINER.MCD.N_STEP_F": 2}, {"F": "F", "C1": "C1", "C2": "C2"},
            ("loss_step_A", "loss_step_B", "loss_step_C"), 21),
    "mme": ("MME", {}, {"F": "net", "C": "C"}, ("loss_x", "loss_u", "acc_x"), 51),
    "se": ("SE", {"DATALOADER.K_TRANSFORMS": 2, "TRAINER.SE.CONF_THRE": 0.3}, {"net": "net"},
           ("loss_x", "loss_u", "acc_x"), 61),
    "m3sda": ("M3SDA", dict(DOMAINS2, **{"TRAINER.M3SDA.N_STEP_F": 2}), {"F": "F", "C": "C"},
              ("loss_step_A", "loss_step_B", "loss_step_C"), 73),
    "cdac": ("CDAC", {"DATALOADER.K_TRANSFORMS": 2, "TRAINER.CDAC.STRONG_TRANSFORMS": ("normalize",),
                      "TRAINER.CDAC.RAMPUP_ITRS": 4, "TRAINER.CDAC.P_THRESH": 0.5},
             {"F": "F", "C": "C"}, ("loss_x", "pl_loss", "cons_loss"), 103),
    "dael": ("DAEL", dict(DOMAINS2, **{"TRAINER.DAEL.STRONG_TRANSFORMS": ("normalize",),
                                       "TRAINER.DAEL.CONF_THRE": 0.3}),
             {"F": "F", "E": "E"}, ("loss_x", "loss_cr", "loss_u", "acc_x"), 43),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(flat, prefix, sep="/"):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            node = out
            *parents, leaf = k[len(prefix):].split(sep)
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


def _plain(rng, n):
    return {"img": rng.randn(n, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, N_CLS, size=n).astype(np.int64)}


def _batch(d, n, domain=None):
    return dict(d, domain=np.zeros(n, np.int32) if domain is None else domain.astype(np.int32),
                index=np.arange(n, dtype=np.int32), valid=np.ones(n, bool))


def _batches(name, seed):
    """test_zoo_trajectory_parity.py's batches of each trace, as the port
    takes them."""
    n = N_EPOCHS * STEPS
    if name in ("source_only", "dann", "adda", "mcd", "mme"):
        rx, ru = np.random.RandomState(seed), np.random.RandomState(seed + 1)
        return [(_batch(_plain(rx, BX), BX), _batch(_plain(ru, BU), BU)) for _ in range(n)]
    rng = np.random.RandomState(seed)
    out = []
    if name == "se":
        def two(bsz):
            v1, v2 = rng.randn(bsz, 32, 32, 3).astype(np.float32), rng.randn(
                bsz, 32, 32, 3).astype(np.float32)
            return _batch({"img": np.stack([v1, v2], 1),
                           "label": rng.randint(0, N_CLS, size=bsz).astype(np.int64)}, bsz)

        xs = [two(BX) for _ in range(n)]
        return list(zip(xs, [two(BU) for _ in range(n)]))
    if name == "cdac":
        def three(bsz):
            v0, vs, vs2 = (rng.randn(bsz, 32, 32, 3).astype(np.float32) for _ in range(3))
            return _batch({"img": np.stack([v0, v0], 1), "img2": np.stack([vs, vs2], 1),
                           "label": rng.randint(0, N_CLS, size=bsz).astype(np.int64)}, bsz)

        xs = [three(BX) for _ in range(n)]
        return list(zip(xs, [three(BU) for _ in range(n)]))
    for _ in range(n):
        doms = rng.permutation(2)
        img = rng.randn(BX, 32, 32, 3).astype(np.float32)
        if name == "dael":
            img2 = rng.randn(BX, 32, 32, 3).astype(np.float32)
            bx = {"img": img, "img2": img2}
        else:
            bx = {"img": img}
        bx["label"] = rng.randint(0, N_CLS, size=BX).astype(np.int64)
        bx = _batch(bx, BX, np.repeat(doms, BX // 2))
        if name == "dael":
            bu = _batch({"img": rng.randn(BU, 32, 32, 3).astype(np.float32),
                         "img2": rng.randn(BU, 32, 32, 3).astype(np.float32),
                         "label": np.zeros(BU, np.int64)}, BU)
        else:
            bu = _batch(_plain(rng, BU), BU)
        out.append((bx, bu))
    return out


def _trainer(tmp_path, trainer, settings, init_net=None):
    cfg = get_cfg_base()
    kv = dict(SETTINGS, **settings, **{"TRAINER.NAME": trainer, "OUTPUT_DIR": str(tmp_path / "out")})
    if init_net is not None:  # ADDA: the source checkpoint is the trace's initial net
        path = tmp_path / "source.pkl"
        with open(path, "wb") as f:
            pickle.dump({"state_dict": {"net": init_net}, "epoch": 0}, f)
        kv["MODEL.INIT_WEIGHTS"] = str(path)
    cfg.merge_from_list([x for pair in kv.items() for x in pair])
    pt = build_trainer(cfg, device="cpu")
    assert pt.steps_per_epoch == STEPS
    return pt


def _snapshot(pt, groups):
    """The port's weights under the trace's group names, its critic
    statistics as "cstate" and SE's teacher as "teacher"."""
    params = zoo_trees(pt)[0]
    snap = {t: params[p] for t, p in groups.items()}
    if "critic" in pt.model_state:
        snap["cstate"] = state_tree(pt.model_state["critic"])
    if "teacher" in pt.extra_nets:
        snap["teacher"] = params_tree(pt.extra_nets["teacher"])
    return _flat(snap["net"] if set(groups) == {"net"} and "teacher" not in snap else snap)


def _close(port, ref, what, atol=3e-5):
    np.testing.assert_allclose(port, ref.astype(np.float32), rtol=2e-3, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_trace_replays_on_the_port(tmp_path, name):
    trainer, settings, groups, metrics, seed = CASES[name]
    flat = dict(np.load(os.path.join(PACK, "zoo", f"{name}.npz")))
    init = {t: _tree(flat, f"init/{t}/") for t in groups}
    pt = _trainer(tmp_path, trainer, settings, init["net"] if name == "adda" else None)
    load_zoo(pt, {groups[t]: v for t, v in init.items()})
    if "critic" in groups:
        pt.model_state["critic"] = load_state(_tree(flat, "init/cstate/"), "cpu")
    if name == "se":  # the teacher starts at the trace's initial net
        from fsvlm_tpu_torch.models.convert import load_params

        load_params(pt.extra_nets["teacher"], init["net"])

    out = {k: [] for k in metrics + ("aac_loss", "loss_u")}
    for step, (bx, bu) in enumerate(_batches(name, seed)):
        pt.epoch, pt.batch_idx = divmod(step, STEPS)
        m = pt.train_step(bx, draws=Replay([], "cpu"), batch_u=bu)
        for k in out:
            if k in m:
                out[k].append(float(m[k]))
        snap = _snapshot(pt, groups)
        for k in (k for k in flat if k.startswith("snap/")):
            if name == "m3sda" and step >= 3:
                continue  # the chaotic regime: held by the losses' envelope below
            atol = {"F/backbone/conv0/w": 1e-4, "C/w": 8e-4}.get(k[5:], 3e-5) if name == "cdac" else 3e-5
            _close(snap[k[5:]], flat[k][step], f"{name} {k} step {step}", atol)
        if name == "adda":  # the classifier stays at the source weights
            np.testing.assert_array_equal(snap["net/classifier/w"], init["net"]["classifier"]["w"])

    n = N_EPOCHS * STEPS
    ref = {k: flat[f"out/{k}"] for k in metrics}
    if name == "m3sda":
        for k in metrics:
            for s in range(3):
                assert abs(out[k][s] - ref[k][s]) < 1e-4 * (1 + abs(ref[k][s])), (k, s)
            ours = max(abs(out[k][s] - ref[k][s]) for s in range(3, n))
            own = max(abs(flat[f"out/p_{k}"][s] - ref[k][s]) for s in range(3, n))
            assert ours < 2.0 * max(1e-3, own), (k, ours, own)
    elif name == "cdac":
        for k in ("loss_x", "loss_u", "aac_loss", "pl_loss", "cons_loss"):
            r = float(flat[f"out/{k}"][0])
            assert abs(out[k][0] - r) < 1e-4 * (1 + abs(r)), (k, out[k][0], r)
        for k in metrics:
            ours = max(abs(out[k][s] - ref[k][s]) for s in range(1, n))
            own = max(abs(flat[f"out/p_{k}"][s] - ref[k][s]) for s in range(1, n))
            assert ours < 3.0 * max(1e-3, own), (k, ours, own)
        for s in range(1, n):
            assert abs(out["aac_loss"][s] - flat["out/aac_loss"][s]) < 0.5, s
    else:
        for k in metrics:
            for s in range(n):
                assert abs(out[k][s] - ref[k][s]) < 1e-3 * (1 + abs(ref[k][s])), (
                    name, k, s, out[k][s], ref[k][s])


def test_golden_pack_dann_trajectory_replays_on_the_port(tmp_path):
    """tests/golden_pack/dann_trajectory.npz, as test_golden_pack.py's
    test_pack_dann_trajectory replays it on the JAX package."""
    z = np.load(os.path.join(PACK, "dann_trajectory.npz"))
    flat = {k: z[k] for k in z.files}
    pt = _trainer(tmp_path, "DANN", {})
    load_zoo(pt, {"net": _tree(flat, "init_net."), "critic": _tree(flat, "init_critic.")})
    pt.model_state["critic"] = load_state(_tree(flat, "init_cstate."), "cpu")
    names = {"conv0": "net/backbone/conv0/w", "cls_w": "net/classifier/w",
             "critic_fc0": "critic/fc0/w", "critic_bn0_scale": "critic/bn0/scale",
             "critic_out": "critic/out/w", "bn0_mean": "cstate/bn0/mean",
             "bn0_var": "cstate/bn0/var"}
    for step, (bx, bu) in enumerate(_batches("dann", 5)):
        pt.epoch, pt.batch_idx = divmod(step, STEPS)
        m = pt.train_step(bx, draws=Replay([], "cpu"), batch_u=bu)
        for k in ("loss_x", "loss_d"):
            assert abs(float(m[k]) - z[k][step]) < 1e-3 * (1 + abs(z[k][step])), (k, step)
        snap = _snapshot(pt, {"net": "net", "critic": "critic"})
        for short, path in names.items():
            _close(snap[path], z[f"ref.{short}"][step], f"{short} step {step}")
