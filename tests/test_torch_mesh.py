"""Data-parallel training across ranks (fsvlm_tpu_torch/parallel/mesh.py)
against one rank and against the JAX package's mesh, on the CPU.

- ``shard_batch``'s padding and ``valid`` mask: the ranks' rows, stacked,
  are the JAX package's padded global batch on an 8-device mesh (batch 9,
  13 and 16);
- two gloo ranks (subprocesses, tests/torch_mesh_worker.py) against one
  rank on the same padded batches (9 labeled rows -> 10, 5 unlabeled -> 6:
  one pad row each), 2 steps: CoOp at test-tiny; FixMatch and MixMatch on
  wide_resnet_28_2 at 8x8 with a BatchNorm head (BatchNorm moments over
  both ranks, the masks' global counts, MixMatch's permutation over the
  gathered pool): metrics, weights and statistics within MESH_TOL;
- two gloo ranks at batch 16 + 8 against the JAX package's FixMatch step
  on its 8-device CPU mesh, 2 steps, at test_torch_zoo_trainers.py's
  limits;
- an SSL trainer on a network that draws random values for its rows
  (style mixing, dropout) raises ValueError naming A8 at two ranks
  rather than draw each rank's rows from one generator state;
- two ``fsvlm_tpu_torch.train`` processes (FSVLM_MULTIHOST, gloo) against
  one, as tests/test_multihost.py holds the JAX CLI: CoOp test-tiny, 2
  epochs of batch 16 over 4 classes x 8 images, on the host transforms and
  under DATALOADER.DEVICE_AUG (the device-resident cache on every rank,
  each rank its columns of the schedule, the crops drawn for the global
  batch), and under TEST.FINAL_MODEL best_val; PromptSRC under DEVICE_AUG,
  its epochs fused on every rank; the parameters within
  CLI_ATOL, the same accuracy line on both ranks, one log.txt and one
  checkpoint directory written by rank 0.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
# two ranks against one: CoOp at atol 1e-5, as tests/test_multihost.py holds
# the JAX CLI (LR 3.0 scales the all-reduce's other summation order: 2.6e-6
# measured); the BatchNorm nets at test_torch_zoo_trainers.py's limits (the
# two ranks' moments are sums of per-rank sums, and one rank's F.batch_norm
# rounds otherwise: 1.6e-5 measured on a weight of 0.07 after 2 FixMatch steps)
MESH_TOL = {"coop": (0.0, 1e-5), "fixmatch": (1e-4, 3e-5), "mixmatch": (1e-4, 3e-5)}


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    env.pop("FSVLM_MULTIHOST", None)
    return env


def _launch(case, world, pad_to, out, draws=None):
    port = free_port()
    extra = [str(draws)] if draws else []
    return [subprocess.Popen([sys.executable, WORKER, case, str(world), str(r), str(port),
                              str(pad_to), str(out)] + extra, cwd=ROOT, env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs):
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:]


def test_shard_batch_pads_as_jax():
    import jax

    from fsvlm_tpu.parallel.mesh import get_mesh, shard_batch as jax_shard
    from fsvlm_tpu_torch.parallel.mesh import shard_batch

    mesh = get_mesh()
    n = mesh.devices.size
    for b in (9, 13, 16):
        rng = np.random.RandomState(b)
        batch = {"img": rng.randn(b, 4, 4, 3).astype(np.float32),
                 "label": rng.randint(0, 5, b).astype(np.int32),
                 "valid": np.ones(b, bool), "impath": [f"x{i}" for i in range(b)]}
        ref = jax.tree.map(np.asarray, jax_shard(batch, mesh))
        parts = [shard_batch(batch, n, i) for i in range(n)]
        assert set(parts[0]) == set(ref) == {"img", "label", "valid"}
        for k in ref:
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), ref[k], err_msg=k)
        assert ref["valid"].sum() == b and len(ref["valid"]) == b + (-b) % n
        one = shard_batch(batch, 1, 0)  # one rank: the batch as it is
        np.testing.assert_array_equal(one["img"], batch["img"])


@pytest.mark.parametrize("case", ["coop", "fixmatch", "mixmatch"])
def test_two_ranks_match_one_rank(tmp_path, case):
    two, one = tmp_path / "two.npz", tmp_path / "one.npz"
    procs = _launch(case, 2, 2, two) + _launch(case, 1, 2, one)
    _wait(procs)
    a, b = dict(np.load(two)), dict(np.load(one))
    assert set(a) == set(b)
    assert any(k.startswith("s/") for k in a) == (case != "coop")
    rtol, atol = MESH_TOL[case]
    for k in sorted(b):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=f"{case} {k}")


def test_two_ranks_match_jax_on_eight_devices(tmp_path):
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_mesh_worker as w
    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    from fsvlm_tpu.parallel.mesh import shard_batch
    import fsvlm_tpu.trainers  # noqa: F401
    from test_torch_zoo_da_trainers import _cfgs
    from test_torch_zoo_trainers import METRIC_TOL, _assert_trees

    out = tmp_path / "two.npz"
    procs = _launch("fixmatch16", 2, 2, out)
    name, settings, _, _ = w.CASES["fixmatch16"]
    jcfg, _ = _cfgs(tmp_path, name, settings)
    jt = jax_build_trainer(jcfg)
    assert jt.mesh.devices.size == 8
    jm = {}
    for step, (bx, bu) in enumerate(w.batches("fixmatch16", jt.num_classes)):
        jt.params, jt.opt_state, jt.model_state, jt.extra, m = jt._train_step_xu(
            jt.params, jt.opt_state, jt.model_state, jt.extra, shard_batch(bx, jt.mesh),
            shard_batch(bu, jt.mesh), jax.random.PRNGKey(step), np.asarray(step, np.int32))
        jm.update({f"m{step}/{k}": float(v) for k, v in m.items()})
    _wait(procs)
    got = dict(np.load(out))
    for k, ref in jm.items():
        assert abs(float(got[k]) - ref) <= METRIC_TOL * (1 + abs(ref)), (k, float(got[k]), ref)
    from fsvlm_tpu_torch.models.convert import flatten

    params = flatten(jax.tree.map(np.asarray, jt.params))
    state = flatten(jax.tree.map(np.asarray, jt.model_state))
    _assert_trees({k[2:]: v for k, v in got.items() if k.startswith("p/")}, params, "weights")
    _assert_trees({k[2:]: v for k, v in got.items() if k.startswith("s/")}, state, "statistics")


# networks that draw random values for their rows: style mixing, dropout
DRAWING_NETS = ("resnet18_ms_l12", "cnn_digit5_m3sda")


@pytest.mark.parametrize("net", DRAWING_NETS)
def test_ssl_trainers_refuse_row_drawing_nets_across_ranks(tmp_path, monkeypatch, net):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from fsvlm_tpu_torch.engine.trainer import build_trainer
    from fsvlm_tpu_torch.parallel import mesh
    from test_torch_zoo_da_trainers import _cfgs

    _, cfg = _cfgs(tmp_path, "FixMatch", {"MODEL.BACKBONE.NAME": net,
                                          "TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("normalize",)})
    build_trainer(cfg, device="cpu")  # one rank: it trains
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="ROADMAP A8"):
        build_trainer(cfg, device="cpu")


CLI = ["-m", "fsvlm_tpu_torch.train", "--seed", "1", "--device", "cpu",
       "--dataset-config-file", "configs/datasets/synthetic.yaml",
       "--config-file", "configs/trainers/tests/synthetic_tiny.yaml"]
CLI_OPTS = ["OPTIM.MAX_EPOCH", "2", "TRAIN.CHECKPOINT_FREQ", "0", "DATALOADER.NUM_WORKERS", "1"]


def _cli(out_dir, extra_env, opts=(), trainer="CoOp"):
    env = dict(_env(), **extra_env)
    return subprocess.Popen([sys.executable] + CLI + ["--trainer", trainer, "--output-dir",
                                                      str(out_dir)] + CLI_OPTS + list(opts),
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _ckpt_params(out_dir, folder="prompt_learner"):
    with open(os.path.join(out_dir, folder, "model.pkl-2"), "rb") as f:
        return pickle.load(f)["state_dict"]


# the JAX test's 1e-5 holds two runs that both sum over 8 device shards; here
# one process sums each gradient over 16 rows in one product and two over 8
# + 8, and 4 steps at LR 3.0 carry that rounding to 1.08e-5 (measured; one
# process against itself at 1, 2 and 4 threads: bit-equal)
CLI_ATOL = 2e-5


@pytest.mark.parametrize("mode", [False, True, "best_val", "promptsrc"])
def test_two_process_cli_matches_one_process(tmp_path, mode):
    """mode: DATALOADER.DEVICE_AUG, or "best_val": the host transforms under
    TEST.FINAL_MODEL best_val (rank 0 saves and loads the best model after
    each val test, and every rank deploys its state), or "promptsrc":
    PromptSRC under DEVICE_AUG, where each epoch fuses (each rank its
    columns of the schedule, the crops drawn for the global batch, the text
    L1 at 1/R) and GPA is swapped in after the last."""
    single, multi = tmp_path / "single", tmp_path / "multi"
    port = free_port()
    best_val = mode == "best_val"
    promptsrc = mode == "promptsrc"
    trainer, folder = ("PromptSRC", "VLPromptLearner") if promptsrc else ("CoOp", "prompt_learner")
    opts = ["DATALOADER.DEVICE_AUG", str(mode is True or promptsrc)]
    if best_val:
        opts += ["TEST.FINAL_MODEL", "best_val"]
    if promptsrc:  # the recipe's scale of LR (synthetic_tiny's 3.0 is CoOp's)
        opts += ["OPTIM.LR", "0.05", "OPTIM.WARMUP_CONS_LR", "0.01"]
    procs = [_cli(single, {}, opts, trainer)] + [
        _cli(multi, {"FSVLM_MULTIHOST": "1", "FSVLM_COORDINATOR": f"localhost:{port}",
                     "FSVLM_NUM_PROCESSES": "2", "FSVLM_PROCESS_ID": str(r)}, opts, trainer)
        for r in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:]
        outs.append(out)
    a, b = _ckpt_params(single, folder), _ckpt_params(multi, folder)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]), rtol=0, atol=CLI_ATOL,
                                   err_msg=k)
    acc = [[line for line in o.splitlines() if "* accuracy:" in line] for o in outs]
    assert acc[0] and acc[1] == acc[2] == acc[0], acc
    # rank 0 alone writes: one log, one checkpoint directory
    assert sorted(f for f in os.listdir(multi) if f.startswith("log.txt")) == ["log.txt"]
    assert sorted(os.listdir(multi / folder)) == (
        ["checkpoint"] + ["model-best.pkl"] * best_val + ["model.pkl-2"])
    if best_val:
        assert all("Deploy the model with the best val performance" in o for o in outs)
    if promptsrc:  # a resident cache on every rank: TRAIN.EPOCH_FUSE "auto" fuses each epoch
        assert all("* device-resident train set" in o for o in outs)
