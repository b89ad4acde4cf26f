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
- the launcher (``Group``): a group past its deadline is killed whole and
  fails the test with each process's output; a rank that finds its port
  taken relaunches the group once;
- two ``fsvlm_tpu_torch.train`` processes (FSVLM_MULTIHOST, gloo) against
  one, as tests/test_multihost.py holds the JAX CLI: CoOp test-tiny, 2
  epochs of batch 16 over 4 classes x 8 images, on the host transforms and
  under DATALOADER.DEVICE_AUG (the device-resident cache on every rank,
  each rank its columns of the schedule, the crops drawn for the global
  batch), and under TEST.FINAL_MODEL best_val; PromptSRC under DEVICE_AUG,
  its epochs fused on every rank; DAELDG on SyntheticDA, each rank its
  share of every per-domain block, then ``--eval-only`` of its model and
  a resume of its run, each on two ranks and on one; the parameters within
  CLI_ATOL, the same accuracy line on both ranks, one log.txt and one
  checkpoint directory written by rank 0.
"""

import os
import pickle
import re
import socket
import subprocess
import sys
import tempfile
import time

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


# a launch's processes (every rank of its rendezvous, and the processes run
# beside them) end within this many seconds together, or are all killed
GROUP_DEADLINE = 300
PORT_TAKEN = re.compile(r"address already in use|EADDRINUSE", re.I)


class Group:
    """Processes started together and waited for under one deadline.
    ``make()`` lists them as (argv, env) pairs, taking a ``free_port()`` for
    each rendezvous.  If a rank finds its port taken (between free_port's
    close and its bind) the group is killed and launched once more from
    ``make()``; past the deadline, or when a process fails, every process is
    killed and the test fails with each one's last output."""

    def __init__(self, make, deadline=GROUP_DEADLINE):
        self.make, self.deadline, self.tries = make, deadline, 2
        self._start()

    def _start(self):
        self.tries -= 1
        self.logs, self.procs = [], []
        for argv, env in self.make():
            log = tempfile.TemporaryFile("w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                               stderr=subprocess.STDOUT, text=True))
        self.end = time.monotonic() + self.deadline
        self.outs = None

    def _out(self, i):
        self.logs[i].seek(0)
        return self.logs[i].read()

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _port_taken(self):
        return any(p.poll() not in (None, 0) and PORT_TAKEN.search(self._out(i))
                   for i, p in enumerate(self.procs))

    def _report(self, why):
        tails = "\n".join(f"--- {' '.join(map(str, p.args[1:7]))} (exit {p.returncode}):\n"
                          f"{self._out(i)[-2000:]}" for i, p in enumerate(self.procs))
        pytest.fail(f"{why}\n{tails}")

    def wait(self):
        """Every process's output, once all have ended with 0."""
        while self.outs is None:
            while any(p.poll() is None for p in self.procs):
                if self._port_taken() or any(p.poll() not in (None, 0) for p in self.procs):
                    break
                if time.monotonic() > self.end:
                    self._kill()
                    self._report(f"the group did not end within {self.deadline} s")
                time.sleep(0.1)
            if any(p.poll() not in (None, 0) for p in self.procs):
                self._kill()
                if self.tries and self._port_taken():
                    self._start()
                    continue
                self._report("a process of the group failed")
            self.outs = [self._out(i) for i in range(len(self.procs))]
        return self.outs


def _worker(case, world, pad_to, out, draws=None):
    """The argv and env of every rank of one worker launch, on a new port
    (``world`` "1g": one rank under a process group)."""
    port = free_port()
    extra = [str(draws)] if draws else []
    ranks = 1 if world == "1g" else world
    return [([sys.executable, WORKER, case, str(world), str(r), str(port), str(pad_to), str(out)]
             + extra, _env()) for r in range(ranks)]


def _launch(*launches):
    """One Group of worker launches, each ``_worker``'s arguments."""
    return Group(lambda: [spec for args in launches for spec in _worker(*args)])


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


def _py(code):
    return [sys.executable, "-c", code], _env()


def test_group_past_its_deadline_kills_every_process_and_fails():
    """A rank that never returns (a rendezvous nobody joins) fails the test
    at the group's deadline, with every process killed and each one's
    output shown."""
    group = Group(lambda: [_py("print('rank 0 waits', flush=True); import time; time.sleep(60)"),
                           _py("print('rank 1 done')")], deadline=2)
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="did not end within 2 s") as err:
        group.wait()
    assert time.monotonic() - t0 < 30
    assert "rank 0 waits" in str(err.value) and "rank 1 done" in str(err.value)
    assert all(p.poll() is not None for p in group.procs)


def test_group_relaunches_once_when_a_rank_finds_its_port_taken():
    """The first launch's rank 0 exits with EADDRINUSE while rank 1 waits
    for it: every process is killed and the group is launched once more;
    a second such failure fails the test."""
    calls = []

    def make(fail_times):
        def launch():
            calls.append(len(calls))
            if len(calls) <= fail_times:
                return [_py("import sys; print('bind: Address already in use'); sys.exit(1)"),
                        _py("import time; time.sleep(60)")]
            return [_py("print('ok 0')"), _py("print('ok 1')")]
        return launch

    assert Group(make(1), deadline=60).wait() == ["ok 0\n", "ok 1\n"]
    assert len(calls) == 2
    calls.clear()
    with pytest.raises(pytest.fail.Exception, match="a process of the group failed"):
        Group(make(2), deadline=60).wait()
    assert len(calls) == 2


@pytest.mark.parametrize("case", ["coop", "fixmatch", "mixmatch"])
def test_two_ranks_match_one_rank(tmp_path, case):
    two, one = tmp_path / "two.npz", tmp_path / "one.npz"
    _launch((case, 2, 2, two), (case, 1, 2, one)).wait()
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
    group = _launch(("fixmatch16", 2, 2, out))
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
    group.wait()
    got = dict(np.load(out))
    for k, ref in jm.items():
        assert abs(float(got[k]) - ref) <= METRIC_TOL * (1 + abs(ref)), (k, float(got[k]), ref)
    from fsvlm_tpu_torch.models.convert import flatten

    params = flatten(jax.tree.map(np.asarray, jt.params))
    state = flatten(jax.tree.map(np.asarray, jt.model_state))
    _assert_trees({k[2:]: v for k, v in got.items() if k.startswith("p/")}, params, "weights")
    _assert_trees({k[2:]: v for k, v in got.items() if k.startswith("s/")}, state, "statistics")


CLI = ["-m", "fsvlm_tpu_torch.train", "--seed", "1", "--device", "cpu",
       "--dataset-config-file", "configs/datasets/synthetic.yaml",
       "--config-file", "configs/trainers/tests/synthetic_tiny.yaml"]
CLI_OPTS = ["OPTIM.MAX_EPOCH", "2", "TRAIN.CHECKPOINT_FREQ", "0", "DATALOADER.NUM_WORKERS", "1"]
# DAELDG on SyntheticDA's two source domains (cnn_digitsdg at 32x32, a
# BatchNorm head): RandomDomainSampler batches of 2 blocks of 9 rows, each
# rank 5 rows of each block, one of them a pad row; 2 steps an epoch (the
# net's max-pool choices part trajectories chaotically past a few steps)
ZOO_CLI = ["-m", "fsvlm_tpu_torch.train", "--seed", "1", "--device", "cpu",
           "--source-domains", "d0", "d1", "--config-file",
           "configs/trainers/zoo/vanilla_mixstyle_pacs.yaml"]
ZOO_CLI_OPTS = ["DATASET.NAME", "SyntheticDA", "INPUT.SIZE", "[32, 32]",
                "MODEL.BACKBONE.NAME", "cnn_digitsdg", "MODEL.HEAD.NAME", "mlp",
                "MODEL.HEAD.HIDDEN_LAYERS", "[32]", "DATALOADER.TRAIN_X.SAMPLER",
                "RandomDomainSampler", "DATALOADER.TRAIN_X.N_DOMAIN", "2",
                "DATALOADER.TRAIN_X.BATCH_SIZE", "18", "TRAINER.DAELDG.STRONG_TRANSFORMS",
                "['normalize']", "OPTIM.LR", "0.01"]


def _cli(out_dir, extra_env, opts=(), trainer="CoOp", flags=()):
    """A CLI process's (argv, env)."""
    base, own = (ZOO_CLI, ZOO_CLI_OPTS) if trainer == "DAELDG" else (CLI, [])
    return ([sys.executable] + base + ["--trainer", trainer, "--output-dir", str(out_dir)]
            + list(flags) + CLI_OPTS + own + list(opts), dict(_env(), **extra_env))


def _ranks_env(port, r):
    return {"FSVLM_MULTIHOST": "1", "FSVLM_COORDINATOR": f"localhost:{port}",
            "FSVLM_NUM_PROCESSES": "2", "FSVLM_PROCESS_ID": str(r)}


def _ckpt_params(out_dir, folder="prompt_learner", epoch=2):
    from fsvlm_tpu_torch.models.convert import flatten

    with open(os.path.join(out_dir, folder, f"model.pkl-{epoch}"), "rb") as f:
        return flatten(pickle.load(f)["state_dict"])


# the JAX test's 1e-5 holds two runs that both sum over 8 device shards; here
# one process sums each gradient over 16 rows in one product and two over 8
# + 8, and 4 steps at LR 3.0 carry that rounding to 1.08e-5 (measured; one
# process against itself at 1, 2 and 4 threads: bit-equal); DAELDG's 4
# steps at LR 0.01 end 3.0e-8 apart (measured)
CLI_ATOL = 2e-5


@pytest.mark.parametrize("mode", [False, True, "best_val", "promptsrc", "daeldg"])
def test_two_process_cli_matches_one_process(tmp_path, mode):
    """mode: DATALOADER.DEVICE_AUG, or "best_val": the host transforms under
    TEST.FINAL_MODEL best_val (rank 0 saves and loads the best model after
    each val test, and every rank deploys its state), or "promptsrc":
    PromptSRC under DEVICE_AUG, where each epoch fuses (each rank its
    columns of the schedule, the crops drawn for the global batch, the text
    L1 at 1/R) and GPA is swapped in after the last, or "daeldg": the DG
    zoo's DAELDG, each rank its share of every per-domain block (ZOO_CLI),
    then ``--eval-only`` of the two ranks' model and a resume of their run
    for a third epoch, each on two ranks and on one: the run's last
    accuracy, the resumed parameters within CLI_ATOL, rank 0 alone
    writing."""
    single, multi = tmp_path / "single", tmp_path / "multi"
    best_val = mode == "best_val"
    promptsrc = mode == "promptsrc"
    trainer, folder = {"promptsrc": ("PromptSRC", "VLPromptLearner"),
                       "daeldg": ("DAELDG", "model")}.get(mode, ("CoOp", "prompt_learner"))
    opts = [] if mode == "daeldg" else ["DATALOADER.DEVICE_AUG", str(mode is True or promptsrc)]
    if best_val:
        opts += ["TEST.FINAL_MODEL", "best_val"]
    if promptsrc:  # the recipe's scale of LR (synthetic_tiny's 3.0 is CoOp's)
        opts += ["OPTIM.LR", "0.05", "OPTIM.WARMUP_CONS_LR", "0.01"]

    def ranks(one, two, flags=(), more=()):
        port = free_port()
        return [_cli(one, {}, opts + list(more), trainer, flags)] + [
            _cli(two, _ranks_env(port, r), opts + list(more), trainer, flags) for r in range(2)]

    outs = Group(lambda: ranks(single, multi)).wait()
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
    if mode == "daeldg":  # the two ranks' model: --eval-only, and a resume for a third
        # epoch, each on two ranks and on one
        ev = [tmp_path / "eval_one", tmp_path / "eval_two"]
        re_ = [tmp_path / "resume_one", tmp_path / "resume_two"]
        evaluate = ["--eval-only", "--model-dir", str(multi), "--load-epoch", "2"]
        runs = Group(lambda: ranks(*ev, evaluate)
                     + ranks(*re_, ["--resume", str(multi)], ["OPTIM.MAX_EPOCH", "3"])).wait()
        got = [[line for line in o.splitlines() if "* accuracy:" in line] for o in runs[:3]]
        assert got[0] and got[1] == got[2] == got[0] == acc[1][-1:], (got, acc[1])
        assert os.listdir(ev[1]) == ["log.txt"]
        assert all("Resumed from epoch 2" in o for o in runs[3:])
        a, b = _ckpt_params(re_[0], folder, 3), _ckpt_params(re_[1], folder, 3)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=CLI_ATOL, err_msg=f"resumed {k}")
        assert sorted(os.listdir(re_[1] / folder)) == ["checkpoint", "model.pkl-3"]
