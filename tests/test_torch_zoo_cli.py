"""The DG zoo through the port's CLI and its checkpoints, on the CPU.

- Vanilla with configs/trainers/zoo/vanilla_mixstyle_pacs.yaml (MixStyle
  resnet18_ms_l12, SGD, cosine, the recipe's host transforms) on
  SyntheticDA's two source domains at 32x32, 2 epochs through
  ``fsvlm_tpu_torch.train.main``: the "no weights found" warning, the log
  contract, the checkpoints; a resume from model.pkl-1 restores the
  weights, the BatchNorm statistics and the optimizer state bit for bit
  and trains epoch 2; ``--eval-only`` reproduces the run's predictions;
- the checkpoint holds the JAX trainer's trees: the JAX package's Vanilla
  loads the port's weights, and the port loads a JAX-written checkpoint's
  weights and statistics;
- ``--head`` sets MODEL.HEAD.NAME as the JAX CLI does; build_trainer
  builds the five SSL names on a wide ResNet (the DA names:
  test_torch_zoo_da_trainers.py), raises ValueError
  under DATALOADER.DEVICE_AUG, and asks for cuda unless told otherwise.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch import train as cli
from fsvlm_tpu_torch.engine.checkpoint import load_checkpoint
from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.models.convert import flatten, zoo_trees

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = "configs/trainers/zoo/vanilla_mixstyle_pacs.yaml"
OPTS = ["DATASET.NAME", "SyntheticDA", "INPUT.SIZE", "[32, 32]",
        "DATALOADER.TRAIN_X.BATCH_SIZE", "16", "DATALOADER.NUM_WORKERS", "2",
        "OPTIM.MAX_EPOCH", "2", "TRAIN.CHECKPOINT_FREQ", "1"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(out, *flags):
    return ["--trainer", "Vanilla", "--seed", "1", "--device", "cpu",
            "--source-domains", "d0", "d1", "--config-file", RECIPE, "--output-dir", str(out),
            *flags, *OPTS]


def _run(argv):
    return cli.main(cli.build_argparser().parse_args(argv))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        out = tmp_path_factory.mktemp("vanilla") / "run"
        t = _run(_argv(out))
        return out, t
    finally:
        os.chdir(cwd)


def test_vanilla_mixstyle_through_the_cli(run):
    out, t = run
    with open(out / "log.txt") as f:
        text = f.read()
    for needle in ("no weights found", "Finish training", "* accuracy:", "=> result",
                   "epoch [2/2]", "NAME: resnet18_ms_l12"):
        assert needle in text, needle
    assert sorted(os.listdir(out / "model")) == ["checkpoint", "model.pkl-1", "model.pkl-2"]
    assert len(t.evaluator.y_pred) == 32  # SyntheticDA's DG test: both sources


def _jax_argv(argv):
    """The JAX CLI's argv: it has no --device."""
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


def test_resume_restores_the_state_exactly(run, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    out, _ = run
    copy = out.parent / "resumed"
    shutil.copytree(out, copy)
    (copy / "model" / "checkpoint").write_text("model.pkl-1")
    ckpt = load_checkpoint(str(copy / "model" / "model.pkl-1"))
    t = build_trainer(cli.setup_cfg(cli.build_argparser().parse_args(_argv(copy))),
                      device="cpu")
    assert t.resume_model_if_exist(str(copy)) == 1
    params, state = zoo_trees(t)
    for name, ref in flatten(ckpt["state_dict"]).items():
        np.testing.assert_array_equal(flatten(params)[name], ref, err_msg=name)
    for name, ref in flatten(ckpt["extra"]["model_state"]).items():
        np.testing.assert_array_equal(flatten(state)[name], ref, err_msg=name)
    saved = t.optim_state()
    assert int(saved["count"]) == int(ckpt["optimizer"]["count"]) == t.steps_per_epoch
    for name, ref in ckpt["optimizer"]["trace"].items():
        np.testing.assert_array_equal(saved["trace"][name], ref, err_msg=name)
    np.testing.assert_array_equal(t.generator.get_state().numpy(), ckpt["extra"]["rng_state"])
    capsys.readouterr()
    t2 = _run(_argv(copy))  # trains epoch 2 from there
    text = capsys.readouterr().out
    assert "Resumed from epoch 1" in text and "epoch [2/2]" in text and "epoch [1/2]" not in text
    assert np.isfinite(t2.test())


def test_eval_only_reproduces_the_predictions(run, monkeypatch):
    monkeypatch.chdir(ROOT)
    out, t = run
    t2 = _run(_argv(out.parent / "eval", "--eval-only", "--model-dir", str(out)))
    assert t2.evaluator.y_pred == t.evaluator.y_pred
    assert t2.evaluator.y_true == t.evaluator.y_true


def test_checkpoints_cross_between_the_packages(run, tmp_path, monkeypatch):
    """The JAX package's Vanilla loads the port's weights; the port loads a
    JAX-written checkpoint's weights and BatchNorm statistics."""
    import jax

    import train as jax_cli  # the JAX package's CLI, at the repo root
    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    import fsvlm_tpu.trainers  # noqa: F401

    monkeypatch.chdir(ROOT)
    out, t = run
    jt = jax_build_trainer(jax_cli.setup_cfg(jax_cli.build_argparser().parse_args(
        _jax_argv(_argv(tmp_path / "jax")))))
    jt.load_model(str(out), epoch=2)
    for name, ref in flatten(zoo_trees(t)[0]).items():
        np.testing.assert_array_equal(flatten(jax.tree.map(np.asarray, jt.params))[name], ref)
    jt.params = jax.tree.map(lambda a: a * 0.5, jt.params)
    jt.model_state = jax.tree.map(lambda a: a + 0.25, jt.model_state)
    jt.save_model(0, str(tmp_path / "jax"))
    t.load_model(str(tmp_path / "jax"), epoch=1)
    params, state = zoo_trees(t)
    for tree, ref in ((params, jt.params), (state, jt.model_state)):
        for name, v in flatten(jax.tree.map(np.asarray, ref)).items():
            np.testing.assert_array_equal(flatten(tree)[name], v, err_msg=name)


def test_head_flag_sets_the_head_as_the_jax_cli(monkeypatch):
    import train as jax_cli

    monkeypatch.chdir(ROOT)
    argv = _argv("out", "--head", "mlp")
    jcfg = jax_cli.setup_cfg(jax_cli.build_argparser().parse_args(_jax_argv(argv)))
    pcfg = cli.setup_cfg(cli.build_argparser().parse_args(argv))
    assert pcfg.MODEL.HEAD.NAME == jcfg.MODEL.HEAD.NAME == "mlp"


SSL_TRAINERS = ("SupBaseline", "EntMin", "MeanTeacher", "MixMatch", "FixMatch")


@pytest.mark.parametrize("name", SSL_TRAINERS)
def test_da_and_ssl_trainers_name_the_roadmap_item(name, monkeypatch):
    """The five SSL trainers build from the CLI's config on a wide ResNet."""
    monkeypatch.chdir(ROOT)
    cfg = cli.setup_cfg(cli.build_argparser().parse_args(_argv("out")))
    cfg.TRAINER.NAME = name
    cfg.MODEL.BACKBONE.NAME = "wide_resnet_28_2"
    cfg.DATALOADER.K_TRANSFORMS = 2
    cfg.TRAINER.FIXMATCH.STRONG_TRANSFORMS = ("random_flip", "normalize")
    assert type(build_trainer(cfg, device="cpu")).__name__ == name


def test_device_aug_and_the_default_device(monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = cli.setup_cfg(cli.build_argparser().parse_args(
        _argv("out", "DATALOADER.DEVICE_AUG", "True")))
    with pytest.raises(ValueError, match="DEVICE_AUG"):
        build_trainer(cfg, device="cpu")
    if not torch.cuda.is_available():
        cfg.DATALOADER.DEVICE_AUG = False
        with pytest.raises(RuntimeError, match="CUDA"):
            build_trainer(cfg)


@pytest.mark.parametrize("count_iter", ["train_x", "train_u", "smaller_one"])
def test_xu_base_zips_train_x_and_train_u(count_iter, monkeypatch, tmp_path):
    """NetTrainerXU (the DA/SSL slices' base): TRAIN.COUNT_ITER's number of
    steps, each with a train_x and a train_u batch, the shorter loader
    cycled, as the JAX base's run_epoch (base.py:270-334)."""
    from fsvlm_tpu_torch.trainers.zoo.base import NetTrainerXU

    seen = []

    class Probe(NetTrainerXU):
        def build_method(self):
            def step_core(bx, bu, step, draws):
                seen.append((step, tuple(bx["img"].shape), tuple(bu["img"].shape),
                             sorted(set(bu["index"].tolist()))))
                return {"loss": bx["img"].mean() * 0}

            self.step_core = step_core

    monkeypatch.chdir(ROOT)
    cfg = cli.setup_cfg(cli.build_argparser().parse_args(_argv(tmp_path / "xu")))
    cfg.merge_from_list(["DATASET.TARGET_DOMAINS", ["d2"], "DATALOADER.TRAIN_X.BATCH_SIZE", 16,
                         "DATALOADER.TRAIN_U.SAME_AS_X", False, "DATALOADER.TRAIN_U.BATCH_SIZE", 4,
                         "TRAIN.COUNT_ITER", count_iter, "VERBOSE", False])
    t = Probe(cfg, device="cpu")
    len_x, len_u = len(t.train_loader_x), len(t.train_loader_u)  # 48 / 16, 24 / 4
    want = {"train_x": len_x, "train_u": len_u, "smaller_one": min(len_x, len_u)}[count_iter]
    assert t.steps_per_epoch == want and (len_x, len_u) == (3, 6)
    t.run_epoch()
    assert [s[0] for s in seen] == list(range(want))
    assert all(x == (16, 3, 32, 32) and u == (4, 3, 32, 32) for _, x, u, _ in seen)
    u_seen = sorted(i for *_, idx in seen for i in idx)
    assert u_seen == (list(range(24)) if count_iter == "train_u" else sorted(set(u_seen)))
