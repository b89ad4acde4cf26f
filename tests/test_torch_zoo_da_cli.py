"""DANN through the port's CLI and its checkpoints, on the CPU.

configs/trainers/zoo/dann_resnet18.yaml with configs/datasets/zoo/office31.yaml,
amazon -> webcam, on a tiny Office-31-layout tree of the committed JPEG
fixtures (office31/<domain>/<class>/<file>, 3 classes), cut to the CPU:
cnn_digitsdg with an MLP head with BatchNorm (so that the net carries
statistics beside the critic's) at 32x32, batch 8, 2 epochs, through
``fsvlm_tpu_torch.train.main``:

- the log contract and finite losses; ``--eval-only`` from the run
  reproduces its predictions;
- a resume from model.pkl-1 restores both groups' weights and optimizer
  states (momentum and step count), the net's and the critic's BatchNorm
  statistics and the generator, bit for bit, and trains epoch 2;
- the checkpoint crosses between the packages: the JAX package's DANN loads
  the port's weights (net and critic), and the port loads a JAX-written
  checkpoint's weights and statistics.
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
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
CLASSES = ("back_pack", "bike", "calculator")
PER_CLASS = {"amazon": 8, "webcam": 6, "dslr": 2}
OPTS = ["MODEL.BACKBONE.NAME", "cnn_digitsdg", "MODEL.BACKBONE.PRETRAINED", "False",
        "MODEL.HEAD.NAME", "mlp", "MODEL.HEAD.HIDDEN_LAYERS", "[32]", "INPUT.SIZE", "[32, 32]",
        "DATALOADER.TRAIN_X.BATCH_SIZE", "8", "DATALOADER.NUM_WORKERS", "2",
        "DATALOADER.TEST.BATCH_SIZE", "8", "OPTIM.MAX_EPOCH", "2", "TRAIN.CHECKPOINT_FREQ", "1"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _office31(root):
    jpegs = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg")
                   and not f.startswith("exotic"))
    k = 0
    for dom, n in PER_CLASS.items():
        for cls in CLASSES:
            os.makedirs(os.path.join(root, "office31", dom, cls))
            for i in range(n):
                shutil.copy(os.path.join(FIXTURES, jpegs[k % len(jpegs)]),
                            os.path.join(root, "office31", dom, cls, f"frame_{i:04d}.jpg"))
                k += 1
    return str(root)


def _argv(data, out, *flags):
    return ["--trainer", "DANN", "--seed", "1", "--device", "cpu", "--root", data,
            "--dataset-config-file", "configs/datasets/zoo/office31.yaml",
            "--source-domains", "amazon", "--target-domains", "webcam",
            "--config-file", "configs/trainers/zoo/dann_resnet18.yaml",
            "--output-dir", str(out), *flags, *OPTS]


def _run(argv):
    return cli.main(cli.build_argparser().parse_args(argv))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        data = _office31(tmp_path_factory.mktemp("data"))
        out = tmp_path_factory.mktemp("dann") / "run"
        return data, out, _run(_argv(data, out))
    finally:
        os.chdir(cwd)


def test_dann_through_the_cli(run):
    data, out, t = run
    with open(out / "log.txt") as f:
        text = f.read()
    for needle in ("Finish training", "* accuracy:", "=> result", "epoch [2/2]",
                   "NAME: cnn_digitsdg", "random_translation", "loss_d"):
        assert needle in text, needle
    assert sorted(os.listdir(out / "model")) == ["checkpoint", "model.pkl-1", "model.pkl-2"]
    # COUNT_ITER smaller_one: webcam's 18 images in batches of 8 (amazon's 24: 3)
    assert t.steps_per_epoch == 2 and len(t.evaluator.y_pred) == 18
    ckpt = load_checkpoint(str(out / "model" / "model.pkl-2"))
    assert set(ckpt["state_dict"]) == {"net", "critic"}
    assert set(ckpt["optimizer"]) == {"net", "critic"}
    assert set(ckpt["extra"]["model_state"]) == {"net", "critic"}


def test_eval_only_reproduces_the_predictions(run, monkeypatch):
    monkeypatch.chdir(ROOT)
    data, out, t = run
    t2 = _run(_argv(data, out.parent / "eval", "--eval-only", "--model-dir", str(out)))
    assert t2.evaluator.y_pred == t.evaluator.y_pred
    assert t2.evaluator.y_true == t.evaluator.y_true


def test_resume_restores_both_groups_exactly(run, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    data, out, _ = run
    copy = out.parent / "resumed"
    shutil.copytree(out, copy)
    (copy / "model" / "checkpoint").write_text("model.pkl-1")
    ckpt = load_checkpoint(str(copy / "model" / "model.pkl-1"))
    t = build_trainer(cli.setup_cfg(cli.build_argparser().parse_args(_argv(data, copy))),
                      device="cpu")
    assert t.resume_model_if_exist(str(copy)) == 1
    params, state = zoo_trees(t)
    for tree, ref in ((params, ckpt["state_dict"]), (state, ckpt["extra"]["model_state"])):
        assert set(flatten(tree)) == set(flatten(ref))
        for name, v in flatten(ref).items():
            np.testing.assert_array_equal(flatten(tree)[name], v, err_msg=name)
    saved = t.optim_state()
    for g in ("net", "critic"):
        assert int(saved[g]["count"]) == int(ckpt["optimizer"][g]["count"]) == t.steps_per_epoch
        for name, v in ckpt["optimizer"][g]["trace"].items():
            np.testing.assert_array_equal(saved[g]["trace"][name], v, err_msg=f"{g} {name}")
    np.testing.assert_array_equal(t.generator.get_state().numpy(), ckpt["extra"]["rng_state"])
    capsys.readouterr()
    _run(_argv(data, copy))
    text = capsys.readouterr().out
    assert "Resumed from epoch 1" in text and "epoch [2/2]" in text and "epoch [1/2]" not in text


def test_checkpoints_cross_between_the_packages(run, tmp_path, monkeypatch):
    import jax

    import train as jax_cli  # the JAX package's CLI, at the repo root
    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    import fsvlm_tpu.trainers  # noqa: F401

    monkeypatch.chdir(ROOT)
    data, out, t = run
    argv = _argv(data, tmp_path / "jax")
    i = argv.index("--device")
    jt = jax_build_trainer(jax_cli.setup_cfg(jax_cli.build_argparser().parse_args(
        argv[:i] + argv[i + 2:])))
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
