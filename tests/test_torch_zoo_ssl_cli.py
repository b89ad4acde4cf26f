"""FixMatch through the port's CLI and its checkpoints, on the CPU.

configs/trainers/zoo/fixmatch_cifar10.yaml with
configs/datasets/zoo/ssl_cifar10.yaml on a tiny SSL CIFAR-10 layout
(cifar10/{train,test}/<class>/<nnnn>.png, 10 classes, 10 train and 2 test
images each, random 32x32 PNGs written by the PNG fixtures' encoder),
cut to the CPU: wide_resnet_28_2 at 16x16, NUM_LABELED 20 (2 labeled and 7
unlabeled per class after the 10% val), batches of 8 labeled and 16
unlabeled, COUNT_ITER train_u (4 steps), 2 epochs, through
``fsvlm_tpu_torch.train.main``:

- the log contract (the pseudo-label metrics among the losses) and the
  checkpoints; ``--eval-only`` from the run reproduces its predictions;
- a resume from model.pkl-1 restores the weights, the statistics, the
  optimizer (momentum and step count) and the generator bit for bit, and
  trains epoch 2;
- the checkpoint crosses between the packages: the JAX package's FixMatch
  loads the port's weights, and the port loads a JAX-written checkpoint.
"""

import importlib.util
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
PNG_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "png")
CLASSES = ("airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse", "ship",
           "truck")
OPTS = ["MODEL.BACKBONE.PRETRAINED", "False", "INPUT.SIZE", "[16, 16]",
        "DATASET.NUM_LABELED", "20", "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
        "DATALOADER.TRAIN_U.BATCH_SIZE", "16", "DATALOADER.NUM_WORKERS", "2",
        "DATALOADER.TEST.BATCH_SIZE", "8", "OPTIM.MAX_EPOCH", "2", "TRAIN.CHECKPOINT_FREQ", "1",
        "TRAINER.FIXMATCH.CONF_THRE", "0.12"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cifar10(root):
    spec = importlib.util.spec_from_file_location("png_fixtures",
                                                  os.path.join(PNG_FIXTURES, "make_fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    rng = np.random.RandomState(0)
    for split, n in (("train", 10), ("test", 2)):
        for cls in CLASSES:
            os.makedirs(os.path.join(root, "cifar10", split, cls))
            for i in range(n):
                with open(os.path.join(root, "cifar10", split, cls, f"{i:04d}.png"), "wb") as f:
                    f.write(fixtures.encode_png(rng.randint(0, 256, (32, 32, 3)), 2, 8))
    return str(root)


def _argv(data, out, *flags):
    return ["--trainer", "FixMatch", "--seed", "1", "--device", "cpu", "--root", data,
            "--dataset-config-file", "configs/datasets/zoo/ssl_cifar10.yaml",
            "--config-file", "configs/trainers/zoo/fixmatch_cifar10.yaml",
            "--output-dir", str(out), *flags, *OPTS]


def _run(argv):
    return cli.main(cli.build_argparser().parse_args(argv))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        data = _cifar10(tmp_path_factory.mktemp("data"))
        out = tmp_path_factory.mktemp("fixmatch") / "run"
        return data, out, _run(_argv(data, out))
    finally:
        os.chdir(cwd)


def test_fixmatch_through_the_cli(run):
    data, out, t = run
    with open(out / "log.txt") as f:
        text = f.read()
    for needle in ("Finish training", "* accuracy:", "=> result", "epoch [2/2]",
                   "NAME: wide_resnet_28_2", "randaugment_fixmatch", "y_u_pred_keep"):
        assert needle in text, needle
    assert sorted(os.listdir(out / "model")) == ["checkpoint", "model.pkl-1", "model.pkl-2"]
    # 70 unlabeled images in batches of 16; the 20 test images
    assert t.steps_per_epoch == 4 and len(t.evaluator.y_pred) == 20
    assert len(t.dm.dataset.train_x) == 20 and len(t.dm.dataset.train_u) == 70
    batch = next(iter(t.train_loader_u))
    assert batch["img2"].shape == batch["img"].shape == (16, 16, 16, 3)
    ckpt = load_checkpoint(str(out / "model" / "model.pkl-2"))
    assert set(ckpt["state_dict"]) == {"net"} and set(ckpt["extra"]["model_state"]) == {"net"}


def test_eval_only_reproduces_the_predictions(run, monkeypatch):
    monkeypatch.chdir(ROOT)
    data, out, t = run
    t2 = _run(_argv(data, out.parent / "eval", "--eval-only", "--model-dir", str(out)))
    assert t2.evaluator.y_pred == t.evaluator.y_pred
    assert t2.evaluator.y_true == t.evaluator.y_true


def test_resume_restores_the_state_exactly(run, monkeypatch, capsys):
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
    assert int(saved["count"]) == int(ckpt["optimizer"]["count"]) == t.steps_per_epoch
    for name, v in ckpt["optimizer"]["trace"].items():
        np.testing.assert_array_equal(saved["trace"][name], v, err_msg=name)
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
