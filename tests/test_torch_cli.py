"""The port's CLI (``python -m fsvlm_tpu_torch.train``) on the CPU, mirroring
tests/test_cli.py:28-110: PromptSRC on the synthetic dataset with the tiny
recipe writes ``log.txt`` (which parse_test_res.py parses), the checkpoint
pointer and ``model-best.pkl``; ``--eval-only`` on that directory gives the
run's final accuracy again; FSVLM_EXTRA_OPTS applies last; the unported
paths raise naming their ROADMAP items.  The classification report and
the evaluator's result block against the JAX package's (which print
scikit-learn's report), character for character.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.engine.evaluator import Classification as JaxClassification
from fsvlm_tpu_torch import train as cli
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.evaluator import Classification
from fsvlm_tpu_torch.engine.trainer import build_trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_ARGS = ["--trainer", "PromptSRC", "--seed", "1",
             "--dataset-config-file", "configs/datasets/synthetic.yaml",
             "--config-file", "configs/trainers/tests/synthetic_tiny.yaml", "--device", "cpu"]
TINY_OPTS = ["TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT", "2", "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION",
             "2", "DATALOADER.DEVICE_AUG", "True", "DATALOADER.NUM_WORKERS", "2"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tests' tiny CPU steps: the suite runs
    several worker processes at once, and their thread pools contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _accuracies(text):
    return [float(x) for x in re.findall(r"\* accuracy: ([\d.]+)%", text)]


def test_cli_promptsrc_synthetic_log_contract(tmp_path, monkeypatch):
    out_dir = str(tmp_path / "out")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "FSVLM_EXTRA_OPTS")}
    env["OMP_NUM_THREADS"] = "1"  # as _one_torch_thread
    proc = subprocess.run(
        [sys.executable, "-m", "fsvlm_tpu_torch.train"] + BASE_ARGS
        + ["--output-dir", out_dir] + TINY_OPTS
        + ["OPTIM.MAX_EPOCH", "2", "TEST.FINAL_MODEL", "best_val",
           "TRAINER.PROMPTSRC.CACHED_TEACHER", "True"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    stdout = proc.stdout
    for needle in ("=> result", "* accuracy:", "Classification Report", "Finish training",
                   "Deploy the model with the best val performance",
                   "[PromptSRC] cached teacher image features: (32, 64)",
                   "* device-resident train set: 32 images"):
        assert needle in stdout, needle
    with open(os.path.join(out_dir, "log.txt")) as f:
        log = f.read()
    assert "=> result" in log and "Classification Report" in log
    mdir = os.path.join(out_dir, "VLPromptLearner")
    assert {"checkpoint", "model-best.pkl", "model.pkl-2"} <= set(os.listdir(mdir))

    seed_dir = tmp_path / "agg" / "seed1"
    seed_dir.mkdir(parents=True)
    os.link(os.path.join(out_dir, "log.txt"), seed_dir / "log.txt")
    agg = subprocess.run([sys.executable, os.path.join(ROOT, "parse_test_res.py"),
                          str(tmp_path / "agg")], capture_output=True, text=True, timeout=60)
    assert agg.returncode == 0 and "* accuracy:" in agg.stdout

    # --eval-only on the run's directory deploys model-best.pkl again and
    # gives the run's final test accuracy
    monkeypatch.chdir(ROOT)
    args = cli.build_argparser().parse_args(
        BASE_ARGS + ["--output-dir", str(tmp_path / "eval"), "--eval-only", "--model-dir", out_dir]
        + TINY_OPTS)
    trainer = cli.main(args)
    with open(tmp_path / "eval" / "log.txt") as f:
        eval_log = f.read()
    assert _accuracies(eval_log) == _accuracies(log)[-1:]
    assert "Load model from" in eval_log and "Classification Report" in eval_log
    assert trainer.device.type == "cpu"


def test_extra_opts_env_applies_last(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("FSVLM_EXTRA_OPTS", "OPTIM.MAX_EPOCH 1 TEST.NO_TEST True")
    args = cli.build_argparser().parse_args(
        BASE_ARGS + ["--output-dir", str(tmp_path)] + TINY_OPTS + ["OPTIM.MAX_EPOCH", "5"])
    console = sys.stdout
    trainer = cli.main(args)
    assert sys.stdout is console  # the tee is taken down after the run
    out = capsys.readouterr().out
    assert "MAX_EPOCH: 1" in out and "Finish training" in out and trainer.max_epoch == 1
    assert "=> result" in out  # the CLI's own test after training


@pytest.mark.parametrize("opts,error,match", [
    (["TRAINER.NAME", "SupBaseline"], KeyError, "ROADMAP A9"),
    (["TRAINER.NAME", "FixMatch"], KeyError, "ROADMAP A9"),
    (["TRAINER.NAME", "MeanTeacher"], KeyError, "ROADMAP A9"),
    (["DATASET.NAME", "Office32"], KeyError, "not registered; registered: .*'Office31'"),
])
def test_unported_paths_raise_naming_their_roadmap_item(tmp_path, monkeypatch, opts, error, match):
    monkeypatch.chdir(ROOT)
    args = cli.build_argparser().parse_args(
        BASE_ARGS + ["--output-dir", str(tmp_path)] + TINY_OPTS + opts)
    with pytest.raises(error, match=match):
        cli.main(args)


REPORT_CASES = {
    "random": (np.random.RandomState(0).randint(0, 8, 50), np.random.RandomState(1).randint(0, 8, 50)),
    "missing_and_extra_labels": ([0, 0, 1, 1, 2, 12], [0, 3, 1, 1, 12, 12]),
    "binary": ([0, 1, 1, 0, 1], [0, 1, 0, 0, 1]),
    "perfect": ([3, 4, 5], [3, 4, 5]),
    "wide": (list(range(105)) * 2, [i % 7 for i in range(210)]),
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
@pytest.mark.parametrize("base", [0, 4])
def test_report_matches_jax_and_sklearn(case, base, capsys):
    import train as jax_cli  # the JAX package's CLI, at the repo root

    y_true, y_pred = (list(map(int, a)) for a in REPORT_CASES[case])
    jax_cli.report(y_true, y_pred, base)
    ref = capsys.readouterr().out
    cli.report(y_true, y_pred, base)
    assert capsys.readouterr().out == ref
    assert ("Base class accuracy" in ref) == (base > 0)


@pytest.mark.parametrize("per_class", [False, True])
def test_evaluator_block_matches_jax(per_class, capsys):
    cfg = get_cfg_base()
    cfg.TEST.PER_CLASS_RESULT = per_class
    jcfg = jax_get_cfg_default()
    jcfg.TEST.PER_CLASS_RESULT = per_class
    names = {i: f"class {i}" for i in range(5)}
    rng = np.random.RandomState(2)
    logits, labels = rng.randn(23, 5).astype(np.float32), rng.randint(0, 5, 23)
    blocks = []
    for ev in (JaxClassification(jcfg, lab2cname=names), Classification(cfg, lab2cname=names)):
        ev.process(logits[:10], labels[:10])
        ev.process(logits[10:], labels[10:])
        capsys.readouterr()
        ev.evaluate()
        blocks.append(capsys.readouterr().out)
    assert blocks[1] == blocks[0] and blocks[0].startswith("=> result")


@pytest.mark.parametrize("trainer,opts", [
    ("IVLP", ["TRAINER.IVLP.USE_MIXUP", "True", "TRAINER.IVLP.PROMPT_DEPTH_TEXT", "2",
              "TRAINER.IVLP.PROMPT_DEPTH_VISION", "2", "TRAINER.IVLP.PREC", "fp32"]),
    ("CoOp", []),
    ("CoCoOp", ["TRAINER.COCOOP.N_CTX", "4", "DATALOADER.TRAIN_X.BATCH_SIZE", "4"]),
])
def test_cli_trains_each_ported_trainer(tmp_path, monkeypatch, trainer, opts):
    """One epoch of IVLP (KD teacher, mixup), CoOp and CoCoOp through the CLI,
    with their checkpoint files under the JAX package's model names."""
    monkeypatch.chdir(ROOT)
    args = cli.build_argparser().parse_args(
        ["--trainer", trainer] + BASE_ARGS[2:] + ["--output-dir", str(tmp_path)] + TINY_OPTS
        + ["OPTIM.MAX_EPOCH", "1"] + opts)
    t = cli.main(args)
    assert type(t).__name__ == trainer and t.epoch == 0
    mdir = tmp_path / t.model_name
    assert sorted(os.listdir(mdir)) == ["checkpoint", "model.pkl-1"]
    log = (tmp_path / "log.txt").read_text()
    assert "epoch [1/1]" in log and len(_accuracies(log)) == 2


@pytest.mark.parametrize("trainer,opts", [
    ("LoRA", ["TRAINER.LORA.PREC", "fp32", "TEST.FINAL_MODEL", "best_val", "OPTIM.MAX_EPOCH", "2"]),
    ("MaPLe", ["TRAINER.MAPLE.PREC", "fp32", "TRAINER.MAPLE.PROMPT_DEPTH", "2",
               "OPTIM.MAX_EPOCH", "1"]),
    ("ZeroshotCLIP", ["OPTIM.MAX_EPOCH", "1"]),
    ("ZeroshotCLIP2", ["OPTIM.MAX_EPOCH", "1"]),
    ("LinearProbeCLIP", ["OPTIM.MAX_EPOCH", "1"]),
    ("PLIP", ["TRAINER.PLIP.PREC", "fp32", "OPTIM.MAX_EPOCH", "1"]),
    pytest.param("CoOp", ["MODEL.BACKBONE.NAME", "test-tiny-rn", "INPUT.SIZE", "[64, 64]",
                          "OPTIM.MAX_EPOCH", "1"], id="CoOp-test-tiny-rn"),
])
def test_cli_trains_the_clip_path_trainers(tmp_path, monkeypatch, trainer, opts):
    """``--trainer LoRA|MaPLe|ZeroshotCLIP|ZeroshotCLIP2|LinearProbeCLIP|PLIP``
    and CoOp on the ModifiedResNet test-tiny-rn, on the synthetic dataset:
    the run trains, tests and writes its checkpoints (LoRA: lora/best.pkl
    from the best-val save and last.pkl; the zero-shot trainers none);
    ``--eval-only`` on the run's directory reproduces the final test
    predictions exactly."""
    monkeypatch.chdir(ROOT)
    out = tmp_path / "run"
    args = cli.build_argparser().parse_args(
        ["--trainer", trainer] + BASE_ARGS[2:] + ["--output-dir", str(out)] + TINY_OPTS + opts)
    t = cli.main(args)
    assert type(t).__name__ == trainer
    log = (out / "log.txt").read_text()
    assert f"epoch [{t.max_epoch}/{t.max_epoch}]" in log and "=> result" in log
    want = t.evaluator.y_pred
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if ".pkl" in p.name)
    lora = "Synthetic/test-tiny/lora/"
    assert files == {"LoRA": [lora + "best.pkl", lora + "last.pkl"],
                     "MaPLe": ["MultiModalPromptLearner/model.pkl-1"],
                     "LinearProbeCLIP": ["linear_head/model.pkl-1"],
                     "PLIP": ["prompt_learner/model.pkl-1"],
                     "CoOp": ["prompt_learner/model.pkl-1"]}.get(trainer, [])
    assert t.clip.cfg.is_vit == ("test-tiny-rn" not in opts)
    args = cli.build_argparser().parse_args(
        ["--trainer", trainer] + BASE_ARGS[2:] + ["--output-dir", str(tmp_path / "eval"),
                                                  "--eval-only", "--model-dir", str(out)]
        + TINY_OPTS + opts)
    t2 = cli.main(args)
    assert t2.evaluator.y_pred == want


def test_cli_and_build_trainer_default_to_the_card(tmp_path, monkeypatch):
    """Without --device the CLI (and build_trainer without a device) asks for
    cuda and raises on a box without one, instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    monkeypatch.chdir(ROOT)
    args = cli.build_argparser().parse_args(
        [a for a in BASE_ARGS if a not in ("--device", "cpu")] + ["--output-dir", str(tmp_path)]
        + TINY_OPTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
    cfg = cli.setup_cfg(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_trainer(cfg)


def _caltech_tree(root, n_classes=60, per_class=4):
    """A Caltech101-layout tree of small JPEGs (docs/DATASETS.md): one class
    folder per class, plus the two folders the plugin ignores and the ones it
    renames; every kind of JPEG the loaders read, CMYK among them."""
    import io

    from PIL import Image

    kinds = [("RGB", dict(quality=90, subsampling=2)), ("L", dict(quality=85)),
             ("RGB", dict(quality=85, subsampling=0, progressive=True)),
             ("CMYK", dict(quality=85))]
    image_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    names = ["BACKGROUND_Google", "Faces_easy", "Faces", "airplanes"] + [
        f"category_{c:02d}" for c in range(n_classes - 2)]
    rng = np.random.RandomState(0)
    for c, name in enumerate(names):
        os.makedirs(os.path.join(image_dir, name))
        for j in range(per_class):
            mode, opts = kinds[(c + j) % len(kinds)]
            arr = rng.randint(0, 256, (36, 44, {"L": 1, "RGB": 3, "CMYK": 4}[mode]))
            arr = (arr // 4 + 40 * (c % 5)).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(buf, "JPEG", **opts)
            with open(os.path.join(image_dir, name, f"image_{j:04d}.jpg"), "wb") as f:
                f.write(buf.getvalue())


def test_cli_promptsrc_on_a_caltech101_tree(tmp_path, monkeypatch):
    """PromptSRC through the CLI on a real-layout JPEG tree, through --root and
    configs/datasets/caltech101.yaml: the split json and few-shot files, the
    log contract, and the base/new report (Caltech101's 50 base classes of
    60), whose counts follow the run's own predictions; --eval-only
    reproduces them."""
    _caltech_tree(str(tmp_path / "data"))
    monkeypatch.chdir(ROOT)
    out = tmp_path / "run"
    argv = ["--trainer", "PromptSRC", "--seed", "1", "--root", str(tmp_path / "data"),
            "--dataset-config-file", "configs/datasets/caltech101.yaml",
            "--config-file", "configs/trainers/tests/synthetic_tiny.yaml", "--device", "cpu"]
    opts = TINY_OPTS + ["DATASET.NUM_SHOTS", "1", "OPTIM.MAX_EPOCH", "1",
                        "TEST.FINAL_MODEL", "best_val", "TRAINER.PROMPTSRC.CACHED_TEACHER", "True",
                        "DATALOADER.PRE_SIZE", "48"]
    t = cli.main(cli.build_argparser().parse_args(argv + ["--output-dir", str(out)] + opts))
    ds = t.dm.dataset
    assert (t.num_classes, len(ds.train_x), len(ds.val), len(ds.test)) == (60, 60, 60, 60)
    assert "airplane" in ds.classnames and "face" in ds.classnames
    ddir = tmp_path / "data" / "caltech-101"
    assert (ddir / "split_zhou_Caltech101.json").is_file()
    assert os.listdir(ddir / "split_fewshot") == ["shot_1-seed_1.pkl"]
    log = (out / "log.txt").read_text()
    for needle in ("=> result", "* accuracy:", "Classification Report", "Finish training",
                   "Deploy the model with the best val performance",
                   "[PromptSRC] cached teacher image features: (60, 64)",
                   "* device-resident train set: 60 images"):
        assert needle in log, needle
    y_true, y_pred = np.asarray(t.evaluator.y_true), np.asarray(t.evaluator.y_pred)
    for name, mask in (("Base", y_true < 50), ("New ", y_true >= 50)):
        line = (f"{name} class accuracy: {100.0 * (y_pred[mask] == y_true[mask]).mean():.2f}% "
                f"({int((y_pred[mask] == y_true[mask]).sum())}/{int(mask.sum())})")
        assert line in log, line
    t2 = cli.main(cli.build_argparser().parse_args(
        argv + ["--output-dir", str(tmp_path / "eval"), "--eval-only", "--model-dir", str(out)]
        + opts))
    assert t2.evaluator.y_pred == t.evaluator.y_pred
