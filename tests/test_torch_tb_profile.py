"""The port's TensorBoard scalars (fsvlm_tpu_torch/engine/tb.py) and its
FSVLM_PROFILE_DIR trace, on the CPU.

One tiny PromptSRC run through each CLI (the JAX package's train.py and
``fsvlm_tpu_torch.train``; Synthetic, test-tiny, 2 epochs, best-val) in
this process.  Both write real event files (the test needs tensorflow,
for the JAX package's writer, and tensorboard): the set of tags and each
tag's steps, read back with TensorBoard's ``EventAccumulator``, must be the
same (the JAX package writes TF2 tensor summaries, the port scalar ones).
The values are not compared: the two runs draw different crops (ROADMAP
C.3); the learning rate, which draws nothing, is.  The port's run also
sets FSVLM_PROFILE_DIR: one Chrome trace file, whose operators are the
train steps' and the val passes' (one ``aten::isfinite`` per gradient per
step: the optimizer's guard) and not the final test's.
"""

import glob
import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from fsvlm_tpu_torch import train as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--trainer", "PromptSRC", "--seed", "1",
        "--dataset-config-file", "configs/datasets/synthetic.yaml",
        "--config-file", "configs/trainers/tests/synthetic_tiny.yaml"]
OPTS = ["TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT", "2", "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION", "2",
        "TRAINER.PROMPTSRC.PREC", "fp32", "DATALOADER.NUM_WORKERS", "1", "OPTIM.MAX_EPOCH", "2",
        "TEST.FINAL_MODEL", "best_val", "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
        "DATALOADER.DEVICE_AUG", "True"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax"|"port": (output dir, trainer)}, and the port's profile dir."""
    import train as jax_cli  # the JAX package's CLI, at the repo root

    tmp = tmp_path_factory.mktemp("tb")
    cwd, console, threads = os.getcwd(), sys.stdout, torch.get_num_threads()
    env = {k: os.environ.get(k) for k in ("FSVLM_PROFILE_DIR", "FSVLM_EXTRA_OPTS")}
    os.environ.pop("FSVLM_EXTRA_OPTS", None)
    os.chdir(ROOT)
    torch.set_num_threads(1)
    out = {}
    try:
        for name, mod, extra in (("jax", jax_cli, []), ("port", cli, ["--device", "cpu"])):
            if name == "port":
                os.environ["FSVLM_PROFILE_DIR"] = str(tmp / "profile")
            args = mod.build_argparser().parse_args(
                ARGV + extra + ["--output-dir", str(tmp / name)] + OPTS)
            try:
                with redirect_stdout(io.StringIO()):
                    trainer = mod.main(args)
                    tee = sys.stdout  # the JAX package's log tee stays up after main
                    if name == "jax" and getattr(tee, "file", None) is not None:
                        tee.close()
            finally:
                sys.stdout = console
            out[name] = (tmp / name, trainer)
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, tmp / "profile"


def _series(out_dir, kind):
    """{tag: [(step, value)]} of the run's event files."""
    files = glob.glob(os.path.join(out_dir, "tensorboard", "events.out.tfevents.*"))
    assert len(files) == 1, files
    ea = EventAccumulator(os.path.join(out_dir, "tensorboard"), size_guidance={kind: 0})
    ea.Reload()
    if kind == "scalars":
        return {t: [(e.step, e.value) for e in ea.Scalars(t)] for t in ea.Tags()["scalars"]}
    from tensorboard.util import tensor_util

    return {t: [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                for e in ea.Tensors(t)] for t in ea.Tags()["tensors"]}


def test_scalars_have_jax_tags_and_steps(runs):
    (jax_dir, _), (port_dir, trainer) = runs[0]["jax"], runs[0]["port"]
    want, got = _series(jax_dir, "tensors"), _series(port_dir, "scalars")
    assert set(got) == set(want)
    assert {"train/loss", "train/lr", "val/accuracy", "test/accuracy", "test/macro_f1"} <= set(got)
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
    n = trainer.steps_per_epoch
    assert [s for s, _ in got["train/loss"]] == list(range(2 * n))
    assert [s for s, _ in got["val/accuracy"]] == [0, 1] and [s for s, _ in got["test/accuracy"]] == [1]
    assert [v for _, v in got["train/lr"]] == pytest.approx([v for _, v in want["train/lr"]])


def test_profile_dir_holds_one_trace_of_the_train_window(runs):
    (_, trainer), profile_dir = runs[0]["port"], runs[1]
    files = os.listdir(profile_dir)
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(profile_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("ph") == "X"]
    steps = 2 * trainer.steps_per_epoch
    assert names.count("aten::isfinite") == steps * len(trainer.params)
    assert any(n in ("aten::mm", "aten::addmm", "aten::bmm") for n in names)
