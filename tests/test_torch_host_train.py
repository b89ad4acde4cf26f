"""The port's trainers on host-augmented batches and the CLI without
DEVICE_AUG, against the JAX package's, on the CPU (test-tiny CLIP: both
packages draw the same random weights from SEED).

- one epoch from both DataManagers (the scripts' default host pipeline):
  PromptSRC under the recipe's list (uint8 shipped, normalized in the
  step), under a list with cutout (float shipped), with "normalize" absent
  (x / 255 in the step, as JAX's TrainTransform), CoOp with LOSS_TYPE
  simclr and PromptSRC with SIMCLR_ALPHA 0.1 on the two-view loader (one
  loader thread: JAX's shared rng is then deterministic); the per-step
  losses within 1e-4 and the prompts at rtol 1e-3 / atol 1e-6
  (tests/test_torch_checkpoint.py's tolerance), the atol widened to 1e-4
  of the epoch's largest update where that is larger (CoOp's NT-Xent at
  LR 0.05 moves the context by up to 0.63 in 3 steps, its fp32 rounding
  with it);
- ``train_step``'s normalize rule on uint8 "img" and "img2";
- the CLI's SimCLR override: JAX's message, the two-view loader after
  build_trainer with the built loader's steps per epoch, and JAX's
  ValueError under DEVICE_AUG;
- ``python -m fsvlm_tpu_torch.train`` without DEVICE_AUG on Synthetic
  against JAX's train.py on the same command line: the same per-step
  losses (PRINT_FREQ 1) within 1e-3 as the logs print them.
"""

import io
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.engine import build_trainer as jax_build_trainer
import fsvlm_tpu.trainers  # noqa: F401
import fsvlm_tpu_torch.trainers  # noqa: F401  (registers the trainers)
from fsvlm_tpu_torch import train as cli
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.trainer import build_trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET_YAML = os.path.join(ROOT, "configs/datasets/synthetic.yaml")
TINY_YAML = os.path.join(ROOT, "configs/trainers/tests/synthetic_tiny.yaml")
PER_CLASS = [6, 6, 4, 4, 2, 2, 1, 1]  # 26 images: 3 steps of 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(out_dir, trainer="PromptSRC", **kw):
    opts = {
        "TRAINER.NAME": trainer, "SEED": 1, "VERBOSE": False, "OUTPUT_DIR": str(out_dir),
        "DATASET.NUM_SHOTS": -1, "DATASET.PER_CLASS_SHOTS": PER_CLASS,
        "DATALOADER.TRAIN_X.SAMPLER": "WeightedClassSampler",
        "DATALOADER.TRAIN_X.BATCH_SIZE": 8, "DATALOADER.DEVICE_AUG": False,
        "DATALOADER.NUM_WORKERS": 1, "OPTIM.LR": 0.05, "OPTIM.MAX_EPOCH": 2,
        "OPTIM.WARMUP_CONS_LR": 0.01, "TRAIN.PRINT_FREQ": 1,
        "TRAINER.PROMPTSRC.PREC": "fp32", "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT": 2,
        "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION": 2, "TRAINER.PROMPTSRC.GPA_MEAN": 1,
        "TRAINER.PROMPTSRC.GPA_STD": 1,
    }
    opts.update(kw)
    flat = [x for kv in opts.items() for x in kv]
    jcfg, pcfg = jax_get_cfg_default(), get_cfg_base()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(DATASET_YAML)
        cfg.merge_from_file(TINY_YAML)
        cfg.merge_from_list(flat)
    return jcfg, pcfg


def _jax_losses(text):
    return [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf) \(", text)]


EPOCH_CASES = {
    "promptsrc_recipe": ("PromptSRC", {}),
    "promptsrc_cutout": ("PromptSRC", {"INPUT.TRANSFORMS": ["random_resized_crop", "random_flip",
                                                            "colorjitter", "cutout",
                                                            "normalize"],
                                       "INPUT.CUTOUT_LEN": 8}),
    "promptsrc_no_normalize": ("PromptSRC", {"INPUT.TRANSFORMS": ["random_resized_crop",
                                                                  "random_flip"]}),
    "coop_simclr": ("CoOp", {"TRAINER.COOP.LOSS_TYPE": "simclr"}),
    "promptsrc_simclr_alpha": ("PromptSRC", {"TRAINER.PROMPTSRC.SIMCLR_ALPHA": 0.1}),
}


@pytest.mark.parametrize("case", sorted(EPOCH_CASES))
def test_host_epoch_matches_jax(case, tmp_path):
    import train as jax_cli  # the JAX package's CLI, at the repo root

    trainer, opts = EPOCH_CASES[case]
    jcfg, pcfg = _cfgs(tmp_path, trainer, **opts)
    jt, pt = jax_build_trainer(jcfg), build_trainer(pcfg, device="cpu")
    with redirect_stdout(io.StringIO()) as jax_out:
        jax_cli.maybe_override_simclr_loader(jcfg, jt)
    with redirect_stdout(io.StringIO()) as port_out:
        cli.maybe_override_simclr_loader(pcfg, pt)
    assert port_out.getvalue() == jax_out.getvalue()
    assert pt.steps_per_epoch == jt.steps_per_epoch == sum(PER_CLASS) // 8
    init = {k: np.asarray(v) for k, v in jt.params.items()}
    jt.epoch = pt.epoch = 0
    with redirect_stdout(io.StringIO()) as jax_log:
        jt.run_epoch()
    with redirect_stdout(io.StringIO()):
        host = pt.run_epoch()
    want = _jax_losses(jax_log.getvalue())
    got = [m["loss"] for m in host]
    assert len(got) == len(want) == pt.steps_per_epoch
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for k, v in jt.params.items():
        ref = np.asarray(v)
        update = np.abs(ref - init[k]).max()
        assert update > 1e-5, k  # the epoch moved the prompts
        np.testing.assert_allclose(pt.params[k].detach().numpy(), ref, rtol=1e-3,
                                   atol=max(1e-6, 1e-4 * update), err_msg=k)


@pytest.mark.parametrize("normalize", [True, False])
def test_train_step_normalizes_uint8_views_as_the_config_says(normalize, tmp_path):
    """The repair: a uint8 "img" / "img2" is normalized as ``eval_images``
    (x / 255 without "normalize"), a float one taken as it is."""
    tfms = ["random_resized_crop", "random_flip"] + (["normalize"] if normalize else [])
    _, pcfg = _cfgs(tmp_path, "PromptSRC", **{"INPUT.TRANSFORMS": tfms,
                                              "TRAINER.PROMPTSRC.SIMCLR_ALPHA": 0.1})
    pt = build_trainer(pcfg, device="cpu")
    u8 = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (8, 32, 32, 3)).astype(np.uint8))
    seen = []
    pt.loss_fn = lambda params, frozen, batch: (
        seen.append({k: batch[k] for k in ("img", "img2")})
        or (sum(p.sum() for p in params.values()) * 0, {}))
    pt.train_step({"img": u8, "img2": u8.float(), "label": np.zeros(8, np.int64)})
    ref = u8.float() / 255.0
    if normalize:
        ref = (ref - torch.tensor(pcfg.INPUT.PIXEL_MEAN)) / torch.tensor(pcfg.INPUT.PIXEL_STD)
    torch.testing.assert_close(seen[0]["img"], ref, rtol=0, atol=1e-6)
    assert torch.equal(seen[0]["img2"], u8.float())  # a float view is taken as it is


def test_simclr_under_device_aug_raises_as_jax(tmp_path):
    import train as jax_cli

    jcfg, pcfg = _cfgs(tmp_path, "CoOp", **{"TRAINER.COOP.LOSS_TYPE": "simclr",
                                            "DATALOADER.DEVICE_AUG": True})
    with pytest.raises(ValueError) as want:
        jax_cli.maybe_override_simclr_loader(jcfg, None)
    with pytest.raises(ValueError) as got:
        cli.maybe_override_simclr_loader(pcfg, None)
    assert str(got.value) == str(want.value) and "DEVICE_AUG" in str(got.value)


BASE_ARGS = ["--seed", "1", "--dataset-config-file", "configs/datasets/synthetic.yaml",
             "--config-file", "configs/trainers/tests/synthetic_tiny.yaml"]
CLI_OPTS = ["TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT", "2", "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION",
            "2", "TRAINER.PROMPTSRC.PREC", "fp32", "DATALOADER.NUM_WORKERS", "1",
            "OPTIM.MAX_EPOCH", "2", "TRAIN.PRINT_FREQ", "1", "TEST.NO_TEST", "True",
            "DATALOADER.TRAIN_X.BATCH_SIZE", "8"]


@pytest.mark.parametrize("trainer,opts", [
    ("PromptSRC", []),
    ("CoOp", ["TRAINER.COOP.LOSS_TYPE", "simclr"]),
])
def test_cli_without_device_aug_matches_jax_train_py(trainer, opts, tmp_path, monkeypatch):
    import train as jax_cli

    monkeypatch.chdir(ROOT)
    argv = ["--trainer", trainer] + BASE_ARGS + CLI_OPTS + opts
    logs = {}
    console = sys.stdout
    for name, mod, extra in (("jax", jax_cli, []), ("port", cli, ["--device", "cpu"])):
        out = tmp_path / name
        args = mod.build_argparser().parse_args(argv[:len(argv) - len(CLI_OPTS + opts)] + extra
                                                + ["--output-dir", str(out)] + CLI_OPTS + opts)
        try:
            with redirect_stdout(io.StringIO()):
                mod.main(args)
                tee = sys.stdout  # the JAX package's log tee stays up after main
                if getattr(tee, "file", None) is not None:
                    tee.close()  # flushes its log.txt before it is read
        finally:
            sys.stdout = console
        logs[name] = (out / "log.txt").read_text()
    if opts:
        for text in logs.values():
            assert ">> SimCLR objective active" in text
    want, got = _jax_losses(logs["jax"]), _jax_losses(logs["port"])
    assert len(got) == len(want) > 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert "DEVICE_AUG: False" in logs["port"] and "Finish training" in logs["port"]
