"""The host train pipeline on the card.  Every test here is marked ``cuda``
and skips without a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; skip the suite's JAX-loading conftest there:

    python -m pytest --noconftest -m cuda tests/test_torch_host_cuda.py -q

- the committed fixtures' transform digests
  (tests/torch_fixtures/transforms/expected.json, made from the JAX
  package's Pillow pipeline) on the card's machine, whose compiler builds
  csrc/imaging.cpp anew;
- one epoch of PromptSRC (test-tiny, fp32) on the host pipeline's batches
  on the card (pinned, one batch ahead) against the same epoch on the CPU:
  the losses within 1e-4 and the prompts at rtol 1e-3 / atol 1e-5, and a
  step under sync debug mode 'error' making no synchronizing call.
"""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch import native
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, build_transform

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the host pipeline's step runs there")
    return torch.device("cuda")


def test_transform_digests_on_the_cards_machine(card):
    with open(os.path.join(FIXTURES, "transforms", "expected.json")) as f:
        expected = json.load(f)
    for name, spec in sorted(expected["pipelines"].items()):
        cfg = get_cfg_base()
        cfg.INPUT.TRANSFORMS = tuple(spec["transforms"])
        cfg.INPUT.INTERPOLATION = spec["interpolation"]
        cfg.INPUT.SIZE = tuple(spec["size"])
        cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD = list(CLIP_PIXEL_MEAN), list(CLIP_PIXEL_STD)
        cfg.INPUT.NO_TRANSFORM = spec["no_transform"]
        tfm = build_transform(cfg, is_train=True)
        for i, (f, want) in enumerate(sorted(expected["digests"][name].items())):
            img = native.read_image(os.path.join(FIXTURES, "jpeg", f))
            if spec["no_transform"]:
                x = ((tfm(img) / np.float32(255) - np.float32(CLIP_PIXEL_MEAN))
                     / np.float32(CLIP_PIXEL_STD)).astype(np.float32)
            else:
                x = tfm(img, rng=random.Random(spec["seed"] + i))
            assert list(x.shape) == want["shape"], (name, f)
            if spec["exact"]:
                digest = hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
                assert digest == want["sha256"], (name, f)
            else:
                sample = x.ravel()[::expected["sample_stride"]]
                np.testing.assert_allclose(sample, want["sample"], rtol=0, atol=1e-6)


def _trainer(device):
    from fsvlm_tpu_torch.engine.trainer import build_trainer
    import fsvlm_tpu_torch.trainers  # noqa: F401  (registers the trainers)

    cfg = get_cfg_base()
    cfg.merge_from_file(os.path.join(ROOT, "configs/datasets/synthetic.yaml"))
    cfg.merge_from_file(os.path.join(ROOT, "configs/trainers/tests/synthetic_tiny.yaml"))
    cfg.merge_from_list(["TRAINER.NAME", "PromptSRC", "SEED", 1, "VERBOSE", False,
                         "DATALOADER.DEVICE_AUG", False, "DATALOADER.NUM_WORKERS", 2,
                         "DATALOADER.TRAIN_X.BATCH_SIZE", 8, "TRAINER.PROMPTSRC.PREC", "fp32",
                         "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT", 2,
                         "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION", 2, "OPTIM.LR", 0.05])
    return build_trainer(cfg, device=device)


def test_a_host_epoch_on_the_card_matches_the_cpu(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc, tg = _trainer("cpu"), _trainer("cuda")
    assert tg.train_loader_x.wrapper.uint8 and tg._maybe_device_cache() is None
    ref = tc.run_epoch()
    got = tg.run_epoch()
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in ref], rtol=0,
                               atol=1e-4)
    for k, v in tc.params.items():
        np.testing.assert_allclose(tg.params[k].detach().cpu().numpy(), v.detach().numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    batches = tg.device_batches(tg.train_loader_x)
    batch = next(batches)
    assert batch["img"].is_cuda and batch["img"].dtype == torch.uint8
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tg.train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    batches.close()
