"""The fused epoch's CUDA graph on the card (``engine/fused.py``), at
test-tiny: the captured step replayed against the per-step path.  Every
test here is marked ``cuda`` and skips without a card: a CUDA graph has no
CPU mode (the CPU's fused path runs eagerly, tests/test_torch_epoch_fuse.py).

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py -q

- every CLIP trainer that fuses: PromptSRC (also with the int8 teacher),
  IVLP with mixup and KD (also with the int8 KD teacher), CoOp (CE, focal),
  CoCoOp, MaPLe, LoRA with dropout, PLIP (grad, svd, spectral_norm),
  LinearProbeCLIP and ZeroshotCLIP, 2 epochs of 3 steps fused (warm-up,
  capture, replays; then replays only) against the same epochs step by
  step from the same seed: prompts, momentum, step count, generator, mixup
  rng and every step's metrics bit-equal;
- the launch counters count wrapper calls only: the warm-up's and the
  captured step's (each the per-step epoch's count over its steps), none
  for a replay; ``fused.STEPS`` counts each replay;
- a capture that another trainer's graph, left to the cycle collector,
  outlives (the collector is off during a capture: a graph's teardown
  makes CUDA calls that a capture forbids);
- ``Optimizer.count`` (the LR table's index and the bias corrections' t)
  advancing by one per replay, and a replay that makes no host sync.
"""

import gc

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch.config import get_cfg_default
from fsvlm_tpu_torch.engine import fused as fused_mod
from fsvlm_tpu_torch.engine.trainer import TRAINER_REGISTRY
from fsvlm_tpu_torch.models.clip.config import ARCHS
from fsvlm_tpu_torch.models.clip.convert import random_clip_params
from fsvlm_tpu_torch.ops import preprocess
from fsvlm_tpu_torch.trainers.backbone import clip_from_params

pytestmark = pytest.mark.cuda

N_CLS, N, B = 4, 12, 4  # 3 steps of 4 per epoch
CASES = {
    "PromptSRC": ("PromptSRC", {}),
    "PromptSRC-int8-teacher": ("PromptSRC", {"TRAINER.PROMPTSRC.INT8_TEACHER": True}),
    "IVLP-mixup-kd": ("IVLP", {"TRAINER.IVLP.USE_MIXUP": True, "TRAINER.IVLP.USE_KD": True}),
    "IVLP-kd-int8-teacher": ("IVLP", {"TRAINER.IVLP.USE_KD": True, "TRAINER.IVLP.KD_ALPHA": 0.5,
                                      "TRAINER.IVLP.INT8_TEACHER": True}),
    "CoOp-ce": ("CoOp", {}),
    "CoOp-focal": ("CoOp", {"TRAINER.COOP.LOSS_TYPE": "focal"}),
    "CoCoOp": ("CoCoOp", {"TRAINER.COCOOP.N_CTX": 2}),
    "MaPLe": ("MaPLe", {}),
    "LoRA-dropout": ("LoRA", {"TRAINER.LORA.DROPOUT_RATE": 0.25}),
    "PLIP-grad": ("PLIP", {"TRAINER.PLIP.REG_TYPE": "grad", "TRAINER.PLIP.REG_COEFF": 0.5}),
    "PLIP-svd": ("PLIP", {"TRAINER.PLIP.REG_TYPE": "svd", "TRAINER.PLIP.REG_COEFF": 0.5}),
    "PLIP-spectral_norm": ("PLIP", {"TRAINER.PLIP.REG_TYPE": "spectral_norm",
                                    "TRAINER.PLIP.REG_COEFF": 0.5}),
    "LinearProbeCLIP": ("LinearProbeCLIP", {}),
    "ZeroshotCLIP": ("ZeroshotCLIP", {}),
}
# the TRAINER node whose PREC a trainer reads (LinearProbeCLIP reads none)
PREC_NODE = {"ZeroshotCLIP": "COOP", "LinearProbeCLIP": None}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused epoch's graph has no CPU mode")
    return torch.device("cuda")


def _trainer(case, fuse):
    name, kw = CASES[case]
    cfg = get_cfg_default()
    opts = {"SEED": 3, "INPUT.SIZE": (32, 32), "INPUT.PIXEL_MEAN": list(preprocess.CLIP_PIXEL_MEAN),
            "INPUT.PIXEL_STD": list(preprocess.CLIP_PIXEL_STD), "DATASET.NAME": "Synthetic",
            "MODEL.BACKBONE.NAME": "test-tiny", "DATALOADER.DEVICE_AUG": True,
            "DATALOADER.TRAIN_X.BATCH_SIZE": B, "OPTIM.NAME": "sgd", "OPTIM.LR": 0.05,
            "OPTIM.MAX_EPOCH": 2, "OPTIM.LR_SCHEDULER": "cosine", "OPTIM.WARMUP_EPOCH": 1,
            "OPTIM.WARMUP_TYPE": "constant", "OPTIM.WARMUP_CONS_LR": 0.02,
            "TRAIN.EPOCH_FUSE": fuse, **kw}
    node = PREC_NODE.get(name, name.upper())
    if node:
        opts[f"TRAINER.{node}.PREC"] = "bf16"
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    arch = ARCHS["test-tiny"]
    clip = clip_from_params(random_clip_params(arch, seed=0), arch, dtype=torch.bfloat16,
                            device="cuda")
    rng = np.random.RandomState(0)
    images, labels = rng.randint(0, 256, (N, 40, 40, 3), dtype=np.uint8), np.arange(N) % N_CLS
    return TRAINER_REGISTRY.get(name)(cfg, [f"class {i}" for i in range(N_CLS)], images, labels,
                                      clip=clip, device="cuda")


def _epoch(t, epoch):
    """One epoch, with the launch counters' and ``fused.STEPS``' counts over it."""
    for counter in (*fused_mod.LAUNCH_COUNTERS, fused_mod.STEPS):
        counter.update(dict.fromkeys(counter, 0))
    t.epoch = epoch
    host = t.run_epoch()
    return host, [dict(c) for c in fused_mod.LAUNCH_COUNTERS], dict(fused_mod.STEPS)


@pytest.mark.parametrize("case", list(CASES))
def test_replayed_epochs_bit_equal_to_per_step(card, case):
    fused, eager = _trainer(case, "on"), _trainer(case, "off")
    for epoch in range(2):
        h_fused, l_fused, s_fused = _epoch(fused, epoch)
        h_eager, l_eager, _ = _epoch(eager, epoch)
        assert fused._fused.graph is not None and eager._fused is None
        assert h_fused == h_eager and len(h_fused) == 3
        # the wrappers count the warm-up's and the captured step's calls (2
        # steps of the per-step epoch's 3), and nothing for a replay
        wrapped = 2 if epoch == 0 else 0
        assert s_fused == {"eager": wrapped // 2, "captured": wrapped // 2,
                           "replays": 3 - wrapped // 2}
        for lf, le in zip(l_fused, l_eager):
            assert {k: 3 * n for k, n in lf.items()} == {k: wrapped * n for k, n in le.items()}
        if epoch == 0:  # the captured step's calls: one step's
            assert fused._fused.tally == [{k: n // 3 for k, n in le.items()} for le in l_eager]
    assert sum(fused._fused.tally[0].values()) > 0  # the attention kernels are in the graph
    for k in fused.params:
        assert torch.equal(fused.params[k], eager.params[k]), k
    if fused.optim:  # ZeroshotCLIP trains nothing
        assert all(torch.equal(a, b) for a, b in zip(fused.optim.tensors(),
                                                     eager.optim.tensors()))
    assert torch.equal(fused.generator.get_state(), eager.generator.get_state())
    assert fused.mix_rng.bit_generator.state == eager.mix_rng.bit_generator.state


def test_capture_outlives_a_graph_left_to_the_collector(card, monkeypatch):
    """The captured step drops the last reference to another trainer's
    graph, which a reference cycle keeps for the collector, and makes
    garbage at a threshold that collects at every chance: the capture
    must not let the collector tear that graph down inside it."""
    old = _trainer("PromptSRC", "on")
    _epoch(old, 0)
    assert old._fused.graph is not None
    old.cycle = old
    keep = [old]
    del old
    t = _trainer("IVLP-mixup-kd", "on")
    step = t._fused_step

    def step_dropping_a_graph():
        if torch.cuda.is_current_stream_capturing() and keep:
            keep.clear()
            threshold = gc.get_threshold()
            gc.set_threshold(1)
            try:
                garbage = [[[]] for _ in range(100)]  # the collector counts containers
            finally:
                gc.set_threshold(*threshold)
            del garbage
        return step()

    monkeypatch.setattr(t, "_fused_step", step_dropping_a_graph)
    host, _, steps = _epoch(t, 0)
    assert not keep and steps == {"eager": 1, "captured": 1, "replays": 2} and len(host) == 3
    gc.collect()


def test_count_advances_by_replay_without_a_sync(card):
    t = _trainer("PromptSRC", "on")
    _epoch(t, 0)  # warm-up step, capture, 2 replays
    f = t._fused
    assert int(t.optim.count) == 3 and f.tally and f.timings["capture"] > 0
    f.load(f.index[:3].clone(), f.valid[:3].clone(), f.label[:3].clone())
    f.active = True
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            f.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        f.active = False
    assert int(t.optim.count) == 6 and int(f.counter) == 3
    lr = t.lr_schedule(t.optim.count)  # epoch 2's LR: the table read at the advanced count
    assert float(lr) == np.float32(t.lr_schedule.lr_at_epoch(2))
