"""TRAIN.EPOCH_FUSE and TRAIN.DEVICE_SCHEDULE in the port, on the CPU
(test-tiny; the fused path runs its schedule, step counter, lam and metric
buffers eagerly here: the CUDA graph is the card's, tests/test_torch_graphs_cuda.py).

- fused epochs bit-equal to the per-step path: PromptSRC (also with the
  int8 teacher), IVLP with mixup (also with the int8 KD teacher), CoOp
  (CE, focal), CoCoOp, MaPLe, LoRA with dropout, PLIP (grad, svd,
  spectral_norm), LinearProbeCLIP and ZeroshotCLIP, 2 epochs of 3 steps
  from the same seed (prompts, momentum, step count, generator, mixup rng,
  every step's metrics), and ``fused.STEPS`` counting every step once;
- PromptSRC's fused epoch against the JAX package's fused epoch from both
  DataManagers, JAX's crop draws injected (tests/test_torch_checkpoint.py's
  tolerances: rtol 1e-3, atol 1e-6);
- the "auto" / "on" / "off" rules, CoCoOp's veto past BATCHED_TEXT_LIMIT
  (tests/test_cocoop_chunked_eval.py::test_epoch_fuse_auto_veto_past_batched_limit),
  no fusion across ranks or for the zoo;
- a NaN loss raised at the epoch's end, after every step ran;
- DEVICE_SCHEDULE's contract (tests/test_device_resident.py::test_device_schedule_contract):
  JAX's schedule exactly under the sequential sampler, a drop-last
  permutation with its labels and domains under the random one, a new
  order each epoch, the host schedule for any other sampler;
- a resume in the middle of a fused run, bit-equal to the unbroken run.
"""

import numpy as np
import pytest
import torch
from test_torch_checkpoint import _cfgs, _jax_draws

from fsvlm_tpu.engine import build_trainer as jax_build_trainer
from fsvlm_tpu_torch.config import get_cfg_default
from fsvlm_tpu_torch.engine import fused as fused_mod
from fsvlm_tpu_torch.engine.trainer import TRAINER_REGISTRY, SimpleTrainer, build_trainer
from fsvlm_tpu_torch.models.clip.config import ARCHS
from fsvlm_tpu_torch.models.clip.convert import random_clip_params
from fsvlm_tpu_torch.ops import preprocess
from fsvlm_tpu_torch.parallel import mesh
from fsvlm_tpu_torch.trainers import cocoop as cocoop_mod
from fsvlm_tpu_torch.trainers.backbone import clip_from_params
from fsvlm_tpu_torch.trainers.zoo.base import NetTrainerX

N_CLS, N, B = 4, 12, 4  # 3 steps of 4 per epoch
# the TRAINER node whose PREC a trainer reads (LinearProbeCLIP reads none)
PREC_NODE = {"ZeroshotCLIP": "COOP", "LinearProbeCLIP": None}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the tiny steps (the suite's workers contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(trainer, **kw):
    cfg = get_cfg_default()
    opts = {"SEED": 3, "INPUT.SIZE": (32, 32), "INPUT.PIXEL_MEAN": list(preprocess.CLIP_PIXEL_MEAN),
            "INPUT.PIXEL_STD": list(preprocess.CLIP_PIXEL_STD), "DATASET.NAME": "Synthetic",
            "MODEL.BACKBONE.NAME": "test-tiny", "DATALOADER.DEVICE_AUG": True,
            "DATALOADER.TRAIN_X.BATCH_SIZE": B, "OPTIM.NAME": "sgd", "OPTIM.LR": 0.05,
            "OPTIM.MAX_EPOCH": 2, "OPTIM.LR_SCHEDULER": "cosine", "OPTIM.WARMUP_EPOCH": 1,
            "OPTIM.WARMUP_TYPE": "constant", "OPTIM.WARMUP_CONS_LR": 0.02,
            "TRAIN.PRINT_FREQ": 1}
    node = PREC_NODE.get(trainer, trainer.upper())
    if node:
        opts[f"TRAINER.{node}.PREC"] = "fp32"
    opts.update(kw)
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    return cfg


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (N, 40, 40, 3), dtype=np.uint8),
            np.arange(N) % N_CLS)


def _trainer(name, fuse, **kw):
    cfg = _cfg(name, **{"TRAIN.EPOCH_FUSE": fuse, **kw})
    clip = clip_from_params(random_clip_params(ARCHS["test-tiny"], seed=0), ARCHS["test-tiny"],
                            device="cpu")
    images, labels = _data()
    return TRAINER_REGISTRY.get(name)(cfg, [f"class {i}" for i in range(N_CLS)], images, labels,
                                      clip=clip, device="cpu")


def _state(t):
    return {"params": {k: v.detach().clone() for k, v in t.params.items()},
            "optim": [x.clone() for x in t.optim.tensors()] if t.optim else [],
            "generator": t.generator.get_state(), "mix_rng": t.mix_rng.bit_generator.state}


def _assert_bit_equal(a, b):
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert len(a["optim"]) == len(b["optim"])
    assert all(torch.equal(x, y) for x, y in zip(a["optim"], b["optim"]))
    assert torch.equal(a["generator"], b["generator"]) and a["mix_rng"] == b["mix_rng"]


@pytest.mark.parametrize("name,kw", [
    ("PromptSRC", {}),
    ("IVLP", {"TRAINER.IVLP.USE_MIXUP": True, "TRAINER.IVLP.USE_KD": True}),
    ("LoRA", {"TRAINER.LORA.DROPOUT_RATE": 0.25}),
    ("PLIP", {"TRAINER.PLIP.REG_TYPE": "grad", "TRAINER.PLIP.REG_COEFF": 0.5}),
    ("ZeroshotCLIP", {}),
    ("PromptSRC", {"TRAINER.PROMPTSRC.INT8_TEACHER": True}),
    ("IVLP", {"TRAINER.IVLP.USE_KD": True, "TRAINER.IVLP.KD_ALPHA": 0.5,
              "TRAINER.IVLP.INT8_TEACHER": True}),
    ("CoOp", {}),
    ("CoOp", {"TRAINER.COOP.LOSS_TYPE": "focal"}),
    ("CoCoOp", {"TRAINER.COCOOP.N_CTX": 2}),
    ("MaPLe", {}),
    ("PLIP", {"TRAINER.PLIP.REG_TYPE": "svd", "TRAINER.PLIP.REG_COEFF": 0.5}),
    ("PLIP", {"TRAINER.PLIP.REG_TYPE": "spectral_norm", "TRAINER.PLIP.REG_COEFF": 0.5}),
    ("LinearProbeCLIP", {}),
], ids=["PromptSRC", "IVLP-mixup-kd", "LoRA-dropout", "PLIP-grad", "ZeroshotCLIP",
        "PromptSRC-int8-teacher", "IVLP-kd-int8-teacher", "CoOp-ce", "CoOp-focal", "CoCoOp",
        "MaPLe", "PLIP-svd", "PLIP-spectral_norm", "LinearProbeCLIP"])
def test_fused_epochs_bit_equal_to_per_step(name, kw):
    fused, eager = _trainer(name, "on", **kw), _trainer(name, "off", **kw)
    assert fused.fuses_epoch() and not eager.fuses_epoch()
    fused_mod.STEPS.update(dict.fromkeys(fused_mod.STEPS, 0))
    h_fused = fused.train()
    assert fused_mod.STEPS == {"eager": 6, "captured": 0, "replays": 0}  # no graph on the CPU
    h_eager = eager.train()
    assert fused_mod.STEPS["eager"] == 6  # the per-step path is not a fused epoch's
    assert eager._fused is None and int(fused._fused.counter) == 3
    assert h_fused == h_eager and len(h_fused) == 2 and all(len(h) == 3 for h in h_fused)
    assert all(np.isfinite(m["loss"]) for h in h_fused for m in h)
    if fused.optim:
        assert int(fused.optim.count) == 6
    _assert_bit_equal(_state(fused), _state(eager))
    if kw.get("TRAINER.IVLP.USE_MIXUP"):  # the lams went into one buffer, read at the counter
        assert fused.use_mixup and fused.epoch_lams.shape == (3,)


def test_fused_epoch_matches_jax_fused_epoch(tmp_path):
    """Both packages' DataManagers (imbalanced shots, WeightedClassSampler,
    the resident cache), both fused, 2 epochs, the port given JAX's crop
    boxes and flips."""
    jcfg, pcfg = _cfgs(tmp_path, **{"TRAIN.EPOCH_FUSE": "on", "TEST.NO_TEST": True})
    jt, pt = jax_build_trainer(jcfg), build_trainer(pcfg, device="cpu")
    steps = pt.steps_per_epoch
    for epoch in range(2):
        draws = _jax_draws(jcfg, epoch, steps, 8)
        pt.augment = lambda images, aug=None: SimpleTrainer.augment(pt, images, draws.pop(0))
        jt.epoch = pt.epoch = epoch
        jt.run_epoch()
        host = pt.run_epoch()
        assert not draws and len(host) == steps and pt.fuses_epoch()
        for k, v in jt.params.items():
            np.testing.assert_allclose(pt.params[k].detach().numpy(), np.asarray(v), rtol=1e-3,
                                       atol=1e-6, err_msg=f"epoch {epoch} {k}")
    assert int(pt.optim.count) == int(pt._fused.counter) * 2 == 2 * steps


def test_epoch_fuse_modes_and_cocoop_veto(monkeypatch, capsys):
    t = _trainer("PromptSRC", "auto")
    assert t.fuses_epoch()
    for mode, fuses in (("on", True), ("off", False), ("False", False), ("0", False),
                        ("no", False), ("yes", True)):
        t.cfg.TRAIN.EPOCH_FUSE = mode
        assert t.fuses_epoch() is fuses, mode
    t.cfg.TRAIN.EPOCH_FUSE = "auto"
    t._epoch_fuse_auto_off = True  # a trainer's veto binds "auto" only
    assert not t.fuses_epoch()
    t.cfg.TRAIN.EPOCH_FUSE = "on"
    assert t.fuses_epoch()

    def build(limit, fuse):
        monkeypatch.setattr(cocoop_mod, "BATCHED_TEXT_LIMIT", limit)
        return _trainer("CoCoOp", fuse, **{"TRAINER.COCOOP.N_CTX": 2})

    vetoed = build(8, "auto")  # batch 4 x 4 classes = 16 > 8
    assert vetoed._epoch_fuse_auto_off and not vetoed.fuses_epoch()
    assert "[CoCoOp] batch x classes = 4 x 4 > 8: EPOCH_FUSE=auto selects per-step dispatch" in (
        capsys.readouterr().out)

    def boom(*a, **k):
        raise AssertionError("fused epoch entered despite the auto veto")

    monkeypatch.setattr(vetoed, "_run_epoch_fused", boom)
    assert len(vetoed.run_epoch()) == 3  # the per-step path trains the epoch
    forced = build(8, "on")
    assert forced._epoch_fuse_auto_off and forced.fuses_epoch()
    assert len(forced.run_epoch()) == 3 and int(forced._fused.counter) == 3
    below = build(4096, "auto")
    assert not below._epoch_fuse_auto_off and below.fuses_epoch()


def test_no_fusion_across_ranks_or_in_the_zoo(monkeypatch, tmp_path):
    t = _trainer("PromptSRC", "on")
    assert t.fuses_epoch()
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    assert mesh.distributed() and not t.fuses_epoch()
    monkeypatch.undo()
    classes = [TRAINER_REGISTRY.get(n) for n in TRAINER_REGISTRY.registered_names()]
    zoo = [c for c in classes if issubclass(c, NetTrainerX)]
    assert len(zoo) >= 20 and not any(c.epoch_fusion for c in zoo)
    assert all(c.epoch_fusion for c in classes if c not in zoo)
    # without a resident cache nothing fuses, whatever EPOCH_FUSE says
    _, pcfg = _cfgs(tmp_path, **{"TRAIN.EPOCH_FUSE": "on", "DATALOADER.DEVICE_RESIDENT": "off"})
    assert not build_trainer(pcfg, device="cpu").fuses_epoch()


def test_nan_loss_raises_at_the_epoch_end_after_every_step():
    t = _trainer("PromptSRC", "on")
    loss_fn = t.loss_fn
    nan_at = torch.tensor([1.0, float("nan"), 1.0])  # step 1's loss

    def nan_loss(params, frozen, batch):
        loss, aux = loss_fn(params, frozen, batch)
        return loss * nan_at.index_select(0, t._fused.counter.view(1))[0], aux

    t.loss_fn = nan_loss
    t.epoch = 0
    with pytest.raises(FloatingPointError, match="at epoch 0 step 1"):
        t.run_epoch()
    assert int(t._fused.counter) == 3  # steps 2 ran before the raise
    assert int(t.optim.count) == 2  # apply_if_finite skipped the NaN step's update
    assert int(t.optim.notfinite_count) == 0


def test_device_schedule_contract(tmp_path, capsys):
    seq = {"DATALOADER.TRAIN_X.SAMPLER": "SequentialSampler", "TRAIN.DEVICE_SCHEDULE": True,
           "DATASET.PER_CLASS_SHOTS": [6, 6, 4, 4, 3, 2, 1, 1]}  # 27: 3 steps of 8, drop last
    jcfg, pcfg = _cfgs(tmp_path / "seq", **seq)
    jt, pt = jax_build_trainer(jcfg), build_trainer(pcfg, device="cpu")
    assert jt._maybe_device_cache() is not None and pt._maybe_device_cache() is not None
    steps = len(pt.train_loader_x)
    assert steps == 3 == len(jt.train_loader_x)
    ref, got = jt._maybe_device_schedule(steps), pt.device_schedule(steps)
    for k in ("index", "valid", "label", "domain"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    more = pt.device_schedule(4)  # past the set: its last element again, valid False
    assert more["index"][3].tolist() == [24, 25, 26] + [26] * 5
    assert more["valid"][3].tolist() == [True] * 3 + [False] * 5

    _, pcfg = _cfgs(tmp_path / "rand", **{**seq, "DATALOADER.TRAIN_X.SAMPLER": "RandomSampler"})
    pt = build_trainer(pcfg, device="cpu")
    pt._maybe_device_cache()
    data = pt.train_loader_x.wrapper.data_source
    orders = []
    for epoch in (0, 1):
        pt.epoch = epoch
        sched = pt.device_schedule(steps)
        flat = sched["index"].reshape(-1).tolist()
        assert sched["index"].shape == (steps, 8) and sched["valid"].all()
        assert len(set(flat)) == len(flat) <= len(data)  # drop last: part of a permutation
        assert sched["label"].reshape(-1).tolist() == [data[i].label for i in flat]
        assert sched["domain"].reshape(-1).tolist() == [data[i].domain for i in flat]
        assert torch.equal(pt.device_schedule(steps)["index"], sched["index"])  # f(epoch)
        orders.append(flat)
    assert orders[0] != orders[1], "epoch shuffles must differ"
    state = pt.generator.get_state()
    pt.epoch = 0
    assert pt.fuses_epoch() and len(pt.run_epoch()) == steps  # the fused epoch runs on it
    assert pt._fused.index[:steps].reshape(-1).tolist() == orders[0]
    assert not torch.equal(pt.generator.get_state(), state)  # the step's own draws only

    _, pcfg = _cfgs(tmp_path / "weighted", **{"TRAIN.DEVICE_SCHEDULE": True})
    pt = build_trainer(pcfg, device="cpu")  # WeightedClassSampler
    pt._maybe_device_cache()
    capsys.readouterr()
    assert pt.device_schedule(steps) is None
    assert ("TRAIN.DEVICE_SCHEDULE: unsupported sampler WeightedClassSampler; falling back to "
            "host schedule") in capsys.readouterr().out
    pt.cfg.TRAIN.DEVICE_SCHEDULE = False
    assert pt.device_schedule(steps) is None


def test_resume_in_a_fused_run_is_bit_equal(tmp_path):
    """IVLP with mixup over the device schedule (a pure function of the
    epoch, so a resume replays it): 2 epochs unbroken against 1, a resume
    from model.pkl-1 and the second."""
    opts = {"TRAINER.NAME": "IVLP", "TRAIN.EPOCH_FUSE": "on", "TRAIN.DEVICE_SCHEDULE": True,
            "DATALOADER.TRAIN_X.SAMPLER": "RandomSampler", "TEST.NO_TEST": True}
    _, whole = _cfgs(tmp_path / "whole", "IVLP", **opts)
    t = build_trainer(whole, device="cpu")
    t.train()
    _, cut = _cfgs(tmp_path / "cut", "IVLP", **opts)
    t1 = build_trainer(cut, device="cpu")
    t1.train(max_epoch=1)
    t2 = build_trainer(cut, device="cpu")
    history = t2.train()  # resumes from model.pkl-1 at epoch 2 of 2
    assert t2.start_epoch == 1 and len(history) == 1 and t2._fused is not None
    assert t.use_mixup and int(t2.optim.count) == 2 * t.steps_per_epoch
    _assert_bit_equal(_state(t2), _state(t))
