"""The port's DataManager-fed trainer, CACHED_TEACHER and checkpoints
against the JAX package's, on the CPU (test-tiny CLIP: both packages draw
the same random weights from SEED).

- PromptSRC's teacher cache against ``_build_teacher_cache`` (fp32, rtol
  1e-4 / atol 1e-5); one epoch of PromptSRC with CACHED_TEACHER from both
  DataManagers (imbalanced PER_CLASS_SHOTS, WeightedClassSampler, the
  resident cache), the port given JAX's crop boxes and flips for each step,
  the prompts at rtol 1e-3 / atol 1e-6 (tests/test_torch_train.py's
  trajectory tolerance);
- checkpoints both ways: the port's ``--eval-only`` on a directory the JAX
  trainer saved gives JAX's predictions and logits (rtol 1e-4 / atol
  1e-5); JAX's ``load_model`` reads the port's state_dict (exactly);
- a resume restores exactly what was saved: the start epoch, the prompts,
  the momentum and step count, the generator's and the mixup rng's states
  and GPA's accumulator; best-val saves leave the resume pointer alone;
  the missing-checkpoint and missing-GPA messages; MODEL.INIT_WEIGHTS
  (tests/test_engine_features.py:13-96).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.engine import build_trainer as jax_build_trainer
from fsvlm_tpu.ops import preprocess as jax_preprocess
import fsvlm_tpu.trainers  # noqa: F401
import fsvlm_tpu_torch.trainers  # noqa: F401  (registers the trainers)
from fsvlm_tpu_torch import train as cli
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.trainer import TRAINER_REGISTRY, SimpleTrainer, build_trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET_YAML = os.path.join(ROOT, "configs/datasets/synthetic.yaml")
TINY_YAML = os.path.join(ROOT, "configs/trainers/tests/synthetic_tiny.yaml")
PER_CLASS = [6, 6, 4, 4, 2, 2, 1, 1]  # imbalanced, 3 steps of 8 per epoch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tests' tiny CPU steps: the suite runs
    several worker processes at once, and their thread pools contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(trainer="PromptSRC", **kw):
    """The override list on top of synthetic.yaml + synthetic_tiny.yaml:
    the imbalanced protocol, the resident device-aug path, batch 8 (one
    row per device of the JAX tests' 8-device mesh), fp32."""
    base = {
        "TRAINER.NAME": trainer, "SEED": 1, "VERBOSE": False,
        "DATASET.NUM_SHOTS": -1, "DATASET.PER_CLASS_SHOTS": PER_CLASS,
        "DATALOADER.TRAIN_X.SAMPLER": "WeightedClassSampler",
        "DATALOADER.TRAIN_X.BATCH_SIZE": 8, "DATALOADER.DEVICE_AUG": True,
        "DATALOADER.PRE_SIZE": 40, "DATALOADER.NUM_WORKERS": 2, "OPTIM.LR": 0.05,
        "OPTIM.MAX_EPOCH": 2, "OPTIM.WARMUP_CONS_LR": 0.01,
        "TRAINER.PROMPTSRC.PREC": "fp32", "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT": 2,
        "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION": 2, "TRAINER.PROMPTSRC.GPA_MEAN": 1,
        "TRAINER.PROMPTSRC.GPA_STD": 1, "TRAINER.COCOOP.PREC": "fp32",
        "TRAINER.COCOOP.N_CTX": 4, "TRAINER.IVLP.PREC": "fp32",
        "TRAINER.IVLP.PROMPT_DEPTH_TEXT": 2, "TRAINER.IVLP.PROMPT_DEPTH_VISION": 2,
        "TRAINER.IVLP.USE_KD": False, "TRAINER.IVLP.USE_MIXUP": True,
    }
    base.update(kw)
    return [x for kv in base.items() for x in kv]


def _cfgs(out_dir, trainer="PromptSRC", **kw):
    opts = _opts(trainer, OUTPUT_DIR=str(out_dir), **kw)
    jcfg, pcfg = jax_get_cfg_default(), get_cfg_base()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(DATASET_YAML)
        cfg.merge_from_file(TINY_YAML)
        cfg.merge_from_list(opts)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def cached_pair(tmp_path_factory):
    """A JAX and a port PromptSRC under CACHED_TEACHER, fed by their
    DataManagers from the same cfg."""
    out = tmp_path_factory.mktemp("cached")
    jcfg, pcfg = _cfgs(out, **{"TRAINER.PROMPTSRC.CACHED_TEACHER": True})
    return jcfg, jax_build_trainer(jcfg), build_trainer(pcfg, device="cpu")


def test_teacher_cache_matches_jax(cached_pair):
    _, jt, pt = cached_pair
    ref = np.asarray(jt.frozen["zs_img_cache"])
    got = pt.frozen["zs_img_cache"].numpy()
    assert got.shape == ref.shape == (sum(PER_CLASS), 64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def _jax_draws(jcfg, epoch, steps, batch):
    """The crop boxes and flips that JAX's fused epoch draws for each step:
    fold_in(fold_in(PRNGKey(SEED), epoch), step), its first split to the
    augmentation (trainer.py:122-129, :186-193), then
    random_resized_crop_flip_normalize's keys."""
    size, scale = jcfg.DATALOADER.PRE_SIZE, tuple(jcfg.INPUT.RRCROP_SCALE)
    epoch_key = jax.random.fold_in(jax.random.PRNGKey(jcfg.SEED), epoch)
    draws = []
    for step in range(steps):
        k_aug = jax.random.split(jax.random.fold_in(epoch_key, step))[0]
        keys = jax.random.split(k_aug, batch + 1)
        flips = jax.random.bernoulli(keys[0], 0.5, (batch,))
        boxes = jax.vmap(lambda k: jnp.stack(jax_preprocess._sample_crop_box(k, size, size, scale)))(
            keys[1:])
        draws.append((torch.from_numpy(np.array(boxes)), torch.from_numpy(np.array(flips))))
    return draws


def test_cached_teacher_epoch_from_both_data_managers_matches_jax(cached_pair):
    jcfg, jt, pt = cached_pair
    assert pt.steps_per_epoch == jt.steps_per_epoch == sum(PER_CLASS) // 8
    draws = _jax_draws(jcfg, 0, pt.steps_per_epoch, 8)
    pt.augment = lambda images, aug=None: SimpleTrainer.augment(pt, images, draws.pop(0))
    init = {k: np.asarray(v) for k, v in jt.params.items()}
    jt.epoch = pt.epoch = 0
    jt.run_epoch()
    host = pt.run_epoch()
    assert not draws and len(host) == pt.steps_per_epoch
    assert all(np.isfinite(m["loss"]) for m in host)
    for k, v in jt.params.items():
        ref = np.asarray(v)
        assert np.abs(ref - init[k]).max() > 1e-4, k  # the epoch moved the prompts
        np.testing.assert_allclose(pt.params[k].detach().numpy(), ref, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    assert int(pt.optim.count) == pt.steps_per_epoch


def test_cached_teacher_needs_the_data_manager():
    """A tensor-fed PromptSRC has no train set to take the eval view of:
    CACHED_TEACHER raises, naming the DataManager-fed constructor."""
    from fsvlm_tpu_torch.trainers.backbone import load_clip_backbone
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    _, pcfg = _cfgs("unused", **{"TRAINER.PROMPTSRC.CACHED_TEACHER": True})
    clip = load_clip_backbone("test-tiny", device="cpu")
    with pytest.raises(ValueError, match="build the trainer from cfg alone"):
        PromptSRC(pcfg, ["cat", "dog"], np.zeros((4, 40, 40, 3), np.uint8), np.zeros(4),
                  clip=clip, device="cpu")


def _perturb_jax(jt, seed):
    rng = np.random.RandomState(seed)
    jt.params = jax.tree.map(lambda x: x + 0.05 * rng.randn(*x.shape).astype(np.float32),
                             jt.params)


@pytest.mark.parametrize("trainer", ["PromptSRC", "CoCoOp"])
def test_port_eval_only_on_a_jax_checkpoint_matches_jax(tmp_path, trainer, monkeypatch):
    jcfg, _ = _cfgs(tmp_path / "jax", trainer)
    jt = jax_build_trainer(jcfg)
    _perturb_jax(jt, 3)
    jt.save_model(0, jcfg.OUTPUT_DIR)  # model.pkl-1, with optax's optimizer state
    ref_true, ref_pred = jt.test(return_pred=True)
    ref_logits = []
    for batch in jt.test_loader:
        imgs = batch["img"]
        if jt._text_step is not None:
            lg = jt._eval_with_txf(jt.params, jt.frozen, imgs, jt._text_step(jt.params, jt.frozen))
        else:
            lg = jt._eval_step(jt.params, jt.frozen, imgs)
        ref_logits.append(np.asarray(lg)[batch["valid"]])

    logits = []
    target = TRAINER_REGISTRY.get(trainer)
    name = "image_logits_fn" if trainer == "PromptSRC" else "logits_fn"
    inner = getattr(target, name)
    monkeypatch.setattr(target, name, lambda self, *a: logits.append(inner(self, *a)) or logits[-1])
    args = cli.build_argparser().parse_args(
        ["--eval-only", "--model-dir", jcfg.OUTPUT_DIR, "--load-epoch", "1", "--device", "cpu",
         "--dataset-config-file", DATASET_YAML, "--config-file", TINY_YAML,
         "--output-dir", str(tmp_path / "port")] + [str(x) for x in _opts(trainer)])
    pt = cli.main(args)
    assert pt.evaluator.y_true == list(ref_true) and pt.evaluator.y_pred == list(ref_pred)
    got = np.concatenate([lg.numpy()[:len(r)] for lg, r in zip(logits, ref_logits)])
    np.testing.assert_allclose(got, np.concatenate(ref_logits), rtol=1e-4, atol=1e-5)
    with open(os.path.join(str(tmp_path / "port"), "log.txt")) as f:
        assert "* accuracy:" in f.read()


@pytest.mark.parametrize("trainer", ["PromptSRC", "CoCoOp"])
def test_jax_load_model_reads_a_port_checkpoint(tmp_path, trainer):
    jcfg, pcfg = _cfgs(tmp_path, trainer)
    pt = build_trainer(pcfg, device="cpu")
    with torch.no_grad():
        for p in pt.params.values():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(4)))
    pt.save_model(0, pcfg.OUTPUT_DIR)
    with open(os.path.join(pcfg.OUTPUT_DIR, pt.model_name, "model.pkl-1"), "rb") as f:
        raw = pickle.load(f)  # builtins and numpy only
    assert raw["epoch"] == 1 and set(raw) == {"state_dict", "epoch", "optimizer", "val_result",
                                              "extra"}
    jt = jax_build_trainer(jcfg)
    jt.load_model(pcfg.OUTPUT_DIR, epoch=1)
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(jt.params)}
    assert len(flat) == len(pt.params)
    for name, p in pt.params.items():
        key = "".join(f"['{part}']" for part in name.split("."))
        np.testing.assert_array_equal(flat[key], p.detach().numpy(), err_msg=name)


def _state(t):
    return {
        "params": {k: v.detach().clone() for k, v in t.params.items()},
        "trace": [x.clone() for x in t.optim.trace],
        "count": int(t.optim.count),
        "generator": t.generator.get_state().clone(),
        "mix_rng": t.mix_rng.bit_generator.state,
        "gpa": {k: v.clone() for k, v in (getattr(t, "gpa_params", None) or {}).items()},
        "best": t.best_result,
    }


@pytest.mark.parametrize("trainer", ["PromptSRC", "IVLP"])
def test_resume_restores_exactly_what_was_saved(tmp_path, trainer):
    _, pcfg = _cfgs(tmp_path, trainer, **{"OPTIM.MAX_EPOCH": 3, "TRAIN.CHECKPOINT_FREQ": 1,
                                          "TEST.FINAL_MODEL": "best_val"})
    t = build_trainer(pcfg, device="cpu")
    after_epoch, snapshots = t.after_epoch, []
    t.after_epoch = lambda: (after_epoch(), snapshots.append(_state(t)))
    t.train(max_epoch=2)  # after it, the best-val prompts are deployed
    saved = snapshots[-1]  # as the epoch-2 checkpoint was written
    assert saved["count"] == 2 * t.steps_per_epoch and (trainer != "PromptSRC" or saved["gpa"])

    t2 = build_trainer(pcfg, device="cpu")
    assert t2.resume_model_if_exist(pcfg.OUTPUT_DIR) == 2 and t2.start_epoch == 2
    got = _state(t2)
    for k in saved["params"]:
        torch.testing.assert_close(got["params"][k], saved["params"][k], rtol=0, atol=0)
    for a, b in zip(got["trace"], saved["trace"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got["count"] == saved["count"] and got["best"] == saved["best"] > -np.inf
    assert torch.equal(got["generator"], saved["generator"]) and got["mix_rng"] == saved["mix_rng"]
    assert got["gpa"].keys() == saved["gpa"].keys()
    for k in saved["gpa"]:
        torch.testing.assert_close(got["gpa"][k], saved["gpa"][k], rtol=0, atol=0)
    history = t2.train()  # resumes at epoch 3 of 3 and finishes
    assert len(history) == 1 and int(t2.optim.count) == 3 * t.steps_per_epoch


def test_best_val_save_does_not_move_the_resume_pointer(tmp_path):
    _, pcfg = _cfgs(tmp_path, "CoCoOp", **{"TEST.NO_TEST": True, "OPTIM.MAX_EPOCH": 2})
    t = build_trainer(pcfg, device="cpu")
    t.train()
    mdir = os.path.join(pcfg.OUTPUT_DIR, "prompt_learner")
    assert sorted(os.listdir(mdir)) == ["checkpoint", "model.pkl-2"]
    t.save_model(0, pcfg.OUTPUT_DIR, val_result=99.0, model_name="model-best.pkl")
    with open(os.path.join(mdir, "checkpoint")) as f:
        assert f.read().strip() == "model.pkl-2"
    assert build_trainer(pcfg, device="cpu").resume_model_if_exist(pcfg.OUTPUT_DIR) == 2


def test_missing_checkpoint_and_missing_gpa_are_announced(tmp_path, capsys):
    jcfg, pcfg = _cfgs(tmp_path)
    t = build_trainer(pcfg, device="cpu")
    assert t.resume_model_if_exist(str(tmp_path / "nonexistent")) == 0
    assert "No checkpoint found" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        t.load_model(str(tmp_path / "nonexistent"))
    jt = jax_build_trainer(jcfg)  # a JAX checkpoint before any epoch: no GPA accumulator
    jt.save_model(0, pcfg.OUTPUT_DIR)
    capsys.readouterr()
    assert t.resume_model_if_exist(pcfg.OUTPUT_DIR) == 1
    out = capsys.readouterr().out
    assert "without gpa_params" in out and "momentum" in out and t.gpa_params is None


def test_init_weights_load_the_checkpoint_prompts(tmp_path):
    _, pcfg = _cfgs(tmp_path / "a", "CoCoOp")
    t = build_trainer(pcfg, device="cpu")
    with torch.no_grad():
        for p in t.params.values():
            p.mul_(-2.0)
    t.save_model(4, pcfg.OUTPUT_DIR)
    _, pcfg2 = _cfgs(tmp_path / "b", "CoCoOp", **{
        "MODEL.INIT_WEIGHTS": os.path.join(pcfg.OUTPUT_DIR, "prompt_learner", "model.pkl-5")})
    t2 = build_trainer(pcfg2, device="cpu")
    for k, p in t.params.items():
        torch.testing.assert_close(t2.params[k], p, rtol=0, atol=0)
    assert t2.optim.params[0] is t2.params["ctx"]  # loaded in place, under the optimizer


@pytest.mark.parametrize("name,match", [
    ("SupBaseline", "Dassl zoo's SSL trainers, not ported yet [(]ROADMAP A9[)]"),
    ("FixMatch", "ROADMAP A9"),
    ("EntMin", "ROADMAP A9"),
    ("MixMatch", "ROADMAP A9"),
    ("NoSuchTrainer", "No trainer 'NoSuchTrainer'; ported: .*'PLIP'"),
])
def test_unported_trainer_names_the_roadmap_item(tmp_path, name, match):
    """A name of the JAX package's SSL zoo trainers names ROADMAP A9; any other
    unknown name lists the ported trainers (PLIP among them)."""
    _, pcfg = _cfgs(tmp_path, name)
    with pytest.raises(KeyError, match=match):
        build_trainer(pcfg, device="cpu")


@pytest.mark.parametrize("mode", ["off", "over_budget"])
def test_loader_fed_steps_match_the_resident_ones(tmp_path, mode, capsys):
    """DATALOADER.DEVICE_RESIDENT off (or a set over its budget) feeds each
    step the loader's uint8 batch instead of a gather from the device
    cache: the same sampler order, images and draws, so the same epoch."""
    kw = ({"DATALOADER.DEVICE_RESIDENT": "off"} if mode == "off"
          else {"DATALOADER.DEVICE_RESIDENT_BUDGET_MB": 0})
    _, pcfg = _cfgs(tmp_path / "a")
    _, pcfg_loader = _cfgs(tmp_path / "b", **kw)
    resident, fed = build_trainer(pcfg, device="cpu"), build_trainer(pcfg_loader, device="cpu")
    for t in (resident, fed):
        t.run_epoch()
    assert resident.cache is not None and fed.cache is None
    assert ("device-resident train set disabled" in capsys.readouterr().out) == (mode != "off")
    for k, p in resident.params.items():
        torch.testing.assert_close(fed.params[k], p, rtol=0, atol=0)
    assert torch.equal(fed.generator.get_state(), resident.generator.get_state())
