"""The port's PromptSRC serving path (PromptSRCPredictor on the CPU) against
the JAX package's serving functions on the same weights and prompts, a
JAX-written prompt checkpoint loaded into the port, and the import boundary.

fp32; logits atol 1e-3 and identical top-1.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvlm_tpu.engine.checkpoint import save_checkpoint
from fsvlm_tpu.models.clip import clip_logits, l2_normalize
from fsvlm_tpu.models.clip.config import CLIPConfig as JaxCLIPConfig
from fsvlm_tpu.ops.preprocess import normalize_only
from fsvlm_tpu.trainers import ivlp_family as jax_family
from fsvlm_tpu_torch.models.clip import CLIPConfig, random_clip_params
from fsvlm_tpu_torch.serve import PromptSRCPredictor, PromptSRCServeConfig
from fsvlm_tpu_torch.trainers.backbone import clip_from_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (64, 32, 2, 128, 16, 77, 49408, 128, 2, 2)
CLASSNAMES = ["cat", "golden_retriever", "aircraft carrier", "sea", "Ferrari 250 GTO"]
NODE = PromptSRCServeConfig()  # the yaml's values: 4+4 ctx, depth 9 (capped at 2 layers)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    params = random_clip_params(CLIPConfig(*TINY), seed=3)
    images = np.random.RandomState(4).randint(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    clip = clip_from_params(params, CLIPConfig(*TINY), device="cpu")
    pred = PromptSRCPredictor(CLASSNAMES, node=NODE, clip=clip, seed=3, device="cpu")
    return params, images, pred


def _jax_logits(params, classnames, prompt_params, images, seed=3):
    cfg = types.SimpleNamespace(MODEL=types.SimpleNamespace(TEXT_TRUNCATE=NODE.TEXT_TRUNCATE))
    frozen, pc = jax_family.build_vlp_frozen(cfg, NODE, params, JaxCLIPConfig(*TINY),
                                             classnames, seed)
    if prompt_params is None:
        prompt_params = jax_family.init_vlp_params(NODE, JaxCLIPConfig(*TINY), pc,
                                                   np.random.RandomState(seed))
    txf = l2_normalize(jax_family.vlp_text_features(prompt_params, frozen, JaxCLIPConfig(*TINY),
                                                    jnp.float32))
    imf = jax_family.vlp_image_features(prompt_params, frozen, JaxCLIPConfig(*TINY),
                                        normalize_only(images), jnp.float32)
    logits = jnp.exp(frozen["clip"]["logit_scale"]) * l2_normalize(imf) @ txf.T
    return np.asarray(logits), prompt_params, np.asarray(imf), np.asarray(txf)


def test_predictor_matches_jax_serving(setup):
    params, images, pred = setup
    ref, ref_prompts, ref_imf, ref_txf = _jax_logits(params, CLASSNAMES, None, images)
    assert sorted(pred.prompt_params) == sorted(ref_prompts)
    for k, v in ref_prompts.items():  # same RandomState draws
        np.testing.assert_array_equal(pred.prompt_params[k].numpy(), np.asarray(v), err_msg=k)
    assert pred.compute_dtype == torch.float32
    np.testing.assert_allclose(pred.text_features().numpy(), ref_txf, atol=1e-4)
    np.testing.assert_allclose(pred.image_features(images).numpy(), ref_imf, rtol=1e-4, atol=1e-4)
    logits = pred.image_logits(images).numpy()
    np.testing.assert_allclose(logits, ref, atol=1e-3)
    assert (logits.argmax(1) == ref.argmax(1)).all()
    ref_clip = np.asarray(clip_logits(ref_imf, ref_txf, params["logit_scale"]))
    np.testing.assert_allclose(logits, ref_clip, atol=1e-3)


def test_predict_topk_matches_predict_tool_math(setup):
    _, images, pred = setup
    top = pred.predict(images, topk=3)
    logits = pred.image_logits(images).double().numpy()
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    assert len(top) == len(images) and all(len(row) == 3 for row in top)
    for row, pr in zip(top, probs):
        idx = np.argsort(-pr)[:3]
        assert [n for n, _ in row] == [CLASSNAMES[i] for i in idx]
        np.testing.assert_allclose([p for _, p in row], pr[idx], rtol=1e-12)
    assert len(pred.predict(images[:1], topk=50)[0]) == len(CLASSNAMES)


def test_predictor_loads_jax_written_checkpoint(setup, tmp_path):
    import optax

    params, images, pred = setup
    _, ref_prompts, _, _ = _jax_logits(params, CLASSNAMES, None, images)
    rng = np.random.RandomState(9)
    trained = {k: np.asarray(v) + (0.05 * rng.randn(*np.shape(v))).astype(np.float32)
               for k, v in ref_prompts.items()}
    opt_state = optax.sgd(0.01, momentum=0.9).init(trained)
    for epoch, best in ((1, True), (2, False)):
        state = trained if best else {k: v + 1.0 for k, v in trained.items()}
        save_checkpoint({"state_dict": state, "epoch": epoch, "optimizer": opt_state,
                         "val_result": 50.0, "extra": {"best_result": 50.0}},
                        str(tmp_path / "VLPromptLearner"), is_best=best)
    ref, _, _, _ = _jax_logits(params, CLASSNAMES, trained, images)

    pred2 = PromptSRCPredictor(CLASSNAMES, node=NODE, clip=pred.clip, seed=3, device="cpu")
    pred2.text_features()  # the cache must be dropped by load_model
    pred2.load_model(str(tmp_path))  # model-best.pkl: epoch 1
    for k, v in trained.items():
        np.testing.assert_array_equal(pred2.prompt_params[k].numpy(), v, err_msg=k)
    logits = pred2.image_logits(images).numpy()
    np.testing.assert_allclose(logits, ref, atol=1e-3)
    assert (logits.argmax(1) == ref.argmax(1)).all()
    pred2.load_model(str(tmp_path), epoch=2)
    np.testing.assert_array_equal(pred2.prompt_params["ctx"].numpy(), trained["ctx"] + 1.0)


def test_predictor_requires_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        PromptSRCPredictor(CLASSNAMES)


@pytest.mark.parametrize("entry", ["load_clip_backbone", "clip_from_params", "CLIP", "causal_mask",
                                   "PromptSRC", "make_lr_schedule", "CoOp", "CoCoOp", "LoRA",
                                   "MaPLe", "ZeroshotCLIP", "ZeroshotCLIP2", "LinearProbeCLIP",
                                   "predict", "interpret_prompt", "nearest_tokens",
                                   "LogisticRegression", "lpclip", "export_serving"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """With no device given, every entry point asks for cuda, and raises on
    a box without one instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    from fsvlm_tpu_torch.config import get_cfg_default
    from fsvlm_tpu_torch.engine.optim import make_lr_schedule
    from fsvlm_tpu_torch.models.clip import CLIP
    from fsvlm_tpu_torch.ops.attention import causal_mask
    from fsvlm_tpu_torch.trainers.backbone import load_clip_backbone
    from fsvlm_tpu_torch.trainers.cocoop import CoCoOp
    from fsvlm_tpu_torch.trainers.coop import CoOp
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    calls = {
        "load_clip_backbone": lambda: load_clip_backbone("test-tiny"),
        "clip_from_params": lambda: clip_from_params(random_clip_params(CLIPConfig(*TINY)),
                                                     CLIPConfig(*TINY)),
        "CLIP": lambda: CLIP(CLIPConfig(*TINY)),
        "causal_mask": lambda: causal_mask(8),
        "PromptSRC": lambda: PromptSRC(get_cfg_default(), ["cat", "dog"],
                                       np.zeros((4, 32, 32, 3), np.uint8), np.zeros(4)),
        "make_lr_schedule": lambda: make_lr_schedule(get_cfg_default(), 10),
        "CoOp": lambda: CoOp(get_cfg_default(), ["cat", "dog"]),
        "CoCoOp": lambda: CoCoOp(get_cfg_default(), ["cat", "dog"]),
    }
    from fsvlm_tpu_torch.trainers import linear_probe, lora, maple, zsclip

    for cls in (lora.LoRA, maple.MaPLe, zsclip.ZeroshotCLIP, zsclip.ZeroshotCLIP2,
                linear_probe.LinearProbeCLIP):
        calls[cls.__name__] = lambda cls=cls: cls(get_cfg_default(), ["cat", "dog"])
    from fsvlm_tpu_torch.tools import interpret_prompt, predict

    fixture = os.path.join(REPO, "tests", "torch_fixtures", "jpeg", "gray_280x210.jpg")
    calls["predict"] = lambda: predict.main(predict.build_argparser().parse_args([
        "--trainer", "ZeroshotCLIP", "--dataset-config-file",
        os.path.join(REPO, "configs/datasets/synthetic.yaml"), "--images", fixture]))
    ckpt = tmp_path / "model.pkl-1"
    with open(ckpt, "wb") as f:
        pickle.dump({"state_dict": {"ctx": np.zeros((2, 64), np.float32)}, "epoch": 1}, f)
    calls["interpret_prompt"] = lambda: interpret_prompt.main([str(ckpt), "--backbone",
                                                               "test-tiny"])
    calls["nearest_tokens"] = lambda: interpret_prompt.nearest_tokens(np.zeros((1, 4)),
                                                                      np.zeros((3, 4)), 1)
    from fsvlm_tpu_torch.tools import export_serving, logreg, lpclip

    calls["LogisticRegression"] = lambda: logreg.LogisticRegression().fit(np.eye(2), [0, 1])
    calls["lpclip"] = lambda: lpclip.main(["--root", str(tmp_path), "--dataset-config-file",
                                           os.path.join(REPO, "configs/datasets/synthetic.yaml")])
    calls["export_serving"] = lambda: export_serving.main(["--arch", "test-tiny", "--out",
                                                           str(tmp_path / "s.pt2")])
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


_BOUNDARY = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import fsvlm_tpu_torch.serve as serve
import fsvlm_tpu_torch.config, fsvlm_tpu_torch.engine.optim, fsvlm_tpu_torch.engine.trainer
import fsvlm_tpu_torch.ops.preprocess, fsvlm_tpu_torch.ops.kernels.build
import fsvlm_tpu_torch.trainers.ivlp, fsvlm_tpu_torch.trainers.losses
import fsvlm_tpu_torch.trainers.templates
from fsvlm_tpu_torch.ops.flash_attention import attention_dispatch, blockwise_attention
from fsvlm_tpu_torch.trainers.backbone import load_clip_backbone
from fsvlm_tpu_torch.trainers.ivlp import IVLP
from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC
clip = load_clip_backbone("test-tiny", device="cpu")
pred = serve.PromptSRCPredictor(["cat", "dog"], clip=clip, device="cpu")
top = pred.predict(np.zeros((2, 32, 32, 3), np.uint8), topk=2)
assert len(top) == 2 and len(top[0]) == 2, top
cfg = fsvlm_tpu_torch.config.get_cfg_default()
cfg.INPUT.SIZE, cfg.DATALOADER.DEVICE_AUG, cfg.OPTIM.MAX_EPOCH = (32, 32), True, 1
trainer = PromptSRC(cfg, ["cat", "dog"], np.zeros((4, 40, 40, 3), np.uint8), np.zeros(4),
                    clip=clip, device="cpu")
assert np.isfinite(trainer.train()[0][0]["loss"])
cfg.TRAINER.IVLP.USE_MIXUP = True
trainer = IVLP(cfg, ["cat", "dog"], np.zeros((4, 40, 40, 3), np.uint8), np.zeros(4),
               clip=clip, device="cpu")
assert np.isfinite(trainer.train()[0][0]["loss"])
from fsvlm_tpu_torch.trainers.cocoop import CoCoOp
from fsvlm_tpu_torch.trainers.coop import CoOp
for cls in (CoOp, CoCoOp):
    trainer = cls(cfg, ["cat", "dog"], np.zeros((4, 40, 40, 3), np.uint8), np.zeros(4), clip=clip,
                  device="cpu")
    assert np.isfinite(trainer.train()[0][0]["loss"])
    assert 0 <= trainer.test(np.zeros((3, 32, 32, 3), np.uint8), np.zeros(3)) <= 100
from fsvlm_tpu_torch.trainers.linear_probe import LinearProbeCLIP
from fsvlm_tpu_torch.trainers.lora import LoRA
from fsvlm_tpu_torch.trainers.maple import MaPLe
from fsvlm_tpu_torch.trainers.zsclip import ZeroshotCLIP, ZeroshotCLIP2
for cls in (LoRA, MaPLe, ZeroshotCLIP, ZeroshotCLIP2, LinearProbeCLIP):
    trainer = cls(cfg, ["cat", "dog"], np.zeros((4, 40, 40, 3), np.uint8), np.zeros(4), clip=clip,
                  device="cpu")
    assert np.isfinite(trainer.train()[0][0]["loss"])
    assert 0 <= trainer.test(np.zeros((3, 32, 32, 3), np.uint8), np.zeros(3)) <= 100
from fsvlm_tpu_torch.trainers.plip import PLIP
for reg_type in ("grad", "svd", "spectral_norm"):
    cfg.TRAINER.PLIP.REG_TYPE = reg_type
    trainer = PLIP(cfg, ["cat", "dog"], np.zeros((4, 40, 40, 3), np.uint8), np.zeros(4), clip=clip,
                   device="cpu")
    assert np.isfinite(trainer.train()[0][0]["loss"])
rn = load_clip_backbone("test-tiny-rn", device="cpu")
cfg.INPUT.SIZE = (64, 64)
trainer = CoOp(cfg, ["cat", "dog"], np.zeros((4, 72, 72, 3), np.uint8), np.zeros(4), clip=rn,
               device="cpu")
assert np.isfinite(trainer.train()[0][0]["loss"])
assert 0 <= trainer.test(np.zeros((3, 64, 64, 3), np.uint8), np.zeros(3)) <= 100
cfg.INPUT.SIZE = (32, 32)
import torch
from fsvlm_tpu_torch.ops.flash_attention import fused_attention
q = torch.zeros(1, 2, 5, 48)
assert blockwise_attention(q, q, q).shape == attention_dispatch(q, q, q).shape == q.shape
assert fused_attention(q, q, q).shape == q.shape
import fsvlm_tpu_torch.data, fsvlm_tpu_torch.data.imageops, fsvlm_tpu_torch.engine.checkpoint
import fsvlm_tpu_torch.train, fsvlm_tpu_torch.trainers, fsvlm_tpu_torch.utils
import os, tempfile
out = tempfile.mkdtemp()
os.chdir({repo!r})
args = fsvlm_tpu_torch.train.build_argparser().parse_args([
    "--trainer", "PromptSRC", "--seed", "1", "--device", "cpu", "--output-dir", out,
    "--dataset-config-file", "configs/datasets/synthetic.yaml",
    "--config-file", "configs/trainers/tests/synthetic_tiny.yaml", "OPTIM.MAX_EPOCH", "1",
    "DATALOADER.DEVICE_AUG", "True", "TRAINER.PROMPTSRC.CACHED_TEACHER", "True",
    "TEST.FINAL_MODEL", "best_val"])
os.environ["FSVLM_PROFILE_DIR"] = out + "_profile"
trainer = fsvlm_tpu_torch.train.main(args)
del os.environ["FSVLM_PROFILE_DIR"]
assert len(os.listdir(out + "_profile")) == 1
assert os.path.exists(os.path.join(out, "VLPromptLearner", "model-best.pkl"))
assert "* accuracy:" in open(os.path.join(out, "log.txt")).read()
import fsvlm_tpu_torch.ops.quant, fsvlm_tpu_torch.trainers.import_torch
from fsvlm_tpu_torch.tools import import_torch_prompts, interpret_prompt, predict
fixture = os.path.join({repo!r}, "tests", "torch_fixtures", "jpeg", "gray_280x210.jpg")
rows = list(predict.predict(trainer, trainer.cfg, [fixture], topk=2))
assert len(rows) == 1 and len(rows[0][1]) == 2, rows
from fsvlm_tpu_torch.native import read_image
formats = os.path.join({repo!r}, "tests", "torch_fixtures", "formats")
for name in ("bmp_pal8_rle8_160x120.bmp", "gtsrb_p6_53x57.ppm", "yale_gray_320x243.gif",
             "tiff_tiled_planar_lzw_mm_120x90.tiff", "jpeg_arith_prog_rst_cond_240x180.jpg",
             "jpeg_smoothed_unrefined_400x300.jpg", "jpeg_lossless_pred7_96x64.jpg"):
    assert read_image(os.path.join(formats, name)).shape[2] == 3
best = os.path.join(out, "VLPromptLearner", "model-best.pkl")
ref = os.path.join(out, "model.pth.tar-1")
import_torch_prompts.main([best, "--trainer", "PromptSRC", "--export", ref])
import_torch_prompts.main([ref, "--trainer", "PromptSRC", "--best", "--output-dir", out + "_imp"])
trainer.load_model(out + "_imp")
cfg.MODEL.QUANT_INT8 = True
trainer = ZeroshotCLIP(cfg, ["cat", "dog"], clip=clip, device="cpu", steps_per_epoch=1)
assert 0 <= trainer.test(np.zeros((3, 32, 32, 3), np.uint8), np.zeros(3)) <= 100
w_fc = trainer.frozen_eval()["clip"].visual.blocks[0].mlp.w_fc
assert fsvlm_tpu_torch.ops.quant.is_quantized(w_fc)
from fsvlm_tpu_torch.tools import export_serving, logreg, lpclip
eye = np.eye(3, dtype=np.float32)
clf = logreg.LogisticRegression(device="cpu").fit(eye, [0, 1, 2])
assert list(clf.predict(eye)) == [0, 1, 2]
assert lpclip.search_logreg(np.tile(eye, (2, 1)), [0, 1, 2] * 2, eye, [0, 1, 2], device="cpu")
params, _ = export_serving.export_serving("test-tiny", 2, 2, out + "_serving.pt2", device="cpu")
program = export_serving.load_serving(out + "_serving.pt2", device="cpu")
assert program(params, torch.zeros((2, 32, 32, 3), dtype=torch.uint8))[0].shape == (2,)
from fsvlm_tpu_torch import run_script
from fsvlm_tpu_torch.engine import optim, tb
for name in ("adam", "amsgrad", "adamw", "rmsprop", "radam"):
    cfg.OPTIM.NAME = name
    opt, _ = optim.build_optimizer(cfg, [torch.ones(3)], steps_per_epoch=1)
    opt.step([torch.ones(3)])
    assert int(opt.count) == 1
writer = tb.TensorboardWriter(out + "_tb")
writer.scalar("train/loss", 1.0, 0)
writer.close()
driver = out + "_driver.sh"
with open(driver, "w") as f:
    f.write("#!/bin/bash\npython parse_test_res.py " + out + "\n")
assert run_script.main(["--device", "cpu", driver]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "fsvlm_tpu", "regex", "yaml", "PIL", "sklearn", "tensorflow"))
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""


def test_serving_path_imports_no_jax_regex_yaml_or_pil():
    """Serving, a PromptSRC, an IVLP (KD, mixup), a CoOp and a CoCoOp train
    epoch, CoOp's and CoCoOp's test(), the blockwise and whole-sequence
    attention, and one CLI run (PromptSRC on the synthetic dataset, one
    epoch, CACHED_TEACHER, best-val), a LoRA, a MaPLe, a zero-shot (both)
    and a linear-probe epoch and test(), a PLIP epoch in each REG_TYPE, and
    a CoOp epoch and test() on the ModifiedResNet test-tiny-rn, then the
    tools (one predict call on the CLI run's model, its checkpoint exported
    to a reference file and imported back), a ZeroshotCLIP int8 test(), a
    logistic-regression fit, lpclip's C search and a serving export saved,
    loaded and run, a step of each of the five other optimizers, a
    TensorBoard scalar (the CLI run writes them too, under FSVLM_PROFILE_DIR)
    and a driver through run_script, and one decode of each image format
    the port reads besides JPEG and PNG (BMP, Netpbm, GIF, TIFF, arithmetic,
    smoothed and lossless JPEG), on the CPU, with every module of the
    port imported, load nothing of JAX, the JAX package, regex, yaml, PIL,
    sklearn or tensorflow (which imports jax where it is installed)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")  # one torch thread, as the file's
    proc = subprocess.run([sys.executable, "-c", _BOUNDARY.format(repo=REPO)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout


def test_predictor_with_bf16_frozen_towers_matches_jax(setup):
    """FROZEN_DTYPE bf16: towers stored in bfloat16 (the JAX package's
    _apply_frozen_dtype cast), computed in fp32 on the CPU as in JAX."""
    import jax

    from fsvlm_tpu.trainers.backbone import _apply_frozen_dtype

    params, images, _ = setup
    node = dataclasses.replace(NODE, FROZEN_DTYPE="bf16")
    cfg = types.SimpleNamespace(MODEL=types.SimpleNamespace(FROZEN_DTYPE="bf16"))
    params_bf16 = jax.tree.map(np.asarray, _apply_frozen_dtype(cfg, params))
    ref, _, _, _ = _jax_logits(params_bf16, CLASSNAMES, None, images)
    pred = PromptSRCPredictor(CLASSNAMES, node=node, backbone="test-tiny", seed=3, device="cpu",
                              clip=clip_from_params(params, CLIPConfig(*TINY), torch.bfloat16,
                                                    device="cpu"))
    assert pred.clip.visual.proj.dtype == torch.bfloat16
    logits = pred.image_logits(images).numpy()
    np.testing.assert_allclose(logits, ref, atol=1e-3)
    assert (logits.argmax(1) == ref.argmax(1)).all()
