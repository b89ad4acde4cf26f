"""The port's tools (fsvlm_tpu_torch/tools/: predict, import_torch_prompts,
interpret_prompt) and its reference-checkpoint importer
(fsvlm_tpu_torch/trainers/import_torch.py) against the repository's tools/
and fsvlm_tpu.trainers.import_torch, on the CPU.

- predict in-process and as ``python -m`` against tools/predict.py's
  predict() on the committed JPEG fixtures with a JAX-written PromptSRC
  checkpoint (test-tiny on Synthetic, fp32): the same files in the same
  order, the same top-k labels, probs within 1e-5 (the CLI's JSONL within
  1e-5 as rounded to 6 places); under MODEL.QUANT_INT8 (dynamic and static)
  the port's probabilities within a third of JAX-int8's distance to
  JAX-fp32 (test_torch_quant.py's RATIO rule);
- the importer on dassl-layout pickles this test writes with torch.save, one
  per family (CoOp and CoCoOp learner-relative with fp16 leaves and the
  buffers the reference drops; MaPLe; IVLP and PromptSRC whole-model dumps
  behind ``module.`` with VPT_shallow per layer; LoRA): the port's arrays
  equal to the JAX importer's;
- export -> import_torch_prompts -> load_model: the prompts exactly, and
  test()'s predictions exactly;
- interpret_prompt: the same tokens as tools/interpret_prompt.py, distances
  within its printed rounding (and within 1e-5 of numpy's in-process).
"""

import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from test_torch_quant import RATIO

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu.engine import build_trainer as jax_build_trainer
from fsvlm_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from fsvlm_tpu.trainers import import_torch as jax_import
import fsvlm_tpu.trainers  # noqa: F401
import fsvlm_tpu_torch.trainers  # noqa: F401  (registers the trainers)
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.checkpoint import flatten, load_checkpoint
from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.tools import import_torch_prompts, interpret_prompt, predict
from fsvlm_tpu_torch.trainers import import_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
DATASET_YAML = "configs/datasets/synthetic.yaml"
TINY_YAML = "configs/trainers/tests/synthetic_tiny.yaml"
OPTS = ["TRAINER.PROMPTSRC.PREC", "fp32", "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT", "2",
        "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION", "2", "DATALOADER.NUM_WORKERS", "1",
        "MODEL.QUANT_INT8_CALIB_BATCHES", "2"]


def _load_tool(name):
    """The repository's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs(tmp_path, *opts):
    flat = ["TRAINER.NAME", "PromptSRC", "SEED", "1", "OUTPUT_DIR", str(tmp_path / "out"),
            *OPTS, *opts]
    jcfg, pcfg = jax_get_cfg_default(), get_cfg_base()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file(os.path.join(ROOT, DATASET_YAML))
        cfg.merge_from_file(os.path.join(ROOT, TINY_YAML))
        cfg.merge_from_list(list(flat))
    return jcfg, pcfg


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A JAX-written PromptSRC checkpoint (the JAX trainer's init prompts
    moved by seeded noise) as model-best.pkl and model.pkl-3."""
    tmp = tmp_path_factory.mktemp("predict")
    jcfg, _ = _cfgs(tmp)
    with redirect_stdout(io.StringIO()):
        jt = jax_build_trainer(jcfg)
    rng = np.random.RandomState(8)
    trained = {k: np.asarray(v) + (0.2 * rng.randn(*np.shape(v))).astype(np.float32)
               for k, v in jt.params.items()}
    with redirect_stdout(io.StringIO()):
        jax_save_checkpoint({"state_dict": trained, "epoch": 3, "optimizer": None,
                             "val_result": 40.0}, str(tmp / "model" / "VLPromptLearner"),
                            is_best=True)
    return tmp / "model"


def _fixtures():
    return sorted(os.path.join(FIXTURES, n) for n in os.listdir(FIXTURES) if n.endswith(".jpg"))


def _both_predict(tmp_path, model_dir, *opts, topk=3):
    jcfg, pcfg = _cfgs(tmp_path, *opts)
    jax_predict = _load_tool("predict")
    paths = _fixtures()
    with redirect_stdout(io.StringIO()):
        jt, pt = jax_build_trainer(jcfg), build_trainer(pcfg, device="cpu")
        jt.load_model(str(model_dir))
        pt.load_model(str(model_dir))
        ref = list(jax_predict.predict(jt, jcfg, paths, topk=topk, pred_batch=8))
        got = list(predict.predict(pt, pcfg, paths, topk=topk, pred_batch=8))
    return paths, ref, got, pt


def _probs(rows, names):
    """Each row's probabilities in class-name order (topk = every class)."""
    return np.array([[dict(tk)[n] for n in names] for _, tk in rows])


def test_predict_matches_jax_predict(tmp_path, model_dir):
    """fp32: the 17 fixtures in 3 batches of 8 (the last padded), the same
    paths, top-3 labels, probs within 1e-5."""
    paths, ref, got, pt = _both_predict(tmp_path, model_dir)
    assert len(paths) == 17 and [p for p, _ in got] == [p for p, _ in ref] == paths
    for (_, tk), (_, rk) in zip(got, ref):
        assert [n for n, _ in tk] == [n for n, _ in rk]
        np.testing.assert_allclose([p for _, p in tk], [p for _, p in rk], rtol=0, atol=1e-5)
    assert pt.frozen_eval() is pt.frozen


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_predict_int8_matches_jax_predict(tmp_path, model_dir, static):
    """MODEL.QUANT_INT8 (static: calibrated over the test loader's first 2
    batches in both packages): every class's probability by the RATIO rule
    against JAX's fp32 predict on the same files."""
    names = None
    runs = {}
    for mode in ("fp32", "int8"):
        opts = ["MODEL.QUANT_INT8", "True", "MODEL.QUANT_INT8_STATIC", str(static)] \
            if mode == "int8" else []
        paths, ref, got, pt = _both_predict(tmp_path, model_dir, *opts, topk=8)
        names = names or sorted(pt.lab2cname.values())
        runs[mode] = (_probs(ref, names), _probs(got, names), pt)
    (_, _, _), (ref_q, got_q, pt) = runs["fp32"], runs["int8"]
    ref_fp = runs["fp32"][0]
    gap = np.linalg.norm(ref_q - ref_fp)
    assert gap > 0 and np.linalg.norm(got_q - ref_q) <= RATIO * gap
    rec = pt.frozen_eval()["clip"].visual.blocks[0].attn.w_qkv
    assert type(rec).__name__ == "Int8Weight" and (rec.xs is not None) == static


def test_predict_cli_matches_jax_predict(tmp_path, model_dir):
    """``python -m fsvlm_tpu_torch.tools.predict --device cpu`` over the
    fixture directory: one JSONL row per file, in sorted order, as JAX's
    predict() gives them (labels equal, probs within 1e-5 as rounded)."""
    _, ref, _, _ = _both_predict(tmp_path, model_dir)
    out = tmp_path / "preds.jsonl"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "FSVLM_EXTRA_OPTS")}
    proc = subprocess.run(
        [sys.executable, "-m", "fsvlm_tpu_torch.tools.predict", "--device", "cpu",
         "--dataset-config-file", DATASET_YAML, "--config-file", TINY_YAML,
         "--trainer", "PromptSRC", "--seed", "1", "--output-dir", str(tmp_path / "cli"),
         "--model-dir", str(model_dir), "--images", FIXTURES, "--topk", "3",
         "--pred-batch", "8", "--out", str(out), *OPTS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "wrote 17 predictions" in proc.stdout
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["path"] for r in rows] == [p for p, _ in ref]
    for row, (_, rk) in zip(rows, ref):
        assert [t["label"] for t in row["topk"]] == [n for n, _ in rk]
        np.testing.assert_allclose([t["prob"] for t in row["topk"]], [p for _, p in rk],
                                   rtol=0, atol=1e-5)


def test_collect_images_walks_in_sorted_order(tmp_path):
    """Files and directories (recursive, sorted, IMG_EXTS only), as
    tools/predict.py's collect_images; a missing entry and an empty result
    raise."""
    jax_predict = _load_tool("predict")
    for rel in ("b/2.jpg", "b/1.PNG", "a.jpg", "b/c/x.jpeg", "b/notes.txt"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    specs = [str(tmp_path / "b"), str(tmp_path / "a.jpg")]
    assert predict.collect_images(specs) == jax_predict.collect_images(specs)
    assert predict.IMG_EXTS == jax_predict.IMG_EXTS
    with pytest.raises(FileNotFoundError):
        predict.collect_images([str(tmp_path / "nope")])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        predict.collect_images([str(tmp_path / "empty")])


def test_predict_names_a16_on_a_png(tmp_path, model_dir):
    """A PNG among the images: the port's reader raises naming ROADMAP A16
    (the JAX package's PIL reads it)."""
    from PIL import Image

    png = tmp_path / "x.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png)
    _, pcfg = _cfgs(tmp_path)
    with redirect_stdout(io.StringIO()):
        pt = build_trainer(pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        list(predict.predict(pt, pcfg, [str(png)]))


# ------------------------------------------------------------------ importer
def _dassl_file(path, sd, epoch=7):
    torch.save({"state_dict": sd, "epoch": epoch, "optimizer": {"state": {}},
                "scheduler": {"last_epoch": epoch}, "val_result": 61.5}, path)


def _family_state_dicts():
    """One reference-layout state dict per family, fp16 leaves where the
    fork's CUDA runs saved them, frozen-tower tensors to be ignored."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    vpt = {f"{enc}.transformer.resblocks.{i}.VPT_shallow": r(4, w)
           for enc, w in (("image_encoder", 768), ("text_encoder", 512)) for i in range(1, 9)}
    return {
        "CoOp": {"ctx": r(16, 512, dtype=torch.float16), "token_prefix": r(10, 1, 512),
                 "token_suffix": r(10, 60, 512)},
        "CoCoOp": {"ctx": r(4, 512), "meta_net.linear1.weight": r(32, 512),
                   "meta_net.linear1.bias": r(32), "meta_net.linear2.weight": r(512, 32),
                   "meta_net.linear2.bias": r(512), "token_prefix": r(10, 1, 512)},
        "MaPLe": {"prompt_learner.ctx": r(2, 512), "prompt_learner.proj.weight": r(768, 512),
                  "prompt_learner.proj.bias": r(768),
                  **{f"prompt_learner.compound_prompts_text.{i}": r(2, 512) for i in range(8)},
                  **{f"prompt_learner.compound_prompt_projections.{i}.{k}": r(*s)
                     for i in range(8) for k, s in (("weight", (768, 512)), ("bias", (768,)))},
                  "image_encoder.conv1.weight": r(768, 3, 16, 16)},
        "IVLP": {f"module.{k}": v for k, v in {
            "prompt_learner.ctx": r(4, 512, dtype=torch.float16), "image_encoder.VPT": r(4, 768),
            "text_encoder.positional_embedding": r(77, 512), **vpt}.items()},
        "PromptSRC": {"prompt_learner.ctx": r(4, 512), "image_encoder.VPT": r(4, 768),
                      "logit_scale": r(()), **vpt},
    }


def _assert_trees_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_trees_equal(a, b, f"{path}[{i}]")
    else:
        assert np.asarray(got).dtype == np.asarray(ref).dtype, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=path)


@pytest.mark.parametrize("family", ["CoOp", "CoCoOp", "MaPLe", "IVLP", "PromptSRC"])
def test_importer_matches_jax_importer(tmp_path, family):
    """A dassl pickle of ``family``: ``import_torch_checkpoint`` gives the
    JAX importer's params (every array equal, fp32), epoch and val result;
    ``torch_state_dict_from_params`` the JAX exporter's tensors."""
    path = str(tmp_path / "model.pth.tar-7")
    _dassl_file(path, _family_state_dicts()[family])
    got = import_torch.import_torch_checkpoint(path, family)
    ref = jax_import.import_torch_checkpoint(path, family)
    _assert_trees_equal(got[0], ref[0])
    assert got[1:] == ref[1:] == (7, 61.5)
    sd, ref_sd = (m.torch_state_dict_from_params(ref[0], family) for m in (import_torch,
                                                                           jax_import))
    assert sorted(sd) == sorted(ref_sd)
    for k in sd:
        assert torch.equal(sd[k], ref_sd[k]), k


def test_importer_refuses_what_jax_refuses(tmp_path):
    path = str(tmp_path / "x.pth.tar")
    _dassl_file(path, {"image_encoder.VPT": torch.zeros(2, 8)})
    for mod in (import_torch, jax_import):
        with pytest.raises(ValueError, match="CoOp-family"):
            mod.import_torch_checkpoint(path, "CoOp")
        with pytest.raises(ValueError, match="not a full-model"):
            mod.import_torch_checkpoint(path, "PromptSRC")
        with pytest.raises(ValueError, match="unsupported trainer"):
            mod.import_torch_checkpoint(path, "LoRA")
    torch.save({"weights": {}}, path)
    with pytest.raises(ValueError, match="no state_dict"):
        import_torch.import_torch_checkpoint(path, "PromptSRC")


def test_lora_importer_matches_jax_and_loads(tmp_path):
    """A reference LoRA best.pt (text tower first, loralib-shaped factors):
    the payload equals the JAX importer's, and through the CLI's LoRA
    branch the port's LoRA trainer loads it (its factors, transposed)."""
    from fsvlm_tpu_torch.config import get_cfg_default
    from fsvlm_tpu_torch.models.clip import ARCHS
    from fsvlm_tpu_torch.trainers.backbone import load_clip_backbone
    from fsvlm_tpu_torch.trainers.lora import LoRA

    g = torch.Generator().manual_seed(1)
    r = 2  # test-tiny: 2 text + 2 vision layers, both 64 wide
    weights = {f"layer_{i}": {p: {"w_lora_A": torch.randn(r, 64, generator=g),
                                  "w_lora_B": torch.randn(64, r, generator=g)}
                              for p in ("q_proj", "k_proj", "v_proj")} for i in range(4)}
    meta = {"r": r, "alpha": 1, "encoder": "both", "params": ["q", "k", "v"], "position": "all"}
    path = str(tmp_path / "best.pt")
    torch.save({"weights": weights, "metadata": meta}, path)
    got = import_torch.import_lora_checkpoint(path, "test-tiny")
    _assert_trees_equal(got, jax_import.import_lora_checkpoint(path, "test-tiny"))
    out = tmp_path / "o"
    with redirect_stdout(io.StringIO()):
        import_torch_prompts.main([path, "--trainer", "LoRA", "--backbone", "test-tiny",
                                   "--dataset", "Synthetic", "--output-dir", str(out)])
    payload = load_checkpoint(str(out / "Synthetic" / "test-tiny" / "lora" / "best.pkl"))
    _assert_trees_equal(payload, got)

    cfg = get_cfg_default()
    cfg.MODEL.BACKBONE.NAME, cfg.DATASET.NAME, cfg.INPUT.SIZE = "test-tiny", "Synthetic", (32, 32)
    cfg.TRAINER.LORA.ENCODER, cfg.TRAINER.LORA.POSITION, cfg.TRAINER.LORA.R = "both", "all", r
    with redirect_stdout(io.StringIO()):
        t = LoRA(cfg, ["a", "b"], clip=load_clip_backbone("test-tiny", device="cpu"),
                 device="cpu", steps_per_epoch=1)
        t.load_model(str(out))
    assert ARCHS["test-tiny"].transformer_layers == 2
    for i in range(4):
        tower, li = ("text", i) if i < 2 else ("vision", i - 2)
        for p, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj")):
            np.testing.assert_array_equal(t.params[f"{tower}.{p}.0"][li].detach().numpy(),
                                          weights[f"layer_{i}"][name]["w_lora_A"].numpy().T)
            np.testing.assert_array_equal(t.params[f"{tower}.{p}.1"][li].detach().numpy(),
                                          weights[f"layer_{i}"][name]["w_lora_B"].numpy().T)


def test_export_import_round_trip_is_exact(tmp_path, model_dir):
    """The JAX-written checkpoint exported to a reference file (as the JAX
    exporter writes it), imported back through the CLI with --best, and
    loaded by a port trainer: the prompts bit for bit, and test()'s
    predictions on the synthetic test set exactly."""
    src = str(model_dir / "VLPromptLearner" / "model.pkl-3")
    out = str(tmp_path / "model.pth.tar-3")
    with redirect_stdout(io.StringIO()):
        import_torch_prompts.main([src, "--trainer", "PromptSRC", "--export", out])
    ref = str(tmp_path / "jax.pth.tar-3")
    jax_import.export_torch_checkpoint(src, "PromptSRC", ref)
    a, b = torch.load(out, weights_only=False), torch.load(ref, weights_only=False)
    assert sorted(a["state_dict"]) == sorted(b["state_dict"]) and a["epoch"] == b["epoch"] == 3
    assert all(torch.equal(a["state_dict"][k], b["state_dict"][k]) for k in a["state_dict"])
    with redirect_stdout(io.StringIO()):
        import_torch_prompts.main([out, "--trainer", "PromptSRC", "--best",
                                   "--output-dir", str(tmp_path / "imported")])
    _, pcfg = _cfgs(tmp_path)
    preds = []
    for directory in (model_dir, tmp_path / "imported"):
        with redirect_stdout(io.StringIO()):
            pt = build_trainer(pcfg, device="cpu")
            pt.load_model(str(directory))
            preds.append((dict(pt.params), pt.test(return_pred=True)))
    original = flatten(load_checkpoint(src)["state_dict"])
    for k, v in preds[1][0].items():
        np.testing.assert_array_equal(v.detach().numpy(), original[k], err_msg=k)
    assert preds[0][1] == preds[1][1]


# ----------------------------------------------------------------- interpret
def test_interpret_prompt_matches_jax_tool(tmp_path, model_dir, monkeypatch, capsys):
    """A checkpoint with deep text prompts: every context vector's top-4
    tokens equal to tools/interpret_prompt.py's (test-tiny's random table of
    seed 0), the printed distances within their rounding; the distances
    within 1e-5 relative of numpy's."""
    monkeypatch.delenv("FSVLM_CLIP_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))  # no ~/.cache/clip weights
    ckpt = str(model_dir / "VLPromptLearner" / "model.pkl-3")
    jax_tool = _load_tool("interpret_prompt")
    monkeypatch.setattr(sys, "argv", ["interpret_prompt.py", ckpt, "--backbone", "test-tiny"])
    jax_tool.main()
    ref = capsys.readouterr().out
    interpret_prompt.main([ckpt, "--backbone", "test-tiny", "--device", "cpu"])
    got = capsys.readouterr().out

    def parse(text):
        return [(line.split(":")[0], [(w, float(d)) for w, d in
                                      re.findall(r"'(.*?)' \(([0-9.]+)\)", line)])
                for line in text.splitlines() if line.startswith("ctx[")]

    heads = [line for line in got.splitlines() if not line.startswith("ctx[")]
    assert heads == [line for line in ref.splitlines() if not line.startswith("ctx[")]
    assert "== layer 2 context ==" in got
    g, r = parse(got), parse(ref)
    assert len(g) == len(r) == 4 + 4  # the input context and one deep layer of 4
    for (gname, gw), (rname, rw) in zip(g, r):
        assert gname == rname and [w for w, _ in gw] == [w for w, _ in rw]
        np.testing.assert_allclose([d for _, d in gw], [d for _, d in rw], rtol=0, atol=1.5e-3)

    table = interpret_prompt.token_embedding("test-tiny")
    vectors = interpret_prompt.prompt_layers(load_checkpoint(ckpt)["state_dict"])[0][1]
    for vec, (idx, dist) in zip(vectors, interpret_prompt.nearest_tokens(vectors, table, 4,
                                                                        "cpu")):
        ref_d = np.linalg.norm(table - vec[None, :], axis=1)
        np.testing.assert_array_equal(idx, np.argsort(ref_d)[:4])
        np.testing.assert_allclose(dist, ref_d[idx], rtol=1e-5)
