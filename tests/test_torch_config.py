"""The port's config against the JAX package's, on the CPU.

- ``parse_yaml`` gives what ``yaml.safe_load`` gives for every file under
  configs/, and raises on what lies outside its subset;
- ``get_cfg_base()`` is the JAX package's ``get_cfg_default()`` (defaults.py),
  and ``merge_from_file`` on it of the PromptSRC, IVLP, CoOp, CoCoOp,
  LoRA, MaPLe, LinearProbeCLIP and PLIP recipes, the test recipe, the dataset
  files and the synthetic + tiny pair gives, on every key of the port, the value (and type) of the JAX package's
  ``get_cfg_default().merge_from_file`` of the same files;
- the CLI's ``setup_cfg`` gives the JAX train.py's config for the same
  command line, for each ported trainer;
- an unknown key raises KeyError, as in ``merge_from_list``.
"""

import dataclasses
import glob
import os

import pytest
import yaml

from fsvlm_tpu.config import get_cfg_default as jax_get_cfg_default
from fsvlm_tpu_torch import train as cli
from fsvlm_tpu_torch.config import get_cfg_base, get_cfg_default, parse_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_FILES = sorted(os.path.relpath(f, ROOT)
                   for f in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
RECIPES = [f for f in ALL_FILES if f.split(os.sep)[2:3] in (
    ["PromptSRC"], ["IVLP"], ["CoOp"], ["CoCoOp"], ["tests"], ["LoRA"], ["MaPLe"],
    ["LinearProbeCLIP"], ["PLIP"])]
DATASETS = [f for f in ALL_FILES if f.startswith(os.path.join("configs", "datasets"))
            and os.sep + "zoo" + os.sep not in f]
ZOO_DATASETS = [f for f in ALL_FILES if f.startswith(os.path.join("configs", "datasets", "zoo"))]
PROMPTSRC = "configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml"
IVLP_KD = "configs/trainers/IVLP/vit_b16_c2_ep20_batch4_4+4ctx_kd.yaml"


def test_the_survey_of_files_is_complete():
    assert len(ALL_FILES) == 71 and len(RECIPES) == 39 and len(DATASETS) == 16
    assert len(ZOO_DATASETS) == 13


@pytest.mark.parametrize("path", ALL_FILES)
def test_parse_yaml_matches_pyyaml(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    got, ref = parse_yaml(text, path), yaml.safe_load(text) or {}
    assert got == ref and repr(got) == repr(ref)


SCALARS = ["A: 1e-5", "A: 1.0e-5", "A: -.5", "A: .5", "A: 010", "A: 0x1F", "A: 0b101",
           "A: +12", "A: 1_000", "A: yes", "A: On", "A: oN", "A: ~", "A:", "A: 'it''s'",
           'A: "a\\tb # c" # d', "A: [1, 'b', c d, 2.5, true, ~, ]", "A: .inf", "A: -.Inf",
           "A: a#b", "A:\n  B:\n    C: 1\n  D: [1,2]\nE: x", "A: 1.", "A: -0", "A: 09", "A: 1e5"]


@pytest.mark.parametrize("text", SCALARS)
def test_parse_yaml_types_scalars_as_pyyaml(text):
    got, ref = parse_yaml(text), yaml.safe_load(text)
    assert repr(got) == repr(ref)


@pytest.mark.parametrize("text", ["A: &x 1", "A: *x", "A: !!int 1", "A: |", "- a",
                                  "A: {b: 1}", "---\nA: 1", "A: 1:20", "A:\n  - a", "A: 'x",
                                  "A: b: c", "A:\n    B: 1\n  C: 2", "A: 1\nA: 2"])
def test_parse_yaml_raises_outside_its_subset(text):
    with pytest.raises(ValueError, match="yaml subset"):
        parse_yaml(text)


def _leaves(node, prefix=""):
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            yield from _leaves(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


def _jax_value(cfg, key):
    node = cfg
    for part in key.split("."):
        node = node[part]
    return node


def _jax_keys(node, prefix=""):
    for k, v in node.items():
        if hasattr(v, "items"):
            yield from _jax_keys(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


def _assert_same(pcfg, jcfg):
    """The same keys (225 leaves) with the same values and types."""
    assert sorted(k for k, _ in _leaves(pcfg)) == sorted(_jax_keys(jcfg))
    for key, value in _leaves(pcfg):
        ref = _jax_value(jcfg, key)
        assert type(value) is type(ref) and value == ref, (key, value, ref)


SYNTHETIC_TINY = "configs/datasets/synthetic.yaml|configs/trainers/tests/synthetic_tiny.yaml"
# the keys that the port once rejected (ROADMAP C.4), set off their defaults
C4_OPTS = ("VERSION 2 USE_CUDA False OPTIM.SGD_DAMPNING 1 TEST.EVALUATOR Classification "
           "TRAINER.PROMPTSRC.LABEL_SCOPE all OPTIM.ADAM_BETA1 0.8 OPTIM.ADAM_BETA2 0.99 "
           "OPTIM.RMSPROP_ALPHA 0.9")


@pytest.mark.parametrize("paths", [pytest.param("", id="defaults"), SYNTHETIC_TINY]
                         + RECIPES + DATASETS + ZOO_DATASETS)
def test_merge_from_file_matches_jax(paths):
    """``paths``: the files merged in turn, separated by "|"."""
    jcfg, pcfg = jax_get_cfg_default(), get_cfg_base()
    for path in filter(None, paths.split("|")):
        jcfg.merge_from_file(os.path.join(ROOT, path))
        pcfg.merge_from_file(os.path.join(ROOT, path))
    _assert_same(pcfg, jcfg)


@pytest.mark.parametrize("trainer,config_file", [
    ("IVLP", "configs/trainers/tests/synthetic_tiny.yaml"),
    ("PromptSRC", "configs/trainers/tests/synthetic_tiny.yaml"),
    ("PromptSRC", PROMPTSRC),
    ("IVLP", IVLP_KD),
    ("CoOp", "configs/trainers/CoOp/vit_b16_ep50.yaml"),
    ("CoCoOp", "configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml"),
    ("LoRA", "configs/trainers/LoRA/vit_b16_ep10_batch32.yaml"),
    ("MaPLe", "configs/trainers/MaPLe/vit_b16_c2_ep5_batch4_2ctx.yaml"),
    ("LinearProbeCLIP", "configs/trainers/LinearProbeCLIP/vit_b16_ep50.yaml"),
    ("ZeroshotCLIP2", "configs/trainers/tests/synthetic_tiny.yaml"),
    ("PLIP", "configs/trainers/PLIP/vit_b16_c4_ep10_batch4.yaml"),
    ("CoOp", "configs/trainers/CoOp/rn50.yaml"),
    ("PromptSRC", "configs/trainers/tests/synthetic_tiny.yaml|TRAIN.EPOCH_FUSE off"),
    ("CoCoOp", "configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml|TRAIN.EPOCH_FUSE on "
               "TRAIN.DEVICE_SCHEDULE True"),
] + [("PromptSRC", f"configs/trainers/tests/synthetic_tiny.yaml|{C4_OPTS} OPTIM.NAME {name}")
     for name in ("adam", "amsgrad", "sgd", "rmsprop", "radam", "adamw")] + [
    ("Vanilla", "configs/trainers/zoo/vanilla_mixstyle_pacs.yaml"),
    ("DANN", "configs/trainers/zoo/dann_resnet18.yaml"),
    ("FixMatch", "configs/trainers/zoo/fixmatch_cifar10.yaml"),
])
def test_setup_cfg_matches_jax(trainer, config_file, monkeypatch):
    """The same command line gives the same config in both CLIs: both start
    from defaults.py, so a key that the yaml leaves unset (IVLP's N_CTX and
    USE_MIXUP under the tiny recipe) keeps defaults.py's value in both.
    ``config_file`` may carry trailing options after "|": the keys the port
    once rejected (ROADMAP C.4) and each OPTIM.NAME with its own keys."""
    import train as jax_cli  # the JAX package's CLI, at the repo root

    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("FSVLM_EXTRA_OPTS", raising=False)
    config_file, _, opts = config_file.partition("|")
    argv = ["--trainer", trainer, "--seed", "1", "--output-dir", "out",
            "--dataset-config-file", "configs/datasets/synthetic.yaml",
            "--config-file", config_file, "OPTIM.MAX_EPOCH", "2", *opts.split()]
    jcfg = jax_cli.setup_cfg(jax_cli.build_argparser().parse_args(argv))
    pcfg = cli.setup_cfg(cli.build_argparser().parse_args(argv))
    _assert_same(pcfg, jcfg)
    if config_file.endswith("synthetic_tiny.yaml") and trainer == "IVLP":
        assert pcfg.TRAINER.IVLP.N_CTX_TEXT == 2 and pcfg.TRAINER.IVLP.USE_MIXUP
    if "EPOCH_FUSE" in opts:
        assert pcfg.TRAIN.EPOCH_FUSE in ("off", "on")
        assert pcfg.TRAIN.DEVICE_SCHEDULE is ("DEVICE_SCHEDULE" in opts)
    elif opts:
        assert (pcfg.VERSION, pcfg.USE_CUDA, pcfg.OPTIM.SGD_DAMPNING, pcfg.OPTIM.ADAM_BETA2,
                pcfg.TRAINER.PROMPTSRC.LABEL_SCOPE) == (2, False, 1, 0.99, "all")


def test_another_evaluator_raises(tmp_path, monkeypatch):
    """TEST.EVALUATOR merges as in JAX, and any name but Classification
    raises KeyError when the trainer is built (the JAX package's registry
    raises there too)."""
    from fsvlm_tpu_torch.engine.evaluator import Classification, build_evaluator

    cfg = get_cfg_base()
    assert isinstance(build_evaluator(cfg), Classification)
    cfg.merge_from_list(["TEST.EVALUATOR", "Retrieval"])
    with pytest.raises(KeyError, match="Retrieval"):
        build_evaluator(cfg)
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("FSVLM_EXTRA_OPTS", raising=False)
    args = cli.build_argparser().parse_args(
        ["--trainer", "PromptSRC", "--device", "cpu", "--output-dir", str(tmp_path),
         "--dataset-config-file", "configs/datasets/synthetic.yaml",
         "--config-file", "configs/trainers/tests/synthetic_tiny.yaml",
         "TEST.EVALUATOR", "Retrieval"])
    with pytest.raises(KeyError, match="TEST.EVALUATOR 'Retrieval'"):
        cli.main(args)


def test_merge_from_file_rejects_unknown_keys(tmp_path):
    cfg = get_cfg_default()
    unknown = tmp_path / "unknown_node.yaml"
    unknown.write_text("TRAINER:\n  NOT_A_TRAINER:\n    WEIGHT_U: 1.0\n")
    with pytest.raises(KeyError, match="TRAINER.NOT_A_TRAINER"):
        cfg.merge_from_file(str(unknown))
    bad = tmp_path / "bad.yaml"
    bad.write_text("OPTIM:\n  LR: 0.1\n  NOT_A_KEY: 1\n")
    with pytest.raises(KeyError, match="OPTIM.NOT_A_KEY"):
        get_cfg_default().merge_from_file(str(bad))


def test_config_prints_as_the_yacs_tree():
    jcfg = jax_get_cfg_default()
    jcfg.merge_from_file(os.path.join(ROOT, PROMPTSRC))
    pcfg = get_cfg_default()
    jlines = set(str(jcfg).splitlines())
    for line in ("  MAX_EPOCH: 20", "  LR: 0.0025", "OUTPUT_DIR: ./output",
                 "  INTERPOLATION: bicubic", "    CACHED_TEACHER: False"):
        assert line in str(pcfg).splitlines() and line in jlines, line
