"""Every driver under scripts/ through ``python -m fsvlm_tpu_torch.run_script
--device cpu``, held against the same driver run by the JAX package (slow).

The chains are tests/test_scripts_execute_all.py's and
tests/test_scripts_smoke.py's, with their OUT_ROOT / CFG / LOADEP /
FSVLM_EXTRA_OPTS contract (test-tiny on the synthetic dataset; drivers
pinned to a real dataset take its yaml with ``DATASET.NAME Synthetic``).
Each chain runs twice, by JAX (``bash``, the JAX package's train.py and
tools) and by the runner, into two output roots; the reproduce_* drivers
take a checkpoint exported by each side's own ``import_torch_prompts
--export`` from that side's training, as tests/test_scripts_smoke.py's
recipe does.  Held: every call exits 0 (the runner's record), the two
output trees hold the same files (event files, and the logs kept from an
earlier run into the same directory, by their prefix), and
``parse_test_res.py`` gives the same table rows (metric names and seed
counts) on every directory that holds seed folders.  Values are not
compared: the two packages draw different crops and initial prompts
(ROADMAP C.3); tests/test_torch_run_script.py compares accuracies on the
eval-only drivers.

``test_every_driver_is_run_or_listed`` (not slow) fails when a driver is
neither in a chain here nor listed with its reason.
"""

import glob
import os
import re
import subprocess
import sys

import pytest
from test_scripts_execute_all import BASE_OPTS, TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOTS8 = "[2,2,2,2,1,1,1,1]"
SMOKE_OPTS = ("OPTIM.MAX_EPOCH 2 TRAINER.PROMPTSRC.PREC fp32 "
              "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT 2 TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION 2")

# drivers no chain runs, each with its reason
LISTED = {
    "scripts/datasets/visda17.sh": "downloads VisDA-17 (network), and names no python",
    "scripts/_lib/base2new_fewshot.sh": "sourced by the */base2new_fewshot_{train,test}.sh drivers",
    "scripts/_lib/base2new_test.sh": "sourced by the */base2new_test.sh drivers",
}


def _run(script, *args):
    return ("run", script, [str(a) for a in args])


def _export(ckpt_rel, trainer, dest_rel):
    return ("export", ckpt_rel, trainer, dest_rel)


# chain name -> (env, steps); a step runs a driver or exports a checkpoint
CHAINS = {
    "coop_drivers": ({"SEEDS": "1", "SHOTS": "2", "SHOT_SWEEP": "2", "NCTX": "4"}, [
        _run("scripts/coop/main.sh", "synthetic", 2, TINY),
        *(_run(f"scripts/coop/{s}.sh") for s in ("imagenet", "fgvc_aircraft", "pets")),
        _run("scripts/coop/eval.sh", "synthetic", TINY),
        _run("scripts/coop/few_shot.sh", "synthetic", 1, TINY)]),
    "coop_base2new": ({}, [
        _run("scripts/coop/base2new_train.sh", "synthetic", 1),
        _run("scripts/coop/base2new_test.sh", "synthetic", 1),
        _run("scripts/coop/base2new_fewshot_train.sh", "synthetic", 1, SHOTS8),
        _run("scripts/coop/base2new_fewshot_test.sh", "synthetic", 1, SHOTS8)]),
    "coop_train_test": ({"FSVLM_EXTRA_OPTS": "OPTIM.MAX_EPOCH 1 DATALOADER.TRAIN_X.BATCH_SIZE 8"}, [
        _run("scripts/coop/train.sh", "synthetic", TINY, "end", 4, 4, "False", 1),
        _run("scripts/coop/test.sh", "synthetic", TINY, "end", 4, 4, "False", 1)]),
    "imbalance": ({"TAIL_SWEEP": "1", "SETTING_B_PAIRS": "2 1"}, [
        _run("scripts/coop/run_setting_a.sh", "synthetic", 1, TINY, 4, 4),
        _run("scripts/coop/run_setting_b.sh", "synthetic", 1, TINY, 4, 4),
        _run("scripts/imbalance/run_setting_a.sh", "PromptSRC", "synthetic", 1, TINY, 4, 4),
        _run("scripts/imbalance/run_setting_b.sh", "PromptSRC", "synthetic", 1, TINY, 4, 4)]),
    "cocoop": ({"SHOTS": "2"}, [
        _run("scripts/cocoop/train.sh", "synthetic", 1, TINY),
        _run("scripts/cocoop/test.sh", "synthetic", 1, TINY),
        _run("scripts/cocoop/main.sh", "synthetic", 1, 2, TINY),
        _run("scripts/cocoop/xd_train.sh", 1),
        _run("scripts/cocoop/xd_test.sh", "synthetic", 1)]),
    "cocoop_base2new": ({}, [
        _run("scripts/cocoop/base2new_train.sh", "synthetic", 1),
        _run("scripts/cocoop/base2new_test.sh", "synthetic", 1),
        _run("scripts/cocoop/base2new_fewshot_train.sh", "synthetic", 1, SHOTS8),
        _run("scripts/cocoop/base2new_fewshot_test.sh", "synthetic", 1, SHOTS8)]),
    "maple": ({"SHOTS": "2"}, [
        _run("scripts/maple/train.sh", "synthetic", 1, TINY),
        _run("scripts/maple/test.sh", "synthetic", 1, TINY),
        _run("scripts/maple/main.sh", "synthetic", 1, 2, TINY)]),
    "maple_base2new_reproduce": ({}, [
        _run("scripts/maple/base2new_train.sh", "synthetic", 1),
        _run("scripts/maple/base2new_test.sh", "synthetic", 1),
        _run("scripts/maple/base2new_fewshot_train.sh", "synthetic", 1, SHOTS8),
        _run("scripts/maple/base2new_fewshot_test.sh", "synthetic", 1, SHOTS8),
        _run("scripts/maple/base2new_train_maple.sh", "synthetic", 1),
        _run("scripts/maple/base2new_test_maple.sh", "synthetic", 1),
        _export(f"base2new/train_base/synthetic/shots_16/MaPLe/{TINY}/seed1/"
                "MultiModalPromptLearner/model.pkl-1", "MaPLe",
                "published/base/seed1/MultiModalPromptLearner/model.pth.tar-1"),
        _run("scripts/maple/reproduce_maple.sh", "synthetic", 1, "{tmp}/published")]),
    "maple_xd": ({}, [
        _run("scripts/maple/xd_train.sh", 1),
        _run("scripts/maple/xd_test.sh", "synthetic", 1),
        _run("scripts/maple/xd_train_maple.sh", 1),
        _run("scripts/maple/xd_test_maple.sh", "synthetic", 1),
        _export(f"imagenet/MaPLe/{TINY}_16shots/seed1/MultiModalPromptLearner/model.pkl-1",
                "MaPLe", "published_xd/seed1/MultiModalPromptLearner/model.pth.tar-1"),
        _run("scripts/maple/reproduce_maple_xd.sh", "synthetic", 1, "{tmp}/published_xd")]),
    "ivlp": ({"SHOTS": "2", "SETTING_B_PAIRS": "2 1"}, [
        _run("scripts/independent-vlp/train.sh", "synthetic", 1, TINY),
        _run("scripts/independent-vlp/test.sh", "synthetic", 1, TINY),
        _run("scripts/independent-vlp/main.sh", "synthetic", 1, 2, TINY),
        _run("scripts/independent-vlp/run_setting_b.sh", "synthetic", 1, TINY, 4, 4)]),
    "ivlp_base2new_reproduce": ({}, [
        _run("scripts/independent-vlp/base2new_train.sh", "synthetic", 1),
        _run("scripts/independent-vlp/base2new_test.sh", "synthetic", 1),
        _run("scripts/independent-vlp/base2new_train_ivlp.sh", "synthetic", 1),
        _run("scripts/independent-vlp/base2new_test_ivlp.sh", "synthetic", 1),
        _run("scripts/independent-vlp/base2new_fewshot_train.sh", "synthetic", 1, SHOTS8),
        _run("scripts/independent-vlp/base2new_fewshot_test.sh", "synthetic", 1, SHOTS8),
        _export(f"base2new/train_base/synthetic/shots_16/IVLP/{TINY}/seed1/VLPromptLearner/"
                "model.pkl-1", "IVLP", "published/base/seed1/VLPromptLearner/model.pth.tar-1"),
        _run("scripts/independent-vlp/reproduce_ivlp.sh", "synthetic", 1, "{tmp}/published")]),
    "promptsrc_fewshot_sweeps": ({"SEEDS": "1", "SETTING_B_PAIRS": "2 1"}, [
        _run("scripts/promptsrc/base2new_train.sh", "synthetic", 1),
        _run("scripts/promptsrc/base2new_test.sh", "synthetic", 1),
        _run("scripts/promptsrc/few_shot.sh", "synthetic", 2),
        _run("scripts/promptsrc/run_setting_b.sh", "synthetic", 1, TINY, 4, 4),
        _export(f"synthetic/PromptSRC/{TINY}_2shots/seed1/VLPromptLearner/model.pkl-1",
                "PromptSRC", "published_fs/2shot/seed1/VLPromptLearner/model.pth.tar-1"),
        _run("scripts/promptsrc/reproduce_few_shot.sh", "synthetic", 2, 1, "{tmp}/published_fs")]),
    "promptsrc_xd": ({"DG_DATASETS": "imagenetv2"}, [
        _run("scripts/promptsrc/xd_train.sh", 1),
        _run("scripts/promptsrc/xd_test.sh", "synthetic", 1),
        _run("scripts/promptsrc/xd_eval_dg_suite.sh", 1),
        _export(f"imagenet/PromptSRC/{TINY}_16shots/seed1/VLPromptLearner/model.pkl-1",
                "PromptSRC", "published_xd/seed1/VLPromptLearner/model.pth.tar-1"),
        _run("scripts/promptsrc/reproduce_xd.sh", "synthetic", 1, "{tmp}/published_xd")]),
    "promptsrc_smoke": ({"LOADEP": "2", "FSVLM_EXTRA_OPTS": SMOKE_OPTS}, [
        _run("scripts/promptsrc/base2new_fewshot_train.sh", "synthetic", 1, "[4,4,4,4,1,1,1,1]"),
        _run("scripts/promptsrc/base2new_fewshot_test.sh", "synthetic", 1, "[4,4,4,4,1,1,1,1]"),
        _run("scripts/promptsrc/base2new_train.sh", "synthetic", 1),
        _export(f"base2new/train_base/synthetic/shots_16/PromptSRC/{TINY}/seed1/VLPromptLearner/"
                "model.pkl-2", "PromptSRC", "published/base/seed1/VLPromptLearner/model.pth.tar-2"),
        _run("scripts/promptsrc/reproduce_base2novel_setting.sh", "synthetic", 1,
             "{tmp}/published")]),
    "plip": ({}, [
        _run("scripts/plip/main.sh", "synthetic", 1, 2, TINY),
        _run("scripts/plip/base2new_train.sh", "synthetic", 1),
        _run("scripts/plip/base2new_test.sh", "synthetic", 1)]),
    "lora": ({}, [
        _run("scripts/lora/main.sh", "synthetic", 1, 2, TINY),
        _run("scripts/lora/base2new_train.sh", "synthetic", 1),
        _run("scripts/lora/base2new_test.sh", "synthetic", 1)]),
    "lora_main_val": ({"SAMPLER": "WeightedClassSampler",
                       "FSVLM_EXTRA_OPTS": "OPTIM.MAX_EPOCH 1 TEST.NO_TEST True"}, [
        _run("scripts/lora/main_val.sh", "synthetic", 1, 4, TINY)]),
    "linear_probe": ({"SHOTS": "2", "BACKBONE": "test-tiny"}, [
        _run("scripts/linear_probe/train.sh", "synthetic", "test-tiny", "ce", 1),
        _run("scripts/linear_probe/test.sh", "synthetic", "test-tiny", "ce", 1),
        _run("scripts/linear_probe/main.sh", "synthetic", 1, 2, TINY),
        *(_run(f"scripts/linear_probe/{s}.sh") for s in ("aircraft", "imagenet", "pets"))]),
    "linear_probe_base2new": ({"BACKBONE": "test-tiny"}, [
        _run("scripts/linear_probe/base2new_train.sh", "synthetic", 1),
        _run("scripts/linear_probe/base2new_test.sh", "synthetic", 1)]),
    "lpclip": ({}, [
        _run("scripts/lpclip/feat_extractor.sh", "synthetic", "test-tiny", 2, 1),
        _run("scripts/lpclip/linear_probe.sh", "synthetic", "test-tiny", 2, 1)]),
    "zsclip": ({"BACKBONE": "test-tiny"}, [
        _run("scripts/zsclip/zeroshot.sh", "synthetic", "test-tiny"),
        _run("scripts/zsclip/zeroshot_sub.sh", "synthetic", "base")]),
}


def _env(out_root, chain_env):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "FSVLM_EXTRA_OPTS")}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", OUT_ROOT=out_root, CFG=TINY,
               LOADEP="1", FSVLM_EXTRA_OPTS=BASE_OPTS)
    env.update(chain_env)
    return env


def _side(side, tmp, chain_env, steps):
    """Run ``steps`` as ``side`` ("jax": bash, "port": the runner) into
    ``tmp/out``."""
    out = os.path.join(tmp, "out")
    env = _env(out, chain_env)
    for step in steps:
        if step[0] == "export":
            _, ckpt_rel, trainer, dest_rel = step
            ckpt = os.path.normpath(os.path.join(out, ckpt_rel))
            dest = os.path.join(tmp, dest_rel)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            tool = ([os.path.join(ROOT, "tools", "import_torch_prompts.py")] if side == "jax"
                    else ["-m", "fsvlm_tpu_torch.tools.import_torch_prompts"])
            r = subprocess.run([sys.executable, *tool, ckpt, "--trainer", trainer, "--export", dest],
                               cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
            assert r.returncode == 0, (side, step, r.stdout[-2000:] + r.stderr[-2000:])
            continue
        _, script, args = step
        args = [a.replace("{tmp}", tmp) for a in args]
        cmd = (["bash", os.path.join(ROOT, script)] if side == "jax" else
               [sys.executable, "-m", "fsvlm_tpu_torch.run_script", "--device", "cpu", script])
        r = subprocess.run(cmd + args, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=1800)
        assert r.returncode == 0, (side, script, r.stdout[-3000:] + r.stderr[-3000:])
        if side == "port":
            calls = re.findall(r"run_script: (\d+) python call\(s\), (\d+) failed", r.stdout)
            assert calls and int(calls[-1][0]) > 0 and calls[-1][1] == "0", r.stdout[-2000:]
    return out


def _tree(root):
    """The sorted relative paths of the files under ``root``, event files
    and the logs kept from an earlier run into the same directory by their
    prefix (their names hold the time and host)."""
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            rel = re.sub(r"events\.out\.tfevents\..*", "events.out.tfevents.*", rel)
            out.append(re.sub(r"log\.txt-[\d-]+$", "log.txt-*", rel))
    return sorted(out)


def _table_rows(root):
    """{directory holding seed folders: parse_test_res.py's rows, without
    the values}."""
    rows = {}
    for d, dirs, _ in os.walk(root):
        if any(x.startswith("seed") for x in dirs):
            r = subprocess.run([sys.executable, os.path.join(ROOT, "parse_test_res.py"), d],
                               capture_output=True, text=True, timeout=120)
            assert r.returncode == 0, r.stderr[-2000:]
            rows[os.path.relpath(d, root)] = sorted(
                re.sub(r"[-+]?\d+\.\d+", "#", ln) for ln in r.stdout.splitlines()
                if ln.startswith("* "))
    return rows


@pytest.mark.slow
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_through_the_runner_matches_jax(chain, tmp_path):
    chain_env, steps = CHAINS[chain]
    roots = {side: _side(side, str(tmp_path / side), chain_env, steps) for side in ("jax", "port")}
    want, got = _tree(roots["jax"]), _tree(roots["port"])
    assert got == want, (sorted(set(got) - set(want)), sorted(set(want) - set(got)))
    assert _table_rows(roots["port"]) == _table_rows(roots["jax"])


def test_every_driver_is_run_or_listed():
    """Each driver under scripts/ is run by a chain above or listed with its
    reason; nothing listed or run is missing from scripts/."""
    all_scripts = {os.path.relpath(p, ROOT)
                   for p in glob.glob(os.path.join(ROOT, "scripts", "**", "*.sh"), recursive=True)}
    run = {step[1] for _, steps in CHAINS.values() for step in steps if step[0] == "run"}
    assert not run & set(LISTED)
    assert sorted(all_scripts - run - set(LISTED)) == []
    assert sorted((run | set(LISTED)) - all_scripts) == []
    with_python = {s for s in all_scripts
                   if re.search(r"^\s*python3? ", open(os.path.join(ROOT, s)).read(), re.M)}
    assert len(with_python) >= 49 and with_python <= run | {"scripts/_lib/base2new_fewshot.sh",
                                                           "scripts/_lib/base2new_test.sh"}
