"""``python -m fsvlm_tpu_torch.run_script``: the drivers under scripts/ on the
port, on the CPU (``--device cpu``).

- The shim's routing on a throwaway driver, with a stand-in interpreter
  that records its arguments: ``train.py`` and ``tools/lpclip.py`` go to
  the port's modules with ``--device cpu`` right after the module's name
  (before the trailing config options), ``tools/import_torch_prompts.py``
  without it, ``parse_test_res.py`` to the real interpreter unchanged,
  ``other.py``, ``-m`` and ``-c`` are refused (exit 2, named on stderr);
  a nested ``bash`` driver's calls are routed too; a routed call that
  fails while the driver goes on makes the runner exit non-zero.
- The runner's command line: one line per call, the driver's status, and
  ``--device cuda`` on a box without a card raises before the driver runs.
- Two drivers held against the JAX package on the synthetic dataset at
  test-tiny in fp32, through ``tests/test_scripts_execute_all.py``'s
  OUT_ROOT / CFG / FSVLM_EXTRA_OPTS contract: ``scripts/zsclip/zeroshot_sub.sh``
  (the same accuracy and output tree), and
  ``scripts/promptsrc/base2new_fewshot_test.sh`` on a model directory
  written by the JAX package's own trainer and ``save_model`` (its prompts
  moved off their init by seeded noise), run by JAX and by the runner: the
  same accuracy and output tree.  The train drivers are held by tree and
  table rows in ``tests/test_torch_run_script_drivers.py`` (slow): their
  training draws differ (ROADMAP C.3).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch import run_script as rs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "../tests/synthetic_tiny"
FP32 = ("TRAINER.PROMPTSRC.PREC fp32 TRAINER.COOP.PREC fp32 "
        "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT 2 TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION 2 "
        "DATALOADER.NUM_WORKERS 1")


def _fake_python(tmp_path, log):
    """A stand-in interpreter: appends its arguments to ``log`` as a JSON
    line; exits 3 when they hold --fail."""
    path = tmp_path / "fake_python"
    path.write_text("#!/bin/bash\n"
                    f"{sys.executable} -c 'import json, sys; print(json.dumps(sys.argv[1:]))' "
                    f"\"$@\" >> {log}\n"
                    "for a in \"$@\"; do [ \"$a\" = --fail ] && exit 3; done\nexit 0\n")
    path.chmod(0o755)
    return str(path)


def test_shim_routes_refuses_and_records(tmp_path):
    log = tmp_path / "calls.jsonl"
    inner = tmp_path / "inner.sh"
    inner.write_text("#!/bin/bash\npython3 train.py --root inner\n")
    driver = tmp_path / "driver.sh"
    driver.write_text(f"""#!/bin/bash
python train.py --root x --seed 1 OPTIM.MAX_EPOCH 1 DATASET.NUM_SHOTS 2 || exit 1
python tools/lpclip.py --root y --num-shots 2
python3 tools/import_torch_prompts.py a.pth --trainer PromptSRC --output-dir z
python parse_test_res.py {tmp_path}
python other.py && exit 1
python -m fsvlm_tpu.engine && exit 1
python -c "print(1)" && exit 1
bash {inner}
python train.py --fail
echo driver-went-on
""")
    rc, driver_rc, calls = rs.run_script(str(driver), device="cpu",
                                         python=_fake_python(tmp_path, log))
    assert driver_rc == 0 and rc != 0  # the failed call that the driver ignored
    seen = [json.loads(line) for line in log.read_text().splitlines()]
    assert seen == [
        ["-m", "fsvlm_tpu_torch.train", "--device", "cpu", "--root", "x", "--seed", "1",
         "OPTIM.MAX_EPOCH", "1", "DATASET.NUM_SHOTS", "2"],
        ["-m", "fsvlm_tpu_torch.tools.lpclip", "--device", "cpu", "--root", "y", "--num-shots", "2"],
        ["-m", "fsvlm_tpu_torch.tools.import_torch_prompts", "a.pth", "--trainer", "PromptSRC",
         "--output-dir", "z"],
        ["-m", "fsvlm_tpu_torch.train", "--device", "cpu", "--root", "inner"],
        ["-m", "fsvlm_tpu_torch.train", "--device", "cpu", "--fail"],
    ]
    assert [c["rc"] for c in calls] == [0, 0, 0, 0, 2, 2, 2, 0, 3]
    assert calls[3]["cmd"] == [sys.executable, "parse_test_res.py", str(tmp_path)]
    assert [c["cmd"] for c in calls[4:7]] == [None] * 3
    assert calls[5]["argv"] == ["-m", "fsvlm_tpu.engine"]


def test_runner_cli_prints_each_call_and_its_status(tmp_path, capfd):
    driver = tmp_path / "driver.sh"
    driver.write_text(f"#!/bin/bash\npython parse_test_res.py {tmp_path}\n"
                      "python other.py || echo ignored\n")
    assert rs.main(["--device", "cpu", str(driver)]) == 1
    out = capfd.readouterr()
    assert "refused `python other.py`" in out.err
    assert f"run_script: rc 0: python parse_test_res.py {tmp_path} -> " in out.out
    assert "run_script: rc 2: python other.py -> refused" in out.out
    assert "2 python call(s), 1 failed; the driver exited 0" in out.out
    driver.write_text(f"#!/bin/bash\npython parse_test_res.py {tmp_path}\n")
    assert rs.main(["--device", "cpu", str(driver)]) == 0
    driver.write_text("#!/bin/bash\nexit 5\n")
    assert rs.main(["--device", "cpu", str(driver)]) == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rs.main([str(driver)])  # cuda by default: no card, no run


def _env(out_root, extra=""):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "FSVLM_EXTRA_OPTS")}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", OUT_ROOT=str(out_root), CFG=TINY,
               LOADEP="1", FSVLM_EXTRA_OPTS=f"{FP32} {extra}".strip())
    return env


def _both_drivers(script, args, env_jax, env_port):
    """The driver run by JAX (bash, the JAX package's train.py) and by the
    runner on the CPU, side by side; returns their stdouts."""
    procs = {
        "jax": subprocess.Popen(["bash", os.path.join(ROOT, script), *map(str, args)],
                                cwd=ROOT, env=env_jax, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen([sys.executable, "-m", "fsvlm_tpu_torch.run_script", "--device",
                                  "cpu", script, *map(str, args)], cwd=ROOT, env=env_port,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, (name, stdout[-3000:] + stderr[-3000:])
            out[name] = stdout
    finally:
        for p in procs.values():
            p.kill()
    assert "1 python call(s), 0 failed" in out["port"], out["port"][-2000:]
    return out["jax"], out["port"]


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


def _accuracy(text):
    return [float(x) for x in re.findall(r"\* accuracy: ([\d.]+)%", text)]


def test_zeroshot_sub_driver_matches_jax(tmp_path):
    args = ["synthetic", "base"]
    extra = "MODEL.BACKBONE.NAME test-tiny"
    want, got = _both_drivers("scripts/zsclip/zeroshot_sub.sh", args,
                              _env(tmp_path / "jax", extra), _env(tmp_path / "port", extra))
    assert _accuracy(got) == _accuracy(want) and len(_accuracy(got)) == 1, (want, got)
    assert "SUBSAMPLE_CLASSES: base" in got
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") and _tree(tmp_path / "jax")


def _jax_model_dir(out_root, pcs):
    """``base2new_fewshot_train.sh``'s model directory for seed 1, written by
    the JAX package's PromptSRC trainer (its prompts plus seeded noise) and
    its own save_model, as the train driver would after LOADEP = 1 epoch."""
    import jax
    import jax.numpy as jnp
    import train as jax_cli  # the JAX package's CLI, at the repo root

    from fsvlm_tpu.engine import build_trainer as jax_build_trainer

    train_dir = os.path.join(out_root, "base2new/train_all/synthetic/shots_-2/PromptSRC",
                             TINY, "seed1")
    argv = ["--root", "unused", "--seed", "1", "--trainer", "PromptSRC",
            "--dataset-config-file", "configs/datasets/synthetic.yaml",
            "--config-file", f"configs/trainers/PromptSRC/{TINY}.yaml", "--output-dir", train_dir,
            "DATASET.NUM_SHOTS", "-2", "DATASET.PER_CLASS_SHOTS", pcs,
            "DATASET.SUBSAMPLE_CLASSES", "all", *FP32.split()]
    cfg = jax_cli.setup_cfg(jax_cli.build_argparser().parse_args(argv))
    t = jax_build_trainer(cfg)
    rng = np.random.RandomState(0)
    t.params = jax.tree.map(lambda p: p + jnp.asarray(0.5 * rng.randn(*p.shape), p.dtype),
                            t.params)
    t.save_model(0, train_dir)


def test_base2new_fewshot_test_on_a_jax_model_dir_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("FSVLM_EXTRA_OPTS", raising=False)
    pcs = "[2,2,2,2,1,1,1,1]"
    for side in ("jax", "port"):
        _jax_model_dir(str(tmp_path / side), pcs)
    script, args = "scripts/promptsrc/base2new_fewshot_test.sh", ["synthetic", 1, pcs]
    want, got = _both_drivers(script, args, _env(tmp_path / "jax"), _env(tmp_path / "port"))
    assert _accuracy(got) == _accuracy(want) and len(_accuracy(got)) == 1
    assert "SUBSAMPLE_CLASSES: new" in got
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
