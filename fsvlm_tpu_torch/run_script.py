"""Run an experiment driver under scripts/ on the port, unchanged.

    python -m fsvlm_tpu_torch.run_script [--device cuda|cpu] scripts/<family>/<driver>.sh [args...]

The driver runs under ``bash`` from the repository's root, with a directory
made for the run first on ``PATH``.  It holds ``python`` and ``python3``,
one shim that routes each call the driver (or a driver it calls in turn)
makes:

- ``python train.py ...`` -> ``<this interpreter> -m fsvlm_tpu_torch.train
  --device D ...``;
- ``python tools/<name>.py ...`` -> ``-m fsvlm_tpu_torch.tools.<name> ...``
  for the tools in ``TOOLS``, with ``--device D`` where the tool declares
  one (``import_torch_prompts`` converts on the host and takes none);
- ``python parse_test_res.py ...`` -> this interpreter, unchanged (it
  imports numpy alone).

``--device`` goes right after the module's name: the CLI's trailing config
options are ``argparse.REMAINDER``, which would swallow it as a key.  Any
other script, ``-m`` or ``-c`` exits 2 with a message that names it, so a
driver never reaches the JAX package.  The environment (OUT_ROOT, CFG,
LOADEP, FSVLM_EXTRA_OPTS, DATA, ...) passes through, with the repository's
root put first on PYTHONPATH for the routed calls.

The shim records every call with its exit code.  The runner prints one
line per call after the driver ends and exits non-zero if any call failed,
even where the driver went on past it; else with the driver's own status.
"""

import argparse
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tools/<name>.py -> fsvlm_tpu_torch.tools.<name>: whether it takes --device
TOOLS = {"lpclip": True, "predict": True, "interpret_prompt": True, "export_serving": True,
         "import_torch_prompts": False}
PASS_THROUGH = ("parse_test_res.py",)
REFUSED = 2  # a call's exit code where the shim routes nothing

_SHIM = r'''#!{executable} -S
# python shim of fsvlm_tpu_torch.run_script: routes a driver's python calls
import json, os, subprocess, sys
CONF = json.loads({conf!r})
argv = sys.argv[1:]
first = os.path.realpath(argv[0]) if argv and not argv[0].startswith("-") else None
rel = os.path.relpath(first, CONF["root"]) if first else None
env = None
if rel == "train.py" or (rel and rel.startswith("tools" + os.sep) and rel.endswith(".py")
                         and rel[6:-3] in CONF["tools"]):
    name = "train" if rel == "train.py" else "tools." + rel[6:-3]
    dev = ["--device", CONF["device"]] if name == "train" or CONF["tools"][rel[6:-3]] else []
    cmd = [CONF["python"], "-m", "fsvlm_tpu_torch." + name] + dev + argv[1:]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([CONF["root"]] + [p for p in
                                        env.get("PYTHONPATH", "").split(os.pathsep) if p])
elif rel in CONF["pass_through"]:
    cmd = [CONF["executable"]] + argv
else:
    cmd = None
    print("run_script: refused `python " + " ".join(argv) + "`: only train.py, tools/{{"
          + ",".join(sorted(CONF["tools"])) + "}}.py and " + ",".join(CONF["pass_through"])
          + " are routed to the port", file=sys.stderr, flush=True)
rc = subprocess.call(cmd, env=env) if cmd else CONF["refused"]
with open(CONF["record"], "a") as f:
    f.write(json.dumps({{"argv": argv, "cmd": cmd, "rc": rc}}) + "\n")
sys.exit(rc)
'''


def make_shim(directory, device, record, python=None):
    """Write the ``python`` / ``python3`` shim into ``directory``: routed
    calls run ``python`` (default this interpreter) on ``device``, and each
    call is appended to ``record`` as a JSON line {argv, cmd, rc}."""
    conf = {"root": ROOT, "device": device, "record": record, "tools": TOOLS,
            "pass_through": list(PASS_THROUGH), "python": python or sys.executable,
            "executable": sys.executable, "refused": REFUSED}
    text = _SHIM.format(executable=sys.executable, conf=json.dumps(conf))
    for name in ("python", "python3"):
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            f.write(text)
        os.chmod(path, 0o755)


def run_script(script, args=(), device="cuda", python=None):
    """Run ``bash script args`` from the repository's root with the shim
    first on PATH.  Returns (the runner's exit code, the driver's, the
    recorded calls).  ``python``: the interpreter of the routed calls
    (default this one)."""
    path = os.path.abspath(script)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no driver {script!r}")
    work = tempfile.mkdtemp(prefix="fsvlm_run_script_")
    try:
        record = os.path.join(work, "calls.jsonl")
        bindir = os.path.join(work, "bin")
        os.mkdir(bindir)
        make_shim(bindir, device, record, python)
        env = dict(os.environ, PATH=os.pathsep.join([bindir, os.environ.get("PATH", "")]))
        driver_rc = subprocess.call(["bash", path, *map(str, args)], cwd=ROOT, env=env)
        calls = []
        if os.path.exists(record):
            with open(record) as f:
                calls = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failed = [c for c in calls if c["rc"] != 0]
    rc = (driver_rc or 1) if failed else driver_rc
    return rc, driver_rc, calls


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="where the routed calls run (default cuda)")
    p.add_argument("script", help="the driver, e.g. scripts/zsclip/zeroshot.sh")
    p.add_argument("args", nargs=argparse.REMAINDER, help="the driver's own arguments")
    a = p.parse_args(argv)
    from . import resolve_device

    resolve_device(a.device)  # no card where cuda is asked for: raise before the driver runs
    rc, driver_rc, calls = run_script(a.script, a.args, device=a.device)
    for c in calls:
        routed = shlex.join(c["cmd"]) if c["cmd"] else "refused"
        print(f"run_script: rc {c['rc']}: python {shlex.join(c['argv'])} -> {routed}", flush=True)
    print(f"run_script: {len(calls)} python call(s), {sum(c['rc'] != 0 for c in calls)} failed; "
          f"the driver exited {driver_rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
