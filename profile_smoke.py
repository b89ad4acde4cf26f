"""Run chip_smoke.py under a sampling profiler of its main thread, to see
where the smoke call's time goes.  Every 0.2 s it records the innermost
frame of the script (function and line) and, beside it, the innermost frame
of any module; at exit the counts go to a JSON file (seconds = count x
0.2).  The script runs as it does alone (same checks, same output); the
sampling costs one thread that wakes five times a second.  On a card:

    python3 profile_smoke.py chip_smoke.py chiprun_out/smoke_profile.json
"""

import collections
import json
import os
import runpy
import sys
import threading

PERIOD = 0.2


def main(target, out):
    target, out = os.path.abspath(target), os.path.abspath(out)
    lines, leaves = collections.Counter(), collections.Counter()
    main_id = threading.main_thread().ident
    done = threading.Event()

    def sample():
        while not done.wait(PERIOD):
            f = sys._current_frames().get(main_id)
            leaf = script = None
            while f is not None:
                if leaf is None:
                    leaf = f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"
                if f.f_code.co_filename == target:
                    script = f"{f.f_code.co_name}:{f.f_lineno}"
                    break
                f = f.f_back
            if script:
                lines[script] += 1
                leaves[f"{script} <- {leaf}"] += 1

    threading.Thread(target=sample, daemon=True).start()
    sys.argv = [target]
    try:
        runpy.run_path(target, run_name="__main__")
    finally:
        done.set()
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"period_s": PERIOD, "lines": lines.most_common(400),
                       "leaves": leaves.most_common(400)}, fh, indent=0)


if __name__ == "__main__":
    main(*sys.argv[1:3])
