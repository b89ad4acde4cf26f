"""The stdout tee (counterpart of fsvlm_tpu.utils.logger): everything printed
is mirrored to ``<output_dir>/log.txt``, or, when that file exists, to
``log.txt-<timestamp>``, so that an earlier run's log is never overwritten.
parse_test_res.py scrapes these files."""

import os
import sys
import time


class Logger:
    def __init__(self, fpath=None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            d = os.path.dirname(fpath)
            if d:
                os.makedirs(d, exist_ok=True)
            self.file = open(fpath, "w")

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        self.console.flush()
        if self.file is not None:
            self.file.close()
            self.file = None


def setup_logger(output=None):
    """Tee stdout to ``output`` (a .txt/.log path, or a directory that gets
    log.txt); returns the Logger, whose ``console`` is the stream it
    replaced."""
    if not output:
        return None
    if output.endswith(".txt") or output.endswith(".log"):
        fpath = output
    else:
        fpath = os.path.join(output, "log.txt")
    if os.path.exists(fpath):
        fpath += time.strftime("-%Y-%m-%d-%H-%M-%S")
    sys.stdout = Logger(fpath)
    return sys.stdout
