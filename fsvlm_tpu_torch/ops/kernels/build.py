"""Build the hand-written CUDA kernels from the repo's sources at first use.

Each ``.cu`` file here exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes); the wrapper
module registers it as a ``torch.library`` operator.  Libraries go to
``fsvlm_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
source and flags, so an edited source is rebuilt and an unchanged one is
reused.  The hash covers every header (``*.cuh``) in this directory too, since
a source may include one: an edited header rebuilds the libraries.  Nothing
is built or loaded at import time.

``nvcc`` is ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``, else the
toolkit's default location.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(KERNEL_DIR)), "_build")

# library name -> source file in this directory
SOURCES = {
    "flash_attn_fwd": "flash_attn_fwd.cu",
    "flash_attn_bwd": "flash_attn_bwd.cu",
    "blockwise_attn_fwd": "blockwise_attn_fwd.cu",
    "blockwise_attn_bwd": "blockwise_attn_bwd.cu",
    "fused_attn_fwd": "fused_attn_fwd.cu",
    "fused_attn_bwd": "fused_attn_bwd.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
]

_libs = {}


def find_nvcc():
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name):
    headers = sorted(f for f in os.listdir(KERNEL_DIR) if f.endswith(".cuh"))
    h = hashlib.sha256()
    for f in [SOURCES[name], *headers]:
        h.update(f.encode())
        with open(os.path.join(KERNEL_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name):
    """Compile library ``name`` unless it is built already.  Returns
    {"path", "seconds", "log"} (``log``: nvcc's output, empty when reused);
    raises with the compiler's output if the build fails."""
    out = library_path(name)
    if os.path.isfile(out):
        return {"path": out, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(KERNEL_DIR, SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0, "log": log}


def build_all():
    """Build every library in ``SOURCES`` at once, one ``nvcc`` process
    each, all started together.  Returns {name: build()'s dict}; raises the
    first failure once every build has ended."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def load_library(name):
    """The ctypes handle of library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(build(name)["path"])
    return lib
