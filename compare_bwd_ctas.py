#!/usr/bin/env python3
"""Compare the CTA shapes of the bf16 flash backward's tiled kernels (#7/#8,
``fsvlm_tpu_torch/ops/kernels/flash_attn_bwd.cu``) on one CUDA card.

    python3 compare_bwd_ctas.py

Compiles one small library of its own (with build.py's flags, into the
build directory) whose C entries launch ``mma_attn::launch_bwd`` at d = 64
from the LSE, as ``flash_attn_bwd.cu`` does for bf16, with CTAs of 4 warps
and 64 own rows and of 8 warps and 128, and prints the tiled kernels'
registers and spills.  Each shape's backward is first held to the plain
backward at the vision shape (bf16 limit of chip_smoke.py).  Then the dK/dV
and dQ kernels are timed at the vision shape (48, 12, 201, 64), by CUDA
events and by device time alone (torch.profiler), the shapes in turns
(4, 8, 8, 4, ...) within this one call.  Prints the card's name and power
limit, then one JSON line per shape, its times the medians over the rounds.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

import chip_smoke

WARPS = (4, 8)
ROUNDS = 5
SHAPE = (48, 12, 201, False)  # (B, H, L, causal) at d = 64: the PromptSRC step's vision pass
NAME = "compare_bwd_ctas"

# the bf16 branches of flash_attn_bwd.cu's two C entries, with W warps per tiled CTA
SOURCE = """#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_attn.cuh"

#define CTA_ENTRIES(W)                                                                        \\
  extern "C" int dkv_w##W(const void* q, const void* k, const void* v, const void* g,          \\
                          const void* lse, const void* delta, const void* mask, void* dk,      \\
                          void* dv, int B, int H, int L, const long long* strides, void* s) {  \\
    return mma_attn::launch_bwd<64, true, true, W>(q, k, v, g, lse, nullptr, delta, mask, dk,  \\
                                                   dv, B, H, L, 64, 0.125f, strides,           \\
                                                   static_cast<cudaStream_t>(s));              \\
  }                                                                                           \\
  extern "C" int dq_w##W(const void* q, const void* k, const void* v, const void* g,           \\
                         const void* lse, const void* delta, const void* mask, void* dq, int B, \\
                         int H, int L, const long long* strides, void* s) {                    \\
    return mma_attn::launch_bwd<64, false, true, W>(q, k, v, g, lse, nullptr, delta, mask, dq, \\
                                                    nullptr, B, H, L, 64, 0.125f, strides,     \\
                                                    static_cast<cudaStream_t>(s));             \\
  }
""" + "".join(f"CTA_ENTRIES({w})\n" for w in WARPS)


def _build():
    """Compile SOURCE; returns (ctypes library, nvcc seconds, nvcc log)."""
    from fsvlm_tpu_torch.ops.kernels import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, f"{NAME}.cu")
    out = os.path.join(build.BUILD_DIR, f"lib{NAME}.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    t0 = time.perf_counter()
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", build.KERNEL_DIR,
                           "-o", out, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"FAIL: nvcc (rc {proc.returncode}):\n{log}")
    lib = ctypes.CDLL(out)
    tail = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    for w in WARPS:
        getattr(lib, f"dkv_w{w}").argtypes = [ctypes.c_void_p] * 9 + tail
        getattr(lib, f"dq_w{w}").argtypes = [ctypes.c_void_p] * 8 + tail
    return lib, time.perf_counter() - t0, log


def _tiled_lines(log):
    """ptxas's register and spill lines of the tiled kernels, by kernel and
    warp count (the last template argument of the mangled name)."""
    out, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(dkv|dq)_tiled_kernelI.*?Li(\d+)EEEv", ln)
            entry = m and f"{m[1]}_tiled W={m[2]}"
        elif entry and ("registers" in ln or "spill" in ln):
            out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    return out


def main():
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops.attention import causal_mask

    card = chip_smoke.phase_device()
    lib, seconds, log = _build()
    print(f"build: nvcc {seconds:.1f} s; " + "; ".join(_tiled_lines(log)), flush=True)

    B, H, L, causal = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = chip_smoke._qkv(B, H, L, torch.bfloat16, gen)
    do = chip_smoke._blhd_grad(B, H, L, torch.bfloat16, gen)
    mask = causal_mask(L, device="cuda") if causal else None
    o, lse = fa._kernel_fwd(q, k, v, mask)
    delta = fa.attention_delta(o, do)
    ptrs = fa._bwd_args(q, k, v, do, lse, delta, mask)
    stream = torch.cuda.current_stream().cuda_stream

    def run(entry, *outs):
        err = getattr(lib, entry)(*ptrs, *(t.data_ptr() for t in outs), B, H, L,
                                  fa._strides(q, k, v, do, outs[0], outs[-1]), stream)
        if err != 0:
            raise SystemExit(f"FAIL: {entry} launch returned cudaError {err}")
        return outs

    def dkv(w):
        return run(f"dkv_w{w}", fa._blhd(q), fa._blhd(q))

    def dq(w):
        return run(f"dq_w{w}", fa._blhd(q))[0]

    ref = fa.reference_attention_bwd(q, k, v, o, lse, do, mask)
    scale = max(r.float().abs().max().item() for r in ref)
    for w in WARPS:
        got = (dq(w), *dkv(w))
        torch.cuda.synchronize()
        rel = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)) / scale
        print(f"check {w} warps: max|err|/max|ref| {rel:.3e}", flush=True)
        if not np.isfinite(rel) or rel > chip_smoke.TOL_BWD["bfloat16"]:
            raise SystemExit(f"FAIL: the {w}-warp kernels disagree with the plain backward")

    times = {w: {"dkv_ms": [], "dq_ms": [], "dkv_device_ms": [], "dq_device_ms": []}
             for w in WARPS}
    for i in range(ROUNDS):
        for w in (WARPS if i % 2 == 0 else WARPS[::-1]):
            t = times[w]
            t["dkv_ms"].append(chip_smoke._time_ms(lambda: dkv(w)))
            t["dq_ms"].append(chip_smoke._time_ms(lambda: dq(w)))
            t["dkv_device_ms"].append(chip_smoke._device_ms(lambda: dkv(w)))
            t["dq_device_ms"].append(chip_smoke._device_ms(lambda: dq(w)))
    print(card, flush=True)
    for w in WARPS:
        row = {"warps": w, "own_rows": 16 * w, "shape": [B, H, L, 64], "causal": causal,
               "rounds": ROUNDS}
        row.update({key: float(np.median(vals)) if all(x is not None for x in vals) else None
                    for key, vals in times[w].items()})
        row["all"] = times[w]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
