#!/usr/bin/env python3
"""Compare the CTA shapes of the bf16 tensor-core backward's tiled kernels
(``mma_attn::launch_bwd`` from the LSE: #7/#8 in
``fsvlm_tpu_torch/ops/kernels/flash_attn_bwd.cu`` at D = 64, #4/#5 in
``blockwise_attn_bwd.cu`` at D = 32, 64 and 128) on one CUDA card.

    python3 compare_bwd_ctas.py

Compiles one small library of its own (with build.py's flags, into the
build directory) whose C entries launch ``mma_attn::launch_bwd<D, kDkv,
true, W>`` for D in DIMS and W in WARPS (CTAs of 16 W own rows), as the two
sources do for bf16, and prints the tiled kernels' registers and spills.
At each D's shape (chip_smoke.py's BW_TIMED vision shapes: (48, 24, 201,
32), (48, 12, 201, 64), (48, 6, 201, 128), unmasked) every W's backward is
first held to the plain blockwise backward (bf16 limit of chip_smoke.py).
Then the dK/dV and dQ kernels are timed by CUDA events and by device time
alone (torch.profiler), the warp counts in turns (4, 8, 8, 4, ...) within
this one call.  Prints the card's name and power limit, then one JSON line
per (D, W), its times the medians over the rounds.
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

DIMS = {32: "vision_d32", 64: "vision", 128: "vision_d128"}  # D -> chip_smoke.BW_TIMED label
WARPS = (4, 8)
ROUNDS = 5
NAME = "compare_bwd_ctas"

# the bf16 branches of the two sources' C entries, at head-dim instantiation
# D with W warps per tiled CTA; d and the scale at run time
SOURCE = """#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_attn.cuh"

#define CTA_ENTRIES(D, W)                                                                       \\
  extern "C" int dkv_d##D##_w##W(const void* q, const void* k, const void* v, const void* g,     \\
                                 const void* lse, const void* delta, const void* mask, void* dk, \\
                                 void* dv, int B, int H, int L, int d, float scale,             \\
                                 const long long* strides, void* s) {                           \\
    return mma_attn::launch_bwd<D, true, true, W>(q, k, v, g, lse, nullptr, delta, mask, dk, dv, \\
                                                  B, H, L, d, scale, strides,                   \\
                                                  static_cast<cudaStream_t>(s));                \\
  }                                                                                             \\
  extern "C" int dq_d##D##_w##W(const void* q, const void* k, const void* v, const void* g,      \\
                                const void* lse, const void* delta, const void* mask, void* dq,  \\
                                int B, int H, int L, int d, float scale,                        \\
                                const long long* strides, void* s) {                            \\
    return mma_attn::launch_bwd<D, false, true, W>(q, k, v, g, lse, nullptr, delta, mask, dq,    \\
                                                   nullptr, B, H, L, d, scale, strides,         \\
                                                   static_cast<cudaStream_t>(s));               \\
  }
""" + "".join(f"CTA_ENTRIES({D}, {w})\n" for D in DIMS for w in WARPS)


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
    tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                                 ctypes.c_void_p]
    for D in DIMS:
        for w in WARPS:
            getattr(lib, f"dkv_d{D}_w{w}").argtypes = [ctypes.c_void_p] * 9 + tail
            getattr(lib, f"dq_d{D}_w{w}").argtypes = [ctypes.c_void_p] * 8 + tail
    return lib, time.perf_counter() - t0, log


def _tiled_lines(log):
    """ptxas's register and spill lines of the tiled kernels, by kernel, D
    and warp count (the first and last template arguments of the mangled
    name)."""
    out, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(dkv|dq)_tiled_kernelILi(\d+)ELb1ELi(\d+)EEEv", ln)
            entry = m and f"{m[1]}_tiled D={m[2]} W={m[3]}"
        elif entry and ("registers" in ln or "spill" in ln):
            out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    return out


def main():
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa

    card = chip_smoke.phase_device()
    lib, seconds, log = _build()
    print(f"build: nvcc {seconds:.1f} s", flush=True)
    for ln in _tiled_lines(log):
        print(f"build: {ln}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    calls, shapes = {}, {}
    for D, label in DIMS.items():
        B, H, L, d, causal = chip_smoke.BW_TIMED[label]
        assert d == D and not causal, (label, d, causal)
        q, k, v = chip_smoke._qkv(B, H, L, torch.bfloat16, gen, d)
        do = chip_smoke._blhd_grad(B, H, L, torch.bfloat16, gen, d)
        o, lse = fa._bw_launch(q, k, v, None)
        delta = fa.attention_delta(o, do)
        ptrs = fa._bwd_args(q, k, v, do, lse, delta, None)

        def run(entry, *outs, B=B, H=H, L=L, d=d, q=q, k=k, v=v, do=do, ptrs=ptrs):
            err = getattr(lib, entry)(*ptrs, *(t.data_ptr() for t in outs), B, H, L, d, d ** -0.5,
                                      fa._strides(q, k, v, do, outs[0], outs[-1]), stream)
            if err != 0:
                raise SystemExit(f"FAIL: {entry} launch returned cudaError {err}")
            return outs

        for w in WARPS:
            calls[D, w] = (
                lambda D=D, w=w, run=run, q=q: run(f"dkv_d{D}_w{w}", fa._blhd(q), fa._blhd(q)),
                lambda D=D, w=w, run=run, q=q: run(f"dq_d{D}_w{w}", fa._blhd(q))[0])
        ref = fa.reference_blockwise_bwd(q, k, v, o, lse, do, None)
        scale = max(r.float().abs().max().item() for r in ref)
        for w in WARPS:
            dkv, dq = calls[D, w]
            got = (dq(), *dkv())
            torch.cuda.synchronize()
            rel = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)) / scale
            print(f"check D={D} {w} warps: max|err|/max|ref| {rel:.3e}", flush=True)
            if not np.isfinite(rel) or rel > chip_smoke.TOL_BWD["bfloat16"]:
                raise SystemExit(f"FAIL: the D={D} {w}-warp kernels disagree with the plain "
                                 f"backward")
        shapes[D] = [B, H, L, d]

    times = {key: {"dkv_ms": [], "dq_ms": [], "dkv_device_ms": [], "dq_device_ms": []}
             for key in calls}
    for i in range(ROUNDS):
        for D in DIMS:
            for w in (WARPS if i % 2 == 0 else WARPS[::-1]):
                t, (dkv, dq) = times[D, w], calls[D, w]
                t["dkv_ms"].append(chip_smoke._time_ms(dkv))
                t["dq_ms"].append(chip_smoke._time_ms(dq))
                t["dkv_device_ms"].append(chip_smoke._device_ms(dkv))
                t["dq_device_ms"].append(chip_smoke._device_ms(dq))
    print(card, flush=True)
    for (D, w), t in times.items():
        row = {"D": D, "warps": w, "own_rows": 16 * w, "shape": shapes[D], "causal": False,
               "rounds": ROUNDS}
        row.update({key: float(np.median(vals)) if all(x is not None for x in vals) else None
                    for key, vals in t.items()})
        row["all"] = t
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
