#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (fsvlm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; each passes or raises, and any failure exits non-zero:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. build: compile every hand-written kernel from the repo's sources
   (one nvcc per source) and print the build time.
3. kernels: hold each kernel against its plain PyTorch version on the card
   (fp32 and bf16, O and LSE, max-abs tolerances below) at the shapes the
   main path gives it, then time kernel, plain version and the one PyTorch
   library call that computes the same function (a yardstick only).
4. main path: PromptSRC ViT-B/16 serving at full width (random weights from
   seed 0, bf16 frozen towers, bf16 compute, 100 classes): text features
   once, then 3 batches of 100 uint8 224x224 images, through the kernel and
   again with the plain attention; text features, image features, logits
   (absolutely and against their spread between classes) and top-1 must agree.
   Kernel launch counts are zeroed just before the kernel run and read just
   after it: every kernel of the path must have launched.
5. profile: device time by kernel (torch.profiler) over one serving batch
   and one text pass, and the wall time of repeated text passes.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Hopper H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": {"o": 1e-4, "lse": 1e-4}, "bfloat16": {"o": 2e-2, "lse": 1e-2}}
KERNEL_SHAPES = [  # (B, H, L, causal): vision, text at its truncated lengths, edges of L
    (100, 12, 201, False),
    (100, 8, 8, True), (100, 8, 16, True), (100, 8, 24, True), (100, 8, 77, True),
    (2, 4, 513, True), (3, 2, 1, False), (2, 4, 1024, True),
]
N_CLASSES, N_BATCHES, BATCH = 100, 3, 100
# main-path agreement, kernel against plain attention: cosine of the image and
# of the text features; the largest logit difference, absolutely and as a
# share of the image's logit spread between classes (std over the classes)
MIN_COSINE, MAX_DLOGIT, MAX_DLOGIT_OVER_SPREAD = 0.999, 0.1, 0.25


def log(msg):
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False; this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi[0]


def phase_build():
    from fsvlm_tpu_torch.ops.kernels.build import SOURCES, build

    t0 = time.perf_counter()
    for name in SOURCES:
        info = build(name)
        usage = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build {name}: nvcc {info['seconds']:.1f} s; " + " | ".join(usage))
    log(f"build: {time.perf_counter() - t0:.1f} s in all")


def _qkv(B, H, L, dtype, gen):
    """q, k, v as the strided (B, H, L, 64) views that the port's mha makes."""
    import torch

    qkv = torch.randn((B, L, 3 * H * 64), generator=gen, device="cuda").to(dtype)
    return [t.view(B, L, H, 64).transpose(1, 2) for t in qkv.split(H * 64, dim=-1)]


def _time_ms(fn, iters=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(B, H, L, causal, dtype_name, elsize):
    pairs = L * (L + 1) // 2 if causal else L * L  # score entries this data needs
    nbytes = 4 * B * H * L * 64 * elsize + B * H * L * 4 + (L * L * 4 if causal else 0)
    flops = 4 * B * H * pairs * 64
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from fsvlm_tpu_torch.ops.attention import causal_mask
    from fsvlm_tpu_torch.ops.flash_attention import (
        _kernel_fwd, _launch, reference_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0  # max abs error of O or LSE over every checked case
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, H, L, causal in KERNEL_SHAPES:
            q, k, v = _qkv(B, H, L, dtype, gen)
            mask = causal_mask(L, device="cuda") if causal else None
            o, lse = _kernel_fwd(q, k, v, mask)
            o_ref, lse_ref = reference_attention_fwd(q, k, v, mask)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_l = (lse - lse_ref).abs().max().item()
            ok = (np.isfinite(err_o) and np.isfinite(err_l)
                  and err_o <= TOL[name]["o"] and err_l <= TOL[name]["lse"])
            log(f"kernel flash_attn_fwd_d64 {name} B={B} H={H} L={L} "
                f"{'causal' if causal else 'nomask'}: max|dO|={err_o:.3e} "
                f"max|dLSE|={err_l:.3e} (tol {TOL[name]['o']:g}/{TOL[name]['lse']:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL: flash_attn_fwd_d64 disagrees with its plain version "
                                 f"({name}, B={B} H={H} L={L})")
            worst = max(worst, err_o, err_l)
            del q, k, v, o, lse, o_ref, lse_ref

    timings = {}
    for label, (B, H, L, causal) in (("vision", (100, 12, 201, False)),
                                     ("text", (100, 8, 16, True))):
        q, k, v = _qkv(B, H, L, torch.bfloat16, gen)
        mask = causal_mask(L, device="cuda") if causal else None
        ms = _time_ms(lambda: _kernel_fwd(q, k, v, mask))
        # the same launch without the checks and the torch.library dispatch
        direct_ms = _time_ms(lambda: _launch(q, k, v, mask))
        plain_ms = _time_ms(lambda: reference_attention_fwd(q, k, v, mask))
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        bound_ms, bound_by = _bound(B, H, L, causal, "bfloat16", 2)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        log(f"time flash_attn_fwd_d64 bf16 {label} ({B},{H},{L},64) "
            f"{'causal' if causal else 'nomask'}: kernel {ms:.4f} ms (launched directly "
            f"{direct_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return worst, timings


def phase_main():
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.serve import PromptSRCPredictor, PromptSRCServeConfig

    node = PromptSRCServeConfig(PREC="bf16", FROZEN_DTYPE="bf16")
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    t0 = time.perf_counter()
    pred = PromptSRCPredictor(classnames, node=node, backbone="ViT-B/16", seed=0, device="cuda")
    plain = PromptSRCPredictor(classnames, node=node, clip=pred.clip,
                               prompt_params=pred.prompt_params, device="cuda",
                               attn_impl="plain")
    log(f"main: predictors built in {time.perf_counter() - t0:.1f} s "
        f"(text L={pred.frozen['base_embed'].shape[1]})")
    rng = np.random.RandomState(1234)
    batches = [torch.from_numpy(rng.randint(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
               for _ in range(N_BATCHES)]

    def run(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        txf = p.text_features().float()
        torch.cuda.synchronize()
        text_ms = (time.perf_counter() - t) * 1e3
        feats, logits, top, ms = [], [], [], []
        for x in batches:
            t = time.perf_counter()
            f = p.image_features(x)
            lg = p.logits(f)
            top.append(p.topk(lg, 5))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            feats.append(f.float())
            logits.append(lg.float())
        return text_ms, txf, torch.cat(feats), torch.cat(logits), top, ms

    # warm-up (CUDA and cuBLAS set-up, the first launch of each CUDA kernel,
    # the first GEMM of each shape): untimed, uncounted; the timed run
    # computes the text features anew
    for p in (pred, plain):
        p.image_logits(batches[0])
        p._text_features = None
    torch.cuda.synchronize()

    fa.LAUNCHES[fa.KERNEL] = 0
    k_text_ms, k_txf, k_feats, k_logits, k_top, k_ms = run(pred)
    launches = dict(fa.LAUNCHES)
    p_text_ms, p_txf, p_feats, p_logits, _, p_ms = run(plain)

    n = N_BATCHES * BATCH
    E = pred.clip.cfg.embed_dim
    for name, t, shape in (("kernel text features", k_txf, (N_CLASSES, E)),
                           ("plain text features", p_txf, (N_CLASSES, E)),
                           ("kernel features", k_feats, (n, E)), ("plain features", p_feats, (n, E)),
                           ("kernel logits", k_logits, (n, N_CLASSES)),
                           ("plain logits", p_logits, (n, N_CLASSES))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise SystemExit(f"FAIL: {name} shape {tuple(t.shape)} (want {shape}) or not finite")
    if any(len(row) != 5 for tops in k_top for row in tops) or len(k_top[0]) != BATCH:
        raise SystemExit("FAIL: predict top-k has the wrong shape")
    cos = torch.nn.functional.cosine_similarity(k_feats, p_feats, dim=-1)
    cos_txt = torch.nn.functional.cosine_similarity(k_txf, p_txf, dim=-1)
    dlog = (k_logits - p_logits).abs().amax(dim=-1)
    # each image's logit error against the spread of its logits between
    # classes, which is what decides its ranking
    spread = p_logits.std(dim=-1)
    rel = dlog / spread
    top2 = p_logits.topk(2, dim=-1).values
    confident = (top2[:, 0] - top2[:, 1]) > 0.2
    same_top1 = k_logits.argmax(-1) == p_logits.argmax(-1)
    flips = int((confident & ~same_top1).sum())
    log(f"main: text features {k_text_ms:.1f} ms (kernel) / {p_text_ms:.1f} ms (plain); "
        f"ms per batch of {BATCH}: kernel {[round(x, 2) for x in k_ms]}, "
        f"plain {[round(x, 2) for x in p_ms]}")
    log(f"main: min cosine image features {cos.min().item():.6f}, text features "
        f"{cos_txt.min().item():.6f}; max |dlogit| {dlog.max().item():.4f}; logit spread "
        f"between classes (std per image) {spread.min().item():.4f}-{spread.max().item():.4f}, "
        f"max |dlogit|/spread {rel.max().item():.4f}; "
        f"top-1 agreement {same_top1.float().mean().item():.4f}, "
        f"confident images {int(confident.sum())}, confident flips {flips}; launches {launches}")
    if (cos.min().item() < MIN_COSINE or cos_txt.min().item() < MIN_COSINE
            or dlog.max().item() > MAX_DLOGIT or rel.max().item() > MAX_DLOGIT_OVER_SPREAD
            or flips):
        raise SystemExit("FAIL: kernel and plain serving paths disagree")
    expected = pred.clip.cfg.transformer_layers + N_BATCHES * pred.clip.cfg.vision_layers
    if launches[fa.KERNEL] != expected:
        raise SystemExit(f"FAIL: {fa.KERNEL} launched {launches[fa.KERNEL]} times on the "
                         f"main path, expected {expected}")
    return launches, pred, batches[0]


def phase_profile(pred, batch):
    """Device time by kernel over one serving batch and one text pass
    (torch.profiler), and host wall time of repeated text passes, with the
    kernel reached through its torch.library operator (the main path) and
    launched directly, in alternation."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def text_pass():
        pred._text_features = None
        pred.text_features()

    for label, fn in (("image batch of %d" % len(batch), lambda: pred.logits(pred.image_features(batch))),
                      ("text pass", text_pass)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        # kernels only: the aten ops that launched them carry the same device time
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                      key=dev_us, reverse=True)
        busy = sum(dev_us(e) for e in rows)
        log(f"profile: {label}: wall {wall_us / 1e3:.3f} ms under the profiler, device busy "
            f"{busy / 1e3:.3f} ms, idle share {max(0.0, 1 - busy / wall_us):.3f}")
        for e in rows[:12]:
            log(f"profile:   {dev_us(e) / 1e3:9.3f} ms  {100 * dev_us(e) / busy:5.1f}%  "
                f"x{e.count:<4d} {e.key[:100]}")
    op = fa._flash_attn_fwd_op
    walls = {"operator": [], "direct": []}
    try:
        for _ in range(5):
            for route, call in (("operator", op), ("direct", fa._launch)):
                fa._flash_attn_fwd_op = call
                torch.cuda.synchronize()
                t = time.perf_counter()
                text_pass()
                torch.cuda.synchronize()
                walls[route].append(round((time.perf_counter() - t) * 1e3, 3))
    finally:
        fa._flash_attn_fwd_op = op
    log(f"profile: text pass wall ms, 5 repeats each, alternating: through the operator "
        f"{walls['operator']}, launched directly {walls['direct']}")


def main():
    phase_device()
    phase_build()
    worst, timings = phase_kernels()
    launches, pred, batch = phase_main()
    phase_profile(pred, batch)

    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa

    vis = timings["vision"]
    print(json.dumps({"kernels": [{
        "name": fa.KERNEL,
        "route": "cuda",
        "source": "fsvlm_tpu_torch/ops/kernels/flash_attn_fwd.cu",
        "replaces": "fsvlm_tpu/ops/flash_attention.py:544",
        "launches": launches[fa.KERNEL],
        "max_abs_err": worst,
        "ms": vis["ms"],
        "plain_ms": vis["plain_ms"],
        "bound_ms": vis["bound_ms"],
        "bound_by": vis["bound_by"],
        "library_ms": vis["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
