"""The DA zoo's fp32 steps on the card and on its CPU against a float64 step
on the card, from the same state (the card's), batches and dropout masks,
on chip_smoke.py phase 19 (c)'s configuration (cnn_digit5_m3sda 32x32 on
SyntheticDA, TF32 off): per step the worst weight gap (max |a - b| over
the tensor's largest magnitude, tensors that start at zero left out) of
card - CPU, card - float64 and CPU - float64, which shows which side a
card-vs-CPU gap comes from.  On a card:

    python3 compare_zoo_f64.py MCD MME SE M3SDA SourceOnly
"""

import contextlib
import io
import os
import shutil
import sys
import tempfile

import torch

import chip_smoke as c
from fsvlm_tpu_torch.config import get_cfg_base
from fsvlm_tpu_torch.engine.trainer import build_trainer
from fsvlm_tpu_torch.models.draws import Draws, Record, Replay

SETTINGS = {"SEED": 1, "VERBOSE": False, "DATASET.NAME": "SyntheticDA",
            "DATASET.SOURCE_DOMAINS": ["d0", "d1", "d2"], "DATASET.TARGET_DOMAINS": ["d2"],
            "INPUT.SIZE": [32, 32], "INPUT.TRANSFORMS": ["normalize"],
            "MODEL.BACKBONE.NAME": "cnn_digit5_m3sda", "MODEL.BACKBONE.PRETRAINED": False,
            "DATALOADER.TRAIN_X.BATCH_SIZE": c.ZOO_C_BATCH,
            "DATALOADER.TRAIN_U.BATCH_SIZE": c.ZOO_C_BATCH_U,
            "DATALOADER.TRAIN_U.SAME_AS_X": False, "DATALOADER.NUM_WORKERS": 2,
            "OPTIM.NAME": "sgd", "OPTIM.LR": 0.01, "OPTIM.MOMENTUM": 0.9,
            "OPTIM.WEIGHT_DECAY": 5e-4, "OPTIM.MAX_EPOCH": 4, "TEST.NO_TEST": True,
            "TRAIN.COUNT_ITER": "smaller_one"}


def to_float64(t):
    """A trainer's networks, statistics, method state, optimizer buffers and
    batch images in float64 (its losses still cast the logits to fp32)."""
    for m in list(t.nets.values()) + list(t.extra_nets.values()):
        m.double()

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.double() for k, v in tree.items()}

    t.model_state, t.extra = cast(t.model_state), cast(t.extra)
    for o in t.optims.values():
        for b in o.buffers:
            setattr(o, b, [x.double() for x in getattr(o, b)])
    prepare = t.prepare_batch

    def prepare64(batch):
        out = prepare(batch)
        for k in ("img", "img2"):
            if k in out:
                out[k] = out[k].double()
        return out

    t.prepare_batch = prepare64


def copy_state(src, dst):
    """dst's weights, statistics, method state and optimizer state := src's,
    in dst's dtype."""
    dtype = next(iter(dst.nets.values())).parameters().__next__().dtype
    with torch.no_grad():
        for g, m in list(src.nets.items()) + list(src.extra_nets.items()):
            other = dst.nets[g] if g in dst.nets else dst.extra_nets[g]
            for a, b in zip(m.parameters(), other.parameters()):
                b.copy_(a.to(b.device, b.dtype))

        def move(tree):
            return {k: move(v) if isinstance(v, dict) else v.to(dst.device, dtype).clone()
                    for k, v in tree.items()}

        dst.model_state, dst.extra = move(src.model_state), move(src.extra)
        for g, opt in src.optims.items():
            other = dst.optims[g]
            for name in opt.buffers:
                for a, b in zip(getattr(opt, name), getattr(other, name)):
                    b.copy_(a.to(b.device, b.dtype))
            other.count = opt.count.to(dst.device).clone()
            other.notfinite_count = opt.notfinite_count.to(dst.device).clone()


def main(names):
    print(f"cuda matmul TF32 {torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32} (both set off below)")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="compare_zoo_f64_")
    try:
        for name, opts in c.ZOO_C_CASES:
            if name not in names:
                continue
            cfg = get_cfg_base()
            kv = dict(SETTINGS, **opts, **{"TRAINER.NAME": name,
                                           "OUTPUT_DIR": os.path.join(work, name)})
            cfg.merge_from_list([x for pair in kv.items() for x in pair])
            with contextlib.redirect_stdout(io.StringIO()):
                card, cpu, card64 = (build_trainer(cfg, device=d) for d in ("cuda", "cpu", "cuda"))
            to_float64(card64)
            xs = [b for _, b in zip(range(c.ZOO_C_STEPS), card.train_loader_x)]
            us = [b for _, b in zip(range(c.ZOO_C_STEPS), card.train_loader_u)]
            zero = {k for k, v in c._zoo_tensors(card)[0].items() if not v.any()}
            for step in range(c.ZOO_C_STEPS):
                copy_state(card, cpu)
                copy_state(card, card64)
                card.batch_idx = cpu.batch_idx = card64.batch_idx = step
                rec = Record(Draws(card.generator))
                card.train_step(xs[step], draws=rec, batch_u=us[step])
                cpu.train_step(xs[step], draws=Replay(rec.values, "cpu"), batch_u=us[step])
                card64.train_step(xs[step], draws=Replay(rec.values, "cuda"), batch_u=us[step])
                w = {k: c._zoo_tensors(t)[0] for k, t in (("card", card), ("cpu", cpu),
                                                           ("float64", card64))}

                def worst(a, b):
                    gap, at = max((v, k) for k, v in c._zoo_rel(w[a], w[b]).items()
                                  if k not in zero)
                    return f"{gap:.3g} ({at})"

                print(f"{name} step {step}: card - CPU {worst('card', 'cpu')}, card - float64 "
                      f"{worst('card', 'float64')}, CPU - float64 {worst('cpu', 'float64')}",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
