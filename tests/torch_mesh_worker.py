"""One rank of tests/test_torch_mesh.py's data-parallel steps, on the CPU.

    python tests/torch_mesh_worker.py <case> <world> <rank> <port> <pad_to> <out.npz>

Builds the case's trainer (the same seed on every rank), joins a gloo
process group of ``world`` ranks at localhost:<port> when world > 1, pads
each global batch to a multiple of ``pad_to`` rows (the JAX package's
shard_batch: the last row repeated, ``valid`` False) and runs STEPS steps
on this rank's rows.  Rank 0 writes the weights, the BatchNorm statistics
and each step's metrics to out.npz.  With world 1 and pad_to 2 it is the
one-rank step on the same padded batches.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 2
ZOO = {
    "SEED": 1, "VERBOSE": False, "DATASET.NAME": "SyntheticDA",
    "DATASET.SOURCE_DOMAINS": ["d0", "d1"], "DATASET.TARGET_DOMAINS": ["d2"],
    "INPUT.SIZE": (8, 8), "INPUT.TRANSFORMS": ["normalize"],
    "MODEL.BACKBONE.NAME": "wide_resnet_28_2", "MODEL.BACKBONE.PRETRAINED": False,
    "MODEL.HEAD.NAME": "mlp", "MODEL.HEAD.HIDDEN_LAYERS": (32,),
    "DATALOADER.TRAIN_X.BATCH_SIZE": 24, "DATALOADER.TRAIN_U.BATCH_SIZE": 8,
    "DATALOADER.TRAIN_U.SAME_AS_X": False, "DATALOADER.TEST.BATCH_SIZE": 16,
    "DATALOADER.NUM_WORKERS": 1, "OPTIM.NAME": "sgd", "OPTIM.LR": 0.01,
    "OPTIM.MOMENTUM": 0.9, "OPTIM.WEIGHT_DECAY": 5e-4, "OPTIM.LR_SCHEDULER": "cosine",
    "OPTIM.MAX_EPOCH": 4, "OPTIM.WARMUP_EPOCH": 0, "TEST.NO_TEST": True,
    "TRAIN.PRINT_FREQ": 1000, "TRAIN.COUNT_ITER": "smaller_one",
}
# case: (trainer, settings, labeled rows, unlabeled rows (None: no train_u batch))
CASES = {
    "coop": ("CoOp", {"DATALOADER.DEVICE_AUG": False}, 9, None),
    "fixmatch": ("FixMatch", dict(ZOO, **{"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("normalize",),
                                          "TRAINER.FIXMATCH.CONF_THRE": 0.3}), 9, 5),
    "mixmatch": ("MixMatch", dict(ZOO, **{"DATALOADER.K_TRANSFORMS": 2,
                                          "TRAINER.MIXMATCH.RAMPUP": 2}), 9, 5),
    "fixmatch16": ("FixMatch", dict(ZOO, **{"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("normalize",),
                                            "TRAINER.FIXMATCH.CONF_THRE": 0.3}), 16, 8),
}


def build(case, out_dir):
    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.engine.trainer import build_trainer

    name, settings, _, _ = CASES[case]
    cfg = get_cfg_base()
    if name == "CoOp":
        cfg.merge_from_file(os.path.join(ROOT, "configs", "datasets", "synthetic.yaml"))
        cfg.merge_from_file(os.path.join(ROOT, "configs", "trainers", "tests",
                                         "synthetic_tiny.yaml"))
    kv = dict(settings, **{"TRAINER.NAME": name, "OUTPUT_DIR": out_dir, "SEED": 1})
    cfg.merge_from_list([x for pair in kv.items() for x in pair])
    return build_trainer(cfg, device="cpu")


def batches(case, n_cls):
    """STEPS global (labeled, unlabeled) host batches of the case."""
    name, settings, bx_n, bu_n = CASES[case]
    size = settings.get("INPUT.SIZE", (32, 32))[0]
    k = settings.get("DATALOADER.K_TRANSFORMS", 1)
    rng = np.random.RandomState(17)

    def one(n, strong):
        img = rng.randn(n, *((k,) if k > 1 else ()), size, size, 3).astype(np.float32)
        b = {"img": img, "label": rng.randint(0, n_cls, n).astype(np.int64),
             "domain": np.zeros(n, np.int32), "index": np.arange(n, dtype=np.int32),
             "valid": np.ones(n, bool)}
        if strong:
            b["img2"] = rng.randn(*img.shape).astype(np.float32)
        return b

    strong = name == "FixMatch"
    return [(one(bx_n, strong), one(bu_n, strong) if bu_n else None) for _ in range(STEPS)]


def padded(batch, pad_to):
    from fsvlm_tpu_torch.parallel.mesh import shard_batch

    parts = [shard_batch(batch, pad_to, i) for i in range(pad_to)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def flat_state(t):
    from fsvlm_tpu_torch.models.convert import flatten, zoo_trees

    if hasattr(t, "nets"):
        params, state = zoo_trees(t)
        return {**{f"p/{k}": v for k, v in flatten(params).items()},
                **{f"s/{k}": v for k, v in flatten(state).items()}}
    return {f"p/{k}": v.detach().numpy().copy() for k, v in t.params.items()}


def run(case, world, rank, port, pad_to, out):
    torch.set_num_threads(1)
    if world > 1:
        torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                             world_size=world, rank=rank)
    from fsvlm_tpu_torch.parallel.mesh import shard_batch

    t = build(case, os.path.join(os.path.dirname(out), f"run{rank}"))
    res = {}
    for step, (bx, bu) in enumerate(batches(case, t.num_classes)):
        bx = shard_batch(padded(bx, pad_to), world, rank)
        bu = shard_batch(padded(bu, pad_to), world, rank) if bu is not None else None
        t.epoch, t.batch_idx = divmod(step, t.steps_per_epoch)
        m = t.train_step(bx, batch_u=bu) if hasattr(t, "nets") else t.train_step(bx)
        res.update({f"m{step}/{k}": np.asarray(float(v)) for k, v in m.items()})
    res.update(flat_state(t))
    if rank == 0:
        np.savez(out, **res)
    if world > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    case, world, rank, port, pad_to, out = sys.argv[1:]
    run(case, int(world), int(rank), int(port), int(pad_to), out)
