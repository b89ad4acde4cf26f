"""Ranks of tests/test_torch_mesh.py's and tests/test_torch_mesh_clip.py's
data-parallel steps, on the CPU.

    python tests/torch_mesh_worker.py <cases> <world> <rank> <port> <pad_to> <out> [<draws.npz>]

``cases`` is one case or a comma-separated list, run one after another in
one process (``out`` then holds "{case}", the case's name).  Joins a gloo
process group of ``world`` ranks at localhost:<port> when world > 1, and
for each case builds its trainer (the same seed on every rank), pads each
global batch to a multiple of ``pad_to`` rows (the JAX package's
shard_batch: the last row repeated, ``valid`` False) and runs STEPS steps
on this rank's rows.  Rank 0 writes the weights, the BatchNorm statistics,
each step's metrics and, for TEST_CASES, test()'s predictions to out.npz.
With world 1 and pad_to 2 it is the one-rank step on the same padded
batches.  ``draws.npz`` hands in a case's mixup draws at each step
("<case>/perm<step>", "<case>/lam<step>": e.g. the JAX package's).  The cases in
SPECIAL run their own checks (the mesh helpers; a fused epoch against step
by step).
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
# the CLIP trainers at test-tiny on Synthetic, host batches, every term on
CLIP = {"DATALOADER.DEVICE_AUG": False, "DATALOADER.NUM_WORKERS": 1, "OPTIM.LR": 0.05,
        "OPTIM.WARMUP_EPOCH": 0}
IVLP_MIX = dict(CLIP, **{"TRAINER.IVLP.USE_MIXUP": True, "TRAINER.IVLP.USE_KD": True,
                         "TRAINER.IVLP.KD_ALPHA": 0.5})
PLIP_GRAD = dict(CLIP, **{"TRAINER.PLIP.REG_TYPE": "grad", "TRAINER.PLIP.REG_COEFF": 0.5})
# case: (trainer, settings, labeled rows, unlabeled rows (None: no train_u batch))
CASES = {
    "coop": ("CoOp", {"DATALOADER.DEVICE_AUG": False}, 9, None),
    "fixmatch": ("FixMatch", dict(ZOO, **{"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("normalize",),
                                          "TRAINER.FIXMATCH.CONF_THRE": 0.3}), 9, 5),
    "mixmatch": ("MixMatch", dict(ZOO, **{"DATALOADER.K_TRANSFORMS": 2,
                                          "TRAINER.MIXMATCH.RAMPUP": 2}), 9, 5),
    "fixmatch16": ("FixMatch", dict(ZOO, **{"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("normalize",),
                                            "TRAINER.FIXMATCH.CONF_THRE": 0.3}), 16, 8),
    "promptsrc_cached": ("PromptSRC", dict(CLIP, **{"TRAINER.PROMPTSRC.CACHED_TEACHER": True}),
                         9, None),
    "promptsrc_simclr": ("PromptSRC", dict(CLIP, **{"TRAINER.PROMPTSRC.SIMCLR_ALPHA": 0.5}),
                         9, None),
    "ivlp_mixup_kd": ("IVLP", IVLP_MIX, 9, None),
    "ivlp_simclr": ("IVLP", dict(CLIP, **{"TRAINER.IVLP.USE_MIXUP": False,
                                          "TRAINER.IVLP.SIMCLR_ALPHA": 0.5}), 9, None),
    "coop_simclr": ("CoOp", dict(CLIP, **{"TRAINER.COOP.LOSS_TYPE": "simclr"}), 9, None),
    "maple": ("MaPLe", CLIP, 9, None),
    "cocoop": ("CoCoOp", dict(CLIP, **{"TRAINER.COCOOP.N_CTX": 2}), 9, None),
    "linear_probe": ("LinearProbeCLIP", CLIP, 9, None),
    "lora_dropout": ("LoRA", dict(CLIP, **{"TRAINER.LORA.DROPOUT_RATE": 0.25}), 9, None),
    "plip_grad": ("PLIP", PLIP_GRAD, 9, None),
    "plip_svd": ("PLIP", dict(PLIP_GRAD, **{"TRAINER.PLIP.REG_TYPE": "svd"}), 9, None),
    "plip_spectral_norm": ("PLIP", dict(PLIP_GRAD, **{"TRAINER.PLIP.REG_TYPE": "spectral_norm"}),
                           9, None),
    "zeroshot": ("ZeroshotCLIP", CLIP, 9, None),
    "zeroshot2": ("ZeroshotCLIP2", CLIP, 9, None),
    "promptsrc_novalid": ("PromptSRC", CLIP, 16, None),  # batches without "valid"
    # against the JAX package's 8-device mesh: 16 rows, no pad row on either
    "promptsrc16": ("PromptSRC", CLIP, 16, None),
    "ivlp_mixup16": ("IVLP", IVLP_MIX, 16, None),
    "plip_grad16": ("PLIP", PLIP_GRAD, 16, None),
}
SIMCLR = ("promptsrc_simclr", "ivlp_simclr", "coop_simclr")  # a second view, "img2"
TEST_CASES = ("promptsrc_cached", "zeroshot", "zeroshot2")  # test()'s predictions too


def build(case, out_dir):
    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.engine.trainer import build_trainer

    name, settings, _, _ = CASES[case]
    cfg = get_cfg_base()
    if "DATASET.NAME" not in settings:  # the CLIP trainers: Synthetic at test-tiny
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
        if case.endswith("_novalid"):
            del b["valid"]
        return b

    strong = name == "FixMatch" or case in SIMCLR
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


def run_case(case, world, rank, pad_to, out, draws):
    from fsvlm_tpu_torch.parallel.mesh import shard_batch

    t = build(case, os.path.join(os.path.dirname(out), f"run{rank}"))
    res = {}
    for step, (bx, bu) in enumerate(batches(case, t.num_classes)):
        bx = shard_batch(padded(bx, pad_to), world, rank)
        bu = shard_batch(padded(bu, pad_to), world, rank) if bu is not None else None
        t.epoch, t.batch_idx = divmod(step, t.steps_per_epoch)
        if hasattr(t, "nets"):
            m = t.train_step(bx, batch_u=bu)
        elif f"{case}/perm{step}" in draws:
            m = t.train_step(bx, mix=(torch.from_numpy(draws[f"{case}/perm{step}"]),
                                      float(draws[f"{case}/lam{step}"])))
        else:
            m = t.train_step(bx)
        res.update({f"m{step}/{k}": np.asarray(float(v)) for k, v in m.items()})
    res.update(flat_state(t))
    if case in TEST_CASES:
        res["pred"] = np.asarray(t.test(return_pred=True)[1])
    if case == "lora_dropout":  # rank 0 alone writes lora/*.pkl
        t.save_model(0, os.path.join(os.path.dirname(out), f"save{rank}"))
    if rank == 0:
        np.savez(out, **res)


def run_helpers(world, rank, out):
    """The mesh helpers on seeded global tensors: this rank's gradients
    (gathered on rank 0) of a loss that reads every rank's rows through
    ``gather_rows_grad`` and of one through ``all_reduce_sum``; a
    replicated term's metric (summed over the ranks) and gradient (summed)."""
    from fsvlm_tpu_torch.engine.trainer import sum_metrics
    from fsvlm_tpu_torch.parallel import mesh

    rng = np.random.RandomState(5)
    X = torch.from_numpy(rng.randn(6, 3))
    P = torch.from_numpy(rng.randn(4, 3))
    b = 6 // world
    x = X[rank * b:(rank + 1) * b].clone().requires_grad_()
    loss = (x @ mesh.gather_rows_grad(x).T).sin().sum()  # every pair of rows, once
    g_gather, = torch.autograd.grad(loss, x)
    x = X.reshape(world, b, 3)[rank].clone().requires_grad_()
    loss = (mesh.all_reduce_sum(x) * x).sum()  # (sum_r x_r)^2 summed over the ranks
    g_sum, = torch.autograd.grad(loss, x)
    p = P.clone().requires_grad_()
    term = mesh.replicated_term((p.sin() ** 2).sum())
    g_term, = torch.autograd.grad(term, p)
    metric = sum_metrics({"term": term.detach()})["term"]
    mesh.all_reduce_([g_term])
    res = {"gather": mesh.gather_rows(g_gather).numpy(), "sum": mesh.gather_rows(g_sum).numpy(),
           "term": metric.numpy(), "term_grad": g_term.numpy()}
    if rank == 0:
        np.savez(out, **res)


FUSED_N, FUSED_B = 12, 3  # 4 steps an epoch, each padded to 4 rows at 2 ranks


def run_fused(world, rank, out):
    """PromptSRC and IVLP (mixup over the global batch, KD) on a uint8 cache
    (DEVICE_AUG), 2 epochs fused (the CPU's eager fused path: the
    schedule's columns, the device counter) and 2 step by step, from the
    same seed: metrics and weights of both, and the fused steps counted."""
    from fsvlm_tpu_torch.config import get_cfg_default
    from fsvlm_tpu_torch.engine import fused
    from fsvlm_tpu_torch.trainers.ivlp import IVLP
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (FUSED_N, 40, 40, 3), dtype=np.uint8)
    labels = np.arange(FUSED_N) % 4
    res = {}
    for cls, node in ((PromptSRC, {}), (IVLP, {"USE_MIXUP": True, "USE_KD": True,
                                                "KD_ALPHA": 0.5})):
        key = cls.trainer_cfg_key
        for mode in ("on", "off"):
            cfg = get_cfg_default()
            cfg.merge_from_list(["SEED", 3, "INPUT.SIZE", (32, 32), "DATASET.NAME", "Synthetic",
                                 "MODEL.BACKBONE.NAME", "test-tiny", "DATALOADER.DEVICE_AUG", True,
                                 "DATALOADER.TRAIN_X.BATCH_SIZE", FUSED_B, "OPTIM.LR", 0.05,
                                 "OPTIM.MAX_EPOCH", 2, "TRAIN.EPOCH_FUSE", mode]
                                + [x for k, v in node.items() for x in (f"TRAINER.{key}.{k}", v)])
            t = cls(cfg, [f"class {i}" for i in range(4)], images, labels, device="cpu")
            fused.STEPS.update(dict.fromkeys(fused.STEPS, 0))
            hist = t.train()
            tag = f"{key}/{mode}"
            res[f"{tag}/fuses"] = np.asarray(t.fuses_epoch())
            res[f"{tag}/eager_steps"] = np.asarray(fused.STEPS["eager"])
            res[f"{tag}/batch"] = np.asarray(t._fused.index.shape[1] if t._fused else 0)
            for e, h in enumerate(hist):
                for i, m in enumerate(h):
                    res.update({f"{tag}/m{e}.{i}/{k}": np.asarray(v) for k, v in m.items()})
            res.update({f"{tag}/{k}": v for k, v in flat_state(t).items()})
            res[f"{tag}/count"] = np.asarray(int(t.optim.count))
    if rank == 0:
        np.savez(out, **res)


SPECIAL = {"helpers": run_helpers, "fused": run_fused}


def run(cases, world, rank, port, pad_to, out, draws=None):
    torch.set_num_threads(1)
    if world > 1:
        torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                             world_size=world, rank=rank)
    draws = dict(np.load(draws)) if draws else {}
    for case in cases.split(","):
        path = out.format(case=case)
        if case in SPECIAL:
            SPECIAL[case](world, rank, path)
        else:
            run_case(case, world, rank, pad_to, path, draws)
    if world > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    cases, world, rank, port, pad_to, out = sys.argv[1:7]
    run(cases, int(world), int(rank), int(port), int(pad_to), out,
        sys.argv[7] if len(sys.argv) > 7 else None)
