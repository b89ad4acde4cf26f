"""Ranks of the data-parallel steps of tests/test_torch_mesh.py,
tests/test_torch_mesh_clip.py and tests/test_torch_mesh_zoo*.py, on the CPU.

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
batches; a world of "1g" is one rank under a gloo process group.
``draws.npz`` hands in a case's mixup draws at each step
("<case>/perm<step>", "<case>/lam<step>": e.g. the JAX package's), or a
zoo case's random values in its draw order ("<case>/d<step>/<i>", replayed
through ``models.draws.Replay``, each rank slicing its rows).  The cases in
SPECIAL run their own checks (the mesh helpers; a fused epoch against step
by step).  A trainer takes its labeled rows through ``shard_x`` (the zoo's
DAELDG, M3SDA and DAEL: its share of every per-domain block); the zoo's
style-mixing nets mix at every forward (p = 1), its ADDA and AdaBN start
from a SourceOnly checkpoint that each process writes (weights only, seed
5), and a case named "*_f64" holds its nets, statistics, optimizer and
images in float64.
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
# the DG and DA zoo on cnn_digitsdg at 32x32 with a BatchNorm head, and
# FixMatch on each kind of network that draws for its rows
ZOO32 = dict(ZOO, **{"INPUT.SIZE": (32, 32), "MODEL.BACKBONE.NAME": "cnn_digitsdg"})
THREE = {"DATASET.SOURCE_DOMAINS": ["d0", "d1", "d2"],
         "DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler", "DATALOADER.TRAIN_X.N_DOMAIN": 3}
TWO_BLOCKS = {"DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler",
              "DATALOADER.TRAIN_X.N_DOMAIN": 2}
SOURCE = "{source}"  # MODEL.INIT_WEIGHTS: the process's SourceOnly checkpoint
FIX32 = dict(ZOO32, **{"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ("normalize",),
                       "TRAINER.FIXMATCH.CONF_THRE": 0.3})
DAELDG = {"TRAINER.DAELDG.STRONG_TRANSFORMS": ("normalize",)}
CDAC = {"DATALOADER.K_TRANSFORMS": 2, "TRAINER.CDAC.STRONG_TRANSFORMS": ("normalize",),
        "TRAINER.CDAC.RAMPUP_ITRS": 4, "TRAINER.CDAC.P_THRESH": 0.5, "OPTIM.LR": 0.005}
ZOO_CASES = {
    "vanilla": ("Vanilla", ZOO32, 9, None),
    "crossgrad": ("CrossGrad", ZOO32, 9, None),
    "ddaig": ("DDAIG", dict(ZOO32, **{"TRAINER.DDAIG.G_ARCH": "fcn_3x32_gctx",
                                      "TRAINER.DDAIG.WARMUP": 0, "TRAINER.DDAIG.CLAMP": True}),
              9, None),
    "domainmix_crossdomain": ("DomainMix", dict(ZOO32, **{
        "TRAINER.DOMAINMIX.TYPE": "crossdomain"}), 9, None),
    "domainmix_random": ("DomainMix", dict(ZOO32, **{"TRAINER.DOMAINMIX.TYPE": "random"}),
                         9, None),
    "daeldg": ("DAELDG", dict(ZOO32, **TWO_BLOCKS, **DAELDG,
                              **{"DATALOADER.TRAIN_X.BATCH_SIZE": 8}), 8, None),
    # 3 blocks of 3 rows: on 2 ranks each block 2 + 2 rows, one a pad row
    "daeldg_odd": ("DAELDG", dict(ZOO32, **THREE, **DAELDG,
                                  **{"DATALOADER.TRAIN_X.BATCH_SIZE": 9}), 9, None),
    "sourceonly": ("SourceOnly", ZOO32, 9, 5),
    "dann": ("DANN", ZOO32, 9, 5),
    "adda": ("ADDA", dict(ZOO32, **{"MODEL.INIT_WEIGHTS": SOURCE}), 9, 5),
    "adabn": ("AdaBN", dict(ZOO32, **{"MODEL.INIT_WEIGHTS": SOURCE}), 9, 5),
    "mcd": ("MCD", dict(ZOO32, **{"TRAINER.MCD.N_STEP_F": 2}), 9, 5),
    "mme": ("MME", ZOO32, 9, 5),
    "se": ("SE", dict(ZOO32, **{"DATALOADER.K_TRANSFORMS": 2, "TRAINER.SE.CONF_THRE": 0.3}), 9, 5),
    "m3sda": ("M3SDA", dict(ZOO32, **THREE, **{"TRAINER.M3SDA.N_STEP_F": 2,
                                              "DATALOADER.TRAIN_X.BATCH_SIZE": 12}), 12, 5),
    "m3sda_odd": ("M3SDA", dict(ZOO32, **THREE, **{"TRAINER.M3SDA.N_STEP_F": 2,
                                                  "DATALOADER.TRAIN_X.BATCH_SIZE": 9}), 9, 5),
    "cdac": ("CDAC", dict(ZOO32, **CDAC), 9, 5),
    "dael": ("DAEL", dict(ZOO32, **THREE, **{"TRAINER.DAEL.STRONG_TRANSFORMS": ("normalize",),
                                            "TRAINER.DAEL.CONF_THRE": 0.3,
                                            "DATALOADER.TRAIN_X.BATCH_SIZE": 12}), 12, 5),
    "fixmatch_mixstyle": ("FixMatch", dict(FIX32, **{"MODEL.BACKBONE.NAME": "resnet18_ms_l12"}),
                          9, 5),
    # MixStyle's crossdomain partners (the whole batch reversed, then
    # shuffled per half), which no backbone of the registry asks for
    "fixmatch_mixstyle_crossdomain": ("FixMatch", dict(FIX32, **{
        "MODEL.BACKBONE.NAME": "resnet18_ms_l12"}), 9, 5),
    # in float64: EFDMix's sort is chaotic in float32 (a value that rounds
    # to ReLU's 0 on one side and past it on the other changes rank, and
    # takes another partner value: one rank against itself with its weights
    # times 1 + 1e-7 moves a running variance by 1.1e-3 in one step)
    "fixmatch_efdmix_f64": ("FixMatch", dict(FIX32, **{
        "MODEL.BACKBONE.NAME": "resnet18_efdmix_l12"}), 9, 5),
    "fixmatch_dropout": ("FixMatch", dict(FIX32, **{"MODEL.BACKBONE.NAME": "cnn_digit5_m3sda"}),
                         9, 5),
    "fixmatch_dropconnect": ("FixMatch", dict(FIX32, **{"MODEL.BACKBONE.NAME": "efficientnet_b0"}),
                             9, 5),
    # against the JAX package's 8-device mesh: 16 + 8 rows, no mesh pad row
    "domainmix_crossdomain16": ("DomainMix", dict(ZOO32, **{
        "TRAINER.DOMAINMIX.TYPE": "crossdomain", "DATALOADER.TRAIN_X.BATCH_SIZE": 16}), 16, None),
    "daeldg16": ("DAELDG", dict(ZOO32, **TWO_BLOCKS, **DAELDG,
                                **{"DATALOADER.TRAIN_X.BATCH_SIZE": 16}), 16, None),
    "m3sda24": ("M3SDA", dict(ZOO32, **THREE, **{"TRAINER.M3SDA.N_STEP_F": 2,
                                                "DATALOADER.TRAIN_X.BATCH_SIZE": 24}), 24, 8),
    "cdac16": ("CDAC", dict(ZOO32, **CDAC), 16, 8),
    "fixmatch_mixstyle16": ("FixMatch", dict(FIX32, **{
        "MODEL.BACKBONE.NAME": "resnet18_ms_l12"}), 16, 8),
}
BLOCKED = ("DAELDG", "M3SDA", "DAEL")  # RandomDomainSampler batches: one domain per block
# one step from the seed's state: their second step parts chaotically from
# rounding (one rank against itself with every weight times 1 + 1e-7 moves
# M3SDA's weights by 3.2e-5 and its statistics by 1.0e-4 in two steps;
# CDAC's P = p_u p_us^T near 1, see test_torch_zoo_da_trainers.py)
ONE_STEP = ("M3SDA", "CDAC")
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
    **ZOO_CASES,
}
SIMCLR = ("promptsrc_simclr", "ivlp_simclr", "coop_simclr")  # a second view, "img2"
# test()'s predictions too (the zoo's: the ensembles of M3SDA, DAEL and DAELDG)
TEST_CASES = ("promptsrc_cached", "zeroshot", "zeroshot2", "daeldg_odd", "m3sda_odd", "dael")


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
    if kv.get("MODEL.INIT_WEIGHTS") == SOURCE:
        kv["MODEL.INIT_WEIGHTS"] = source_checkpoint(settings, out_dir)
    cfg.merge_from_list([x for pair in kv.items() for x in pair])
    return build_trainer(cfg, device="cpu")


def source_checkpoint(settings, out_dir):
    """A SourceOnly net's weights at seed 5 as a checkpoint of weights alone
    (as the JAX package's trajectory tests write one); its path."""
    import pickle

    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.engine.trainer import build_trainer
    from fsvlm_tpu_torch.models.convert import params_tree

    cfg = get_cfg_base()
    kv = dict(settings, **{"TRAINER.NAME": "SourceOnly", "OUTPUT_DIR": out_dir, "SEED": 5})
    del kv["MODEL.INIT_WEIGHTS"]
    cfg.merge_from_list([x for pair in kv.items() for x in pair])
    t = build_trainer(cfg, device="cpu")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "source.pkl")
    with open(path, "wb") as f:
        pickle.dump({"state_dict": {g: params_tree(m) for g, m in t.nets.items()}, "epoch": 1}, f)
    return path


def batches(case, n_cls):
    """STEPS global (labeled, unlabeled) host batches of the case (one for
    ONE_STEP's trainers)."""
    name, settings, bx_n, bu_n = CASES[case]
    size = settings.get("INPUT.SIZE", (32, 32))[0]
    k = settings.get("DATALOADER.K_TRANSFORMS", 1)
    n_dom = len(settings.get("DATASET.SOURCE_DOMAINS", ()))
    rng = np.random.RandomState(17)

    def one(n, strong, x=False):
        img = rng.randn(n, *((k,) if k > 1 else ()), size, size, 3).astype(np.float32)
        if x and name in BLOCKED:  # one domain per block of BATCH_SIZE // N_DOMAIN rows
            nd = settings["DATALOADER.TRAIN_X.N_DOMAIN"]
            split = settings["DATALOADER.TRAIN_X.BATCH_SIZE"] // nd
            domain = np.repeat(rng.permutation(n_dom)[:nd], split)
        else:
            domain = rng.randint(0, max(n_dom, 1), n)
        b = {"img": img, "label": rng.randint(0, n_cls, n).astype(np.int64),
             "domain": domain.astype(np.int32), "index": np.arange(n, dtype=np.int32),
             "valid": np.ones(n, bool)}
        if strong:
            b["img2"] = rng.randn(*img.shape).astype(np.float32)
        if case.endswith("_novalid"):
            del b["valid"]
        return b

    strong = name in ("FixMatch", "DAELDG", "CDAC", "DAEL") or case in SIMCLR
    return [(one(bx_n, strong, True), one(bu_n, strong and name != "DAELDG") if bu_n else None)
            for _ in range(1 if name in ONE_STEP else STEPS)]


def padded(batch, pad_to):
    from fsvlm_tpu_torch.parallel.mesh import shard_batch

    parts = [shard_batch(batch, pad_to, i) for i in range(pad_to)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def flat_state(t):
    from fsvlm_tpu_torch.models.convert import flatten, zoo_trees

    if hasattr(t, "nets"):
        from fsvlm_tpu_torch.models.convert import params_tree, state_tree

        params, state = zoo_trees(t)
        extra = {**state_tree(t.extra), **{k: params_tree(m) for k, m in t.extra_nets.items()}}
        return {**{f"p/{k}": v for k, v in flatten(params).items()},
                **{f"s/{k}": v for k, v in flatten(state).items()},
                **{f"e/{k}": v for k, v in flatten(extra).items()}}
    return {f"p/{k}": v.detach().numpy().copy() for k, v in t.params.items()}


def _double(tree):
    return {k: _double(v) if isinstance(v, dict) else v.double() for k, v in tree.items()}


def _crossdomain(case):
    """MixStyle's crossdomain partners within, for the case that asks."""
    import contextlib
    import functools

    from fsvlm_tpu_torch.models import modeling_ops

    @contextlib.contextmanager
    def patched():
        mixstyle = modeling_ops.mixstyle
        modeling_ops.mixstyle = functools.partial(mixstyle, mix="crossdomain")
        try:
            yield
        finally:
            modeling_ops.mixstyle = mixstyle

    if case.startswith("fixmatch_mixstyle_crossdomain"):
        return patched()
    return contextlib.nullcontext()


def run_case(case, world, rank, pad_to, out, draws):
    with _crossdomain(case):
        _run_case(case, world, rank, pad_to, out, draws)


def _run_case(case, world, rank, pad_to, out, draws):
    from fsvlm_tpu_torch.models.backbones.resnet import ResNetBackbone
    from fsvlm_tpu_torch.models.draws import Replay
    from fsvlm_tpu_torch.parallel.mesh import shard_batch

    t = build(case, os.path.join(os.path.dirname(out), f"run{rank}"))
    zoo = hasattr(t, "nets")
    for m in (m for net in (t.nets.values() if zoo else ()) for m in net.modules()):
        if isinstance(m, ResNetBackbone):
            m.ms_p = 1.0  # every train forward mixes
    if case.endswith("_f64"):
        for net in t.nets.values():
            net.double()
        t.model_state = _double(t.model_state)
        t._build_optimizer(t.steps_per_epoch)
    res = {}
    for step, (bx, bu) in enumerate(batches(case, t.num_classes)):
        if case.endswith("_f64"):
            bx, bu = ({k: v.astype(np.float64) if v.dtype == np.float32 else v
                       for k, v in b.items()} if b is not None else None for b in (bx, bu))
        bx = t.shard_x(padded(bx, pad_to), world, rank)
        bu = shard_batch(padded(bu, pad_to), world, rank) if bu is not None else None
        t.epoch, t.batch_idx = divmod(step, t.steps_per_epoch)
        given = sorted((k for k in draws if k.startswith(f"{case}/d{step}/")),
                       key=lambda k: int(k.rsplit("/", 1)[1]))
        if zoo:
            m = t.train_step(bx, draws=Replay([draws[k] for k in given], "cpu") if given else None,
                             batch_u=bu)
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


def run_zoo_helpers(world, rank, out):
    """The zoo's rules on seeded global tensors (float64), gathered on rank
    0 in the global row order: a per-domain block of 7 rows (4 + 4 rows on
    two ranks, one a pad row): train-mode BatchNorm's output, new
    statistics and the gradients of a weighted sum of its real rows'
    outputs, a per-row draw of Replay's global values (``draw_rows``);
    FixMatch's [x; u] layout of 6 + 4 rows (``global_rows`` of each row's
    global index); ``global_moments`` (ddof 1, rows masked) and
    ``global_pair_mean`` of 8 rows and the gradients of a function of them
    (a ``replicated_term``)."""
    from fsvlm_tpu_torch.engine.trainer import sum_metrics
    from fsvlm_tpu_torch.models.backbones.common import BatchNorm, batch_norm
    from fsvlm_tpu_torch.models.draws import Replay
    from fsvlm_tpu_torch.parallel import mesh

    rng = np.random.RandomState(7)
    X, W = (torch.from_numpy(rng.randn(7, 3, 2, 2)) for _ in range(2))
    res = {}
    with mesh.rows((mesh.block_rows(7), 7)) as lay:
        idx, keep = lay.index("cpu"), lay.weight("cpu")
        keep = torch.ones(len(idx), dtype=torch.float64) if keep is None else keep.double()
        x = X[idx].clone().requires_grad_()
        bn = BatchNorm(3).double()
        state = {k: v.double() for k, v in bn.init_state().items()}
        y, ns = batch_norm(x, bn, state, True)
        loss = (y * W[idx] * keep.view(-1, 1, 1, 1)).sum()
        gx, gs, gb = torch.autograd.grad(loss, [x, bn.scale, bn.bias])
        mesh.all_reduce_([gs, gb])
        replay = Replay([np.arange(7) * 1.5], "cpu")
        drawn = mesh.draw_rows(lambda n: replay.uniform((n,)), len(idx))
        res.update(bn_y=mesh.global_rows(y.detach()), bn_gx=mesh.global_rows(gx), bn_gs=gs,
                   bn_gb=gb, bn_mean=ns["mean"], bn_var=ns["var"],
                   drawn=mesh.global_rows(drawn))
    with mesh.rows(6 // world, 4 // world) as lay:
        res["xu_rows"] = mesh.global_rows(lay.index("cpu"))
    F_ = torch.from_numpy(rng.randn(8, 4))
    valid = torch.from_numpy(np.array([1, 1, 0, 1, 1, 1, 1, 0], bool))
    b = 8 // world
    f = F_[rank * b:(rank + 1) * b].clone().requires_grad_()
    v = valid[rank * b:(rank + 1) * b]
    mu, var = mesh.global_moments(f, v, ddof=1)
    pm = mesh.global_pair_mean((f @ mesh.global_rows(f, grad=True).T).sin(), v)
    term = mesh.replicated_term((mu.sin() * var).sum())
    g_m, = torch.autograd.grad(term, f)
    g_p, = torch.autograd.grad(pm, f)
    res.update(mu=mu.detach(), var=var.detach(), pair_mean=sum_metrics({"pm": pm.detach()})["pm"],
               moments_grad=mesh.gather_rows(g_m), pair_grad=mesh.gather_rows(g_p))
    if rank == 0:
        np.savez(out, **{k: t.detach().numpy() for k, t in res.items()})


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


SPECIAL = {"helpers": run_helpers, "fused": run_fused, "zoo_helpers": run_zoo_helpers}


def run(cases, world, rank, port, pad_to, out, draws=None):
    """``world``: the number of ranks, or "1g": one rank under a process
    group."""
    torch.set_num_threads(1)
    group = world == "1g"
    world = 1 if group else int(world)
    if world > 1 or group:
        torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                             world_size=world, rank=rank)
    draws = dict(np.load(draws)) if draws else {}
    for case in cases.split(","):
        path = out.format(case=case)
        if case in SPECIAL:
            SPECIAL[case](world, rank, path)
        else:
            run_case(case, world, rank, pad_to, path, draws)
    if world > 1 or group:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    cases, world, rank, port, pad_to, out = sys.argv[1:7]
    run(cases, world, int(rank), int(port), int(pad_to), out,
        sys.argv[7] if len(sys.argv) > 7 else None)
