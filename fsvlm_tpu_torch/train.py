"""The experiment CLI (counterpart of the JAX package's train.py): the same
flags and flow, on the card unless ``--device cpu``.

    python -m fsvlm_tpu_torch.train --trainer PromptSRC --seed 1 \\
        --dataset-config-file configs/datasets/synthetic.yaml \\
        --config-file configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml \\
        --output-dir output/run1 [DATALOADER.DEVICE_AUG True] [opts...]
    python -m fsvlm_tpu_torch.train ... --eval-only --model-dir output/run1 --load-epoch 20
    python -m fsvlm_tpu_torch.train --trainer PromptSRC --seed 1 --root <data root> \\
        --dataset-config-file configs/datasets/caltech101.yaml ...   # a docs/DATASETS.md tree

Config: defaults.py's values (``get_cfg_base``), then the dataset and
trainer yaml files, then the named flags, then the trailing KEY VALUE
opts, then $FSVLM_EXTRA_OPTS (space-separated KEY VALUE pairs, applied
last).  Output: ``log.txt`` in the output directory (a tee of stdout that
parse_test_res.py reads), the checkpoints under
``<output dir>/<model name>/``, and after the test the classification
report (per-class precision, recall, F1 and support, as scikit-learn's
``classification_report`` prints it) and, for a dataset of
``DATASET_NAME_TO_BASECOUNT`` evaluated on all its classes, the base/new
accuracy split.  Training augments on the host (INPUT.TRANSFORMS through
``data.transforms.TrainTransform``, defaults.py's DATALOADER.DEVICE_AUG
False) or, under DATALOADER.DEVICE_AUG True, on the device.  The SimCLR
objectives (SIMCLR_ALPHA > 0, LOSS_TYPE simclr) train on the two-view
loader (``maybe_override_simclr_loader``) and raise under DEVICE_AUG.

Across ranks (``parallel/mesh.py``), one process per device: under
FSVLM_MULTIHOST=1 the rendezvous at FSVLM_COORDINATOR=host:port with
FSVLM_NUM_PROCESSES and FSVLM_PROCESS_ID (FSVLM_INIT_TIMEOUT seconds,
default 600), or without FSVLM_COORDINATOR torchrun's environment
(``FSVLM_MULTIHOST=1 torchrun --nproc-per-node 4 -m fsvlm_tpu_torch.train
...``); NCCL on cuda, each rank on its local card, gloo under ``--device
cpu``.  Every rank runs its rows of the global batch and prints the same
test lines; rank 0 alone writes log.txt, the checkpoints and TensorBoard.
"""

import argparse
import os
import shlex
import sys

import numpy as np
import torch

from .config import get_cfg_base
from .engine.trainer import build_trainer
from .parallel import mesh
from .utils import collect_env_info, set_random_seed, setup_logger

# per-dataset base-class counts for the base/new accuracy split when
# evaluating with SUBSAMPLE_CLASSES=all (the JAX package's train.py:32-51)
DATASET_NAME_TO_BASECOUNT = {
    "DescribableTextures": 24,
    "OxfordPets": 19,
    "OxfordFlowers": 51,
    "FGVCAircraft": 50,
    "Caltech101": 50,  # ceil(100 / 2): the reference's table says 51
    "Food101": 51,
    "UCF101": 51,
    "StanfordCars": 98,
    "SUN397": 199,
    "EuroSAT": 5,
    "ImageNet": 500,
}


def reset_cfg(cfg, args):
    """Named CLI flags -> cfg."""
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    if args.seed is not None:
        cfg.SEED = args.seed
    if args.source_domains:
        cfg.DATASET.SOURCE_DOMAINS = tuple(args.source_domains)
    if args.target_domains:
        cfg.DATASET.TARGET_DOMAINS = tuple(args.target_domains)
    if args.transforms:
        cfg.INPUT.TRANSFORMS = tuple(args.transforms)
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.head:
        cfg.MODEL.HEAD.NAME = args.head


def setup_cfg(args):
    cfg = get_cfg_base()
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    reset_cfg(cfg, args)
    if args.opts:
        cfg.merge_from_list(args.opts)
    extra = os.environ.get("FSVLM_EXTRA_OPTS", "").strip()
    if extra:
        cfg.merge_from_list(shlex.split(extra))
    return cfg


def print_args(args, cfg):
    print("***************")
    print("** Arguments **")
    print("***************")
    for key in sorted(vars(args)):
        print(f"{key}: {getattr(args, key)}")
    print("************")
    print("** Config **")
    print("************")
    print(cfg)


def classification_report(y_true, y_pred, digits=2):
    """scikit-learn's ``classification_report(y_true, y_pred,
    zero_division=0)`` text, computed with numpy: per label of the sorted
    union of y_true and y_pred its precision, recall, F1 and support, then
    accuracy, macro and support-weighted averages."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], np.float64)
    n_pred = np.array([np.sum(y_pred == c) for c in labels], np.float64)
    support = np.array([np.sum(y_true == c) for c in labels])
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(n_pred > 0, tp / n_pred, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = n_pred + support
        f1 = np.where(denom > 0, 2 * tp / denom, 0.0)
    names = [str(c) for c in labels]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    report = ("{:>{width}s} " + " {:>9}" * 4).format(
        "", "precision", "recall", "f1-score", "support", width=width) + "\n\n"
    row = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for n, p, r, f, s in zip(names, precision, recall, f1, support):
        report += row.format(n, p, r, f, s, width=width, digits=digits)
    report += "\n"
    total = int(support.sum())
    accuracy = float(tp.sum() / total) if total else 0.0
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n").format(
        "accuracy", "", "", accuracy, total, width=width, digits=digits)
    weights = support / total if total else np.zeros(len(labels))
    for name, avg in (("macro avg", lambda v: float(np.mean(v))),
                      ("weighted avg", lambda v: float(np.sum(v * weights)))):
        report += row.format(name, avg(precision), avg(recall), avg(f1), total, width=width,
                             digits=digits)
    return report


def report(y_true, y_pred, base_label_count):
    print("\n===========================")
    print("Classification Report")
    print("===========================")
    print(classification_report(y_true, y_pred))
    if base_label_count > 0:
        y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
        base_mask = y_true < base_label_count
        for name, mask in (("Base", base_mask), ("New ", ~base_mask)):
            total = int(mask.sum())
            correct = int((y_pred[mask] == y_true[mask]).sum())
            acc = 100.0 * correct / total if total else 0.0
            print(f"{name} class accuracy: {acc:.2f}% ({correct}/{total})")


def maybe_override_simclr_loader(cfg, trainer):
    """The SimCLR objectives (SIMCLR_ALPHA > 0, LOSS_TYPE simclr) train on
    the two-view loader (the JAX package's train.py:131-157): it replaces
    the built train loader, so that the schedule keeps the built loader's
    steps per epoch.  Under DATALOADER.DEVICE_AUG they raise, as there."""
    t = cfg.TRAINER
    if not (t.PROMPTSRC.SIMCLR_ALPHA > 0 or t.IVLP.SIMCLR_ALPHA > 0
            or "simclr" in (t.COOP.LOSS_TYPE, t.PROMPTSRC.LOSS_TYPE)):
        return
    if cfg.DATALOADER.DEVICE_AUG:
        raise ValueError(
            "SimCLR objectives require the host transform pipeline: unset "
            "DATALOADER.DEVICE_AUG (the two-view loader feeds normalized "
            "float views that the device-fused augment would re-normalize)"
        )
    from .trainers.simclr_utils import make_simclr_loader

    print(">> SimCLR objective active => overriding train_loader_x with a two-view loader!")
    trainer.train_loader_x = make_simclr_loader(cfg, trainer.dm.dataset.train_x)


def main(args, clip=None):
    """Run the CLI flow; returns the trainer.  ``clip``: an already built
    frozen CLIP on the run's device, instead of MODEL.BACKBONE's."""
    cfg = setup_cfg(args)
    logger = None
    console = sys.stdout
    started = False  # whether this call started the process group (FSVLM_MULTIHOST)
    if not mesh.active():
        mesh.init_from_env(torch.device(args.device or "cuda").type)
        started = mesh.active()
    try:
        if cfg.SEED >= 0:
            print(f"Setting fixed seed: {cfg.SEED}")
            set_random_seed(cfg.SEED)
        if mesh.is_main():  # one log.txt
            logger = setup_logger(cfg.OUTPUT_DIR)
        print_args(args, cfg)
        print("Collecting env info ...")
        print(f"** System info **\n{collect_env_info()}\n")

        base_label_count = DATASET_NAME_TO_BASECOUNT.get(cfg.DATASET.NAME, 0)
        if cfg.DATASET.SUBSAMPLE_CLASSES != "all":
            base_label_count = 0  # the split is meaningful on the full label set only
        trainer = build_trainer(cfg, device=args.device, clip=clip)
        maybe_override_simclr_loader(cfg, trainer)

        if args.eval_only:
            trainer.load_model(args.model_dir, epoch=args.load_epoch)
            y_true, y_pred = trainer.test(return_pred=True)
            report(y_true, y_pred, base_label_count)
            return trainer
        if not args.no_train:
            trainer.train()
            print(">>> Evaluating on the test set right after training...")
            y_true, y_pred = trainer.test(return_pred=True)
            report(y_true, y_pred, base_label_count)
        return trainer
    finally:
        if logger is not None:
            logger.close()
        sys.stdout = console
        if started:
            torch.distributed.destroy_process_group()


def build_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="", help="path to dataset root")
    parser.add_argument("--output-dir", type=str, default="", help="output directory")
    parser.add_argument("--resume", type=str, default="",
                        help="output directory of the run to resume (contains <model-name>/checkpoint)")
    parser.add_argument("--seed", type=int, default=-1, help="only positive value enables a fixed seed")
    parser.add_argument("--config-file", type=str, default="", help="path to trainer config file")
    parser.add_argument("--dataset-config-file", type=str, default="", help="path to dataset config file")
    parser.add_argument("--trainer", type=str, default="", help="name of trainer")
    parser.add_argument("--backbone", type=str, default="", help="name of CLIP backbone")
    parser.add_argument("--head", type=str, default="", help="name of head")
    parser.add_argument("--source-domains", type=str, nargs="+", help="source domains for DA/DG")
    parser.add_argument("--target-domains", type=str, nargs="+", help="target domains for DA/DG")
    parser.add_argument("--transforms", type=str, nargs="+", help="data augmentation methods")
    parser.add_argument("--eval-only", action="store_true", help="evaluation only")
    parser.add_argument("--model-dir", type=str, default="",
                        help="load model for eval-only from this directory")
    parser.add_argument("--load-epoch", type=int, default=None,
                        help="load model weights at this epoch for evaluation")
    parser.add_argument("--no-train", action="store_true", help="do not call trainer.train()")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; cpu for tests)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="modify config options using the command-line")
    return parser


if __name__ == "__main__":
    main(build_argparser().parse_args())
