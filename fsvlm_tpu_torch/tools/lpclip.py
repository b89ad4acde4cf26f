"""lpclip: CLIP feature extraction and the logistic-regression linear probe
(counterpart of the repository's tools/lpclip.py).

Parity target: PromptSRC/lpclip/ --
- feat_extractor.py:105-167: the frozen image tower over train/val/test,
  features and labels written to ``{train,val,test}.npz``
  (``feature_list``, ``label_list``);
- linear_probe.py:53-118: few-shot logistic regression with the two-stage
  search over the inverse regularization strength C (a coarse log sweep,
  then the contraction of the bracket around the best), then a fit on
  train + val, scored on test.

The fits are ``tools.logreg.LogisticRegression``, scikit-learn's lbfgs
fit without scikit-learn (scipy's L-BFGS-B over the loss in torch), on
``--device``; the image tower runs in fp32 there, on the card's attention
kernels.  The loaders ship uint8 views, which are normalized on the device
with CLIP's pixel statistics (the JAX package normalizes on the host).

    python -m fsvlm_tpu_torch.tools.lpclip --root $DATA \\
        --dataset-config-file configs/datasets/caltech101.yaml \\
        --backbone ViT-B/16 --num-shots 16 --seed 1 --output-dir /tmp/lpclip \\
        [--device cuda]
"""

import argparse
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.preprocess import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, normalize_only
from .logreg import LogisticRegression


@torch.no_grad()
def extract_split(loader, clip, batch_limit=None, attn_impl=None):
    """The image tower's features of every valid row of ``loader``'s
    batches (at most ``batch_limit`` batches) and their labels, as float32
    and the labels' numpy arrays; unnormalized, as the JAX tool leaves them.
    uint8 batches are normalized with CLIP's statistics on the tower's
    device; ``attn_impl="plain"`` takes the plain attention (comparisons
    only)."""
    from ..models.clip.model import encode_image

    device = clip.logit_scale.device
    mean = torch.tensor(CLIP_PIXEL_MEAN, device=device)
    std = torch.tensor(CLIP_PIXEL_STD, device=device)
    feats, labels = [], []
    for bi, batch in enumerate(loader):
        valid = batch["valid"]
        x = torch.as_tensor(batch["img"]).to(device)
        if x.dtype == torch.uint8:
            x = normalize_only(x, mean, std)
        f = encode_image(clip, x, attn_impl=attn_impl).float().cpu().numpy()
        feats.append(f[valid])
        labels.append(np.asarray(batch["label"])[valid])
        if batch_limit and bi + 1 >= batch_limit:
            break
    return np.concatenate(feats), np.concatenate(labels)


def search_logreg(train_f, train_y, val_f, val_y, max_iter=1000, device=None, fits=None):
    """The two-stage C search (linear_probe.py:53-118), statement for
    statement the JAX tool's, with its printed lines; the fits run on
    ``device`` (default cuda), the features moved there once.  ``fits``:
    an optional list that receives {"C", "ms", "n_iter", "acc", "model"}
    of every fit.  Returns the best C."""
    device = resolve_device(device)
    train_f = torch.as_tensor(train_f).to(device)
    val_f = torch.as_tensor(val_f).to(device)

    def fit_eval(c):
        t0 = time.perf_counter()
        clf = LogisticRegression(C=c, max_iter=max_iter)
        clf.fit(train_f, train_y)
        acc = clf.score(val_f, val_y)
        if fits is not None:
            fits.append({"C": c, "ms": (time.perf_counter() - t0) * 1e3,
                         "n_iter": int(clf.n_iter_[0]), "acc": acc, "model": clf})
        return acc, clf

    # stage 1: coarse sweep over powers of 10
    cs = [10 ** k for k in range(-6, 7, 2)]
    scores = []
    for c in cs:
        acc, _ = fit_eval(c)
        scores.append(acc)
        print(f"C={c:g}: val acc {acc*100:.2f}%")
    best = int(np.argmax(scores))

    # stage 2: the reference's two-endpoint bracket contraction: evaluate
    # both endpoints each round, keep the better one, and move the worse
    # endpoint to the log midpoint
    lo = cs[max(best - 1, 0)]
    hi = cs[min(best + 1, len(cs) - 1)]
    best_c, best_acc = cs[best], scores[best]
    memo = {}

    def eval_c(c):
        if c not in memo:
            memo[c], _ = fit_eval(c)
            print(f"C={c:g}: val acc {memo[c]*100:.2f}%")
        return memo[c]

    for _ in range(8):
        acc_lo, acc_hi = eval_c(lo), eval_c(hi)
        mid = 10 ** ((np.log10(lo) + np.log10(hi)) / 2)
        if acc_lo < acc_hi:
            if acc_hi > best_acc:
                best_acc, best_c = acc_hi, hi
            lo = mid
        else:
            if acc_lo > best_acc:
                best_acc, best_c = acc_lo, lo
            hi = mid
        if hi / lo < 1.1:
            break
    return best_c


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", required=True)
    p.add_argument("--dataset-config-file", required=True)
    p.add_argument("--backbone", default="RN50")
    p.add_argument("--num-shots", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--output-dir", default="./lpclip_out")
    p.add_argument("--device", default="cuda",
                   help="where the towers and the fits run (cuda, or cpu)")
    return p


def build_cfg(args):
    """The config of the JAX tool's main (:106-119) for parsed ``args``:
    defaults.py, the dataset file, the shots, the seed, the backbone, its
    input size, and CLIP's normalization as the only transform."""
    from ..config import get_cfg_base
    from ..models.clip import ARCHS

    cfg = get_cfg_base()
    cfg.merge_from_file(args.dataset_config_file)
    cfg.DATASET.ROOT = args.root
    cfg.DATASET.NUM_SHOTS = args.num_shots
    cfg.SEED = args.seed
    cfg.MODEL.BACKBONE.NAME = args.backbone
    res = ARCHS[args.backbone].image_resolution
    cfg.INPUT.SIZE = (res, res)
    cfg.INPUT.TRANSFORMS = ("normalize",)
    cfg.INPUT.PIXEL_MEAN = list(CLIP_PIXEL_MEAN)
    cfg.INPUT.PIXEL_STD = list(CLIP_PIXEL_STD)
    return cfg


def main(argv=None, clip=None):
    """The JAX tool's main (:96-146) on ``--device``.  ``clip``: an fp32
    CLIP on that device to use instead of building the backbone (random
    weights from --seed unless MODEL.BACKBONE.PRETRAINED finds weights).
    Returns {"splits": {name: (features, labels)}, "best_c", "accuracy",
    "extract_s": {name: seconds}, "search_s", "fits": search_logreg's}."""
    from ..data import DataManager
    from ..trainers.backbone import load_clip_backbone

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = build_cfg(args)
    os.makedirs(args.output_dir, exist_ok=True)
    dm = DataManager(cfg)
    if clip is None:
        clip = load_clip_backbone(args.backbone, cfg.MODEL.BACKBONE.PRETRAINED, "fp32",
                                  cfg.SEED, device)
    elif clip.logit_scale.device != device or clip.logit_scale.dtype != torch.float32:
        raise ValueError(f"clip must be fp32 on {device}, got {clip.logit_scale.dtype} on "
                         f"{clip.logit_scale.device}")

    splits, extract_s = {}, {}
    for name, loader in [
        ("train", dm.train_loader_x),
        ("val", dm.val_loader),
        ("test", dm.test_loader),
    ]:
        t0 = time.perf_counter()
        f, y = extract_split(loader, clip)
        extract_s[name] = time.perf_counter() - t0
        np.savez(os.path.join(args.output_dir, f"{name}.npz"), feature_list=f, label_list=y)
        print(f"{name}: features {f.shape}")
        splits[name] = (f, y)

    fits = []
    t0 = time.perf_counter()
    best_c = search_logreg(*splits["train"], *splits["val"], device=device, fits=fits)
    search_s = time.perf_counter() - t0
    print(f"Best C: {best_c:g}")

    clf = LogisticRegression(C=best_c, max_iter=1000, device=device)
    train_f = np.concatenate([splits["train"][0], splits["val"][0]])
    train_y = np.concatenate([splits["train"][1], splits["val"][1]])
    clf.fit(train_f, train_y)
    acc = clf.score(*splits["test"]) * 100.0
    print(f"=> result\n* accuracy: {acc:.1f}%")
    return {"splits": splits, "best_c": best_c, "accuracy": acc, "extract_s": extract_s,
            "search_s": search_s, "fits": fits}


if __name__ == "__main__":
    main()
