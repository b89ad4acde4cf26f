"""Classify image files with a trained model (counterpart of the
repository's tools/predict.py, :52-137).

The reference's only inference surface is ``train.py --eval-only`` over a
registered dataset split; this tool points a trained model at files: the
CLI's config and checkpoint loader (``fsvlm_tpu_torch.train``), the port's
JPEG reader (``fsvlm_tpu_torch.native``) and eval view (``TestTransform``:
resize, center crop, then normalize on the device), the class text
features once, then the image tower over batches padded to --pred-batch.

    python -m fsvlm_tpu_torch.tools.predict \\
        --config-file configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml \\
        --dataset-config-file configs/datasets/oxford_pets.yaml --root $DATA \\
        --model-dir output/run1 [--load-epoch N] \\
        --images photo.jpg some_dir/ [--topk 5] [--pred-batch 64] \\
        [--out preds.jsonl] [--device cuda] [opts...]

Leave --model-dir empty with ``--trainer ZeroshotCLIP`` for zero-shot
serving; ``MODEL.QUANT_INT8 True`` serves the int8 image tower.  Output: one
JSON object per line, {"path", "topk": [{"label", "prob"}, ...]}, probs
rounded to 6 places.  Directories are walked in sorted order for the
extensions of IMG_EXTS; the port reads JPEG, PNG, BMP, Netpbm, GIF, TIFF
and WebP files (a TIFF compressed with LZMA, ZSTD, WebP, Thunderscan or
SGILog raises naming ROADMAP A16).
"""

import json
import os
import sys

import numpy as np
import torch

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif", ".tiff"}


def collect_images(specs):
    """The files of ``specs`` (files, and directories walked in sorted order
    for the extensions of IMG_EXTS)."""
    paths = []
    for spec in specs:
        if os.path.isdir(spec):
            for dirpath, _, names in sorted(os.walk(spec)):
                for n in sorted(names):
                    if os.path.splitext(n)[1].lower() in IMG_EXTS:
                        paths.append(os.path.join(dirpath, n))
        elif os.path.isfile(spec):
            paths.append(spec)
        else:
            raise FileNotFoundError(f"--images entry not found: {spec}")
    if not paths:
        raise ValueError("no images found under --images")
    return paths


@torch.no_grad()
def predict(trainer, cfg, paths, topk=5, pred_batch=64):
    """Yield (path, [(classname, prob), ...]) for every image path: the
    trainer's eval towers (``frozen_eval``, int8 under MODEL.QUANT_INT8),
    the class text features once where the trainer splits its eval."""
    from ..data.transforms import TestTransform
    from ..utils import read_image

    tf = TestTransform(cfg)
    k = min(topk, len(trainer.lab2cname))
    frozen = trainer.frozen_eval()
    split_eval = getattr(trainer, "text_features_fn", None) is not None
    txf = trainer.text_features_fn(trainer.params, trainer.frozen) if split_eval else None
    B = min(pred_batch, len(paths))
    for start in range(0, len(paths), B):
        chunk = paths[start:start + B]
        imgs = np.stack([tf(read_image(p)) for p in chunk])
        if len(chunk) < B:  # pad to the serving batch shape
            pad = np.broadcast_to(imgs[-1:], (B - len(chunk),) + imgs.shape[1:])
            imgs = np.concatenate([imgs, pad], 0)
        x = trainer.eval_images(torch.from_numpy(imgs).to(trainer.device))
        if split_eval:
            logits = trainer.image_logits_fn(trainer.params, frozen, x, txf)
        else:
            logits = trainer.logits_fn(trainer.params, frozen, x)
        logits = logits.float().cpu().numpy()[:len(chunk)].astype(np.float64)
        probs = np.exp(logits - logits.max(1, keepdims=True))
        probs /= probs.sum(1, keepdims=True)
        top = np.argsort(-probs, axis=1)[:, :k]
        for p, row, pr in zip(chunk, top, probs):
            yield p, [(trainer.lab2cname[int(c)], float(pr[int(c)])) for c in row]


def main(args):
    from ..engine.trainer import build_trainer
    from ..train import setup_cfg

    cfg = setup_cfg(args)
    paths = collect_images(args.images)
    trainer = build_trainer(cfg, device=args.device)
    trainer.load_model(args.model_dir, epoch=args.load_epoch)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        for path, tk in predict(trainer, cfg, paths, topk=args.topk, pred_batch=args.pred_batch):
            out.write(json.dumps({
                "path": path,
                "topk": [{"label": label, "prob": round(p, 6)} for label, p in tk],
            }) + "\n")
    finally:
        if args.out:
            out.close()
            print(f"wrote {len(paths)} predictions to {args.out}")


def build_argparser():
    from ..train import build_argparser as train_argparser

    parser = train_argparser()
    parser.description = __doc__
    parser.add_argument("--images", type=str, nargs="+", required=True,
                        help="image files and/or directories (recursive); JPEG, PNG, BMP, "
                             "Netpbm, GIF, TIFF and WebP")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--pred-batch", type=int, default=64,
                        help="serving batch size (the last batch is padded to it)")
    parser.add_argument("--out", type=str, default="",
                        help="write JSONL here instead of stdout")
    return parser


if __name__ == "__main__":
    main(build_argparser().parse_args())
