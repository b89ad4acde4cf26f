"""Convert a reference-trained PyTorch prompt checkpoint to the port's
checkpoint format, or back (counterpart of the repository's
tools/import_torch_prompts.py).

Reads a dassl ``model.pth.tar-<E>`` / ``model-best.pth.tar`` produced by the
reference (the published PromptSRC / MaPLe model-zoo files among them) and
writes a checkpoint that ``python -m fsvlm_tpu_torch.train --eval-only
--model-dir <out> [--load-epoch E]`` loads unchanged; ``--export`` writes a
reference-keyed torch file from a ``model.pkl-<E>``; ``--trainer LoRA``
converts a reference LoRA ``best.pt`` into
``<out>/<dataset>/<backbone>/lora/best.pkl``.  The reference files are read
with ``torch.load(..., weights_only=False)`` (see
``trainers/import_torch.py``): import only trusted files.

    python -m fsvlm_tpu_torch.tools.import_torch_prompts path/to/model.pth.tar-20 \\
        --trainer PromptSRC --output-dir output/imported [--best]
    python -m fsvlm_tpu_torch.tools.import_torch_prompts output/run1/VLPromptLearner/model.pkl-20 \\
        --trainer PromptSRC --export model.pth.tar-20
"""

import argparse
import os
import pickle

from ..engine.checkpoint import save_checkpoint
from ..trainers.import_torch import (
    MODEL_NAMES,
    export_torch_checkpoint,
    import_lora_checkpoint,
    import_torch_checkpoint,
)


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="reference model.pth.tar-<E> / LoRA best.pt file"
                   " (with --export: a model.pkl-<E> file of this format)")
    p.add_argument("--export", metavar="OUT.pth.tar",
                   help="reverse direction: convert a model.pkl-* checkpoint to a "
                        "reference-keyed torch file its load_model accepts")
    p.add_argument("--trainer", required=True, choices=sorted(MODEL_NAMES) + ["LoRA"])
    p.add_argument("--output-dir", help="import destination (required unless --export)")
    p.add_argument("--best", action="store_true",
                   help="also write model-best.pkl (what --eval-only loads by default)")
    p.add_argument("--backbone", default="ViT-B/16",
                   help="LoRA only: arch whose layer table sizes the stacks")
    p.add_argument("--dataset", default=None,
                   help="LoRA only: DATASET.NAME for the output layout "
                        "<out>/<dataset>/<backbone>/lora/best.pkl")
    return p


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)

    if args.export:
        if args.trainer == "LoRA":
            p.error("--export supports the prompt families, not LoRA")
        sd = export_torch_checkpoint(args.checkpoint, args.trainer, args.export)
        print(f"Exported {len(sd)} reference-keyed tensors -> {args.export}")
        return

    if not args.output_dir:
        p.error("--output-dir is required (unless --export is given)")

    if args.trainer == "LoRA":
        if not args.dataset:
            p.error("--dataset is required for --trainer LoRA")
        payload = import_lora_checkpoint(args.checkpoint, args.backbone)
        save_dir = os.path.join(args.output_dir, args.dataset, args.backbone.replace("/", "-"),
                                "lora")
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, "best.pkl")
        with open(out, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        print(f"Imported LoRA factors ({payload['metadata']}) -> {out}")
        return

    params, epoch, val_result = import_torch_checkpoint(args.checkpoint, args.trainer)
    leaves = {k: getattr(v, "shape", ()) for k, v in params.items()}
    print(f"Imported {args.trainer} prompt leaves: {leaves} (epoch {epoch})")
    save_dir = os.path.join(args.output_dir, MODEL_NAMES[args.trainer])
    # the epoch is the completed count, as the reference's torchtools saves it
    state = {"state_dict": params, "epoch": epoch, "optimizer": None, "val_result": val_result}
    save_checkpoint(state, save_dir)
    if args.best:
        save_checkpoint(state, save_dir, model_name="model-best.pkl")
    print(f"Load with: --model-dir {args.output_dir} --load-epoch {epoch} --eval-only")


if __name__ == "__main__":
    main()
