"""Interpret learned context vectors as their nearest vocabulary tokens
(counterpart of the repository's tools/interpret_prompt.py; the reference's
PromptSRC/interpret_prompts/interpret_prompt.py:1-83).

Loads a prompt checkpoint (model.pkl-*, either package's), computes the
Euclidean distance from each context vector to every token embedding of
the backbone (its OpenAI weights where ``trainers.backbone`` finds them,
else the random table of seed 0), on the card unless ``--device cpu``, and
prints the top-k nearest words; MaPLe's and IVLP's deep text prompts
(``compound_text`` / ``text_deep``) are walked layer by layer, a
class-specific context is interpreted through its mean.

    python -m fsvlm_tpu_torch.tools.interpret_prompt <checkpoint.pkl> \\
        --backbone ViT-B/16 --topk 4 [--device cpu]
"""

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..engine.checkpoint import load_checkpoint
from ..models.clip import ARCHS, get_tokenizer
from ..models.clip.convert import load_openai_checkpoint, random_clip_params
from ..trainers.backbone import find_clip_weights


def prompt_layers(state):
    """[(name, (n, D) context)] of a checkpoint's state_dict: the input
    context, then the deep text prompts of layers 2, 3, ..."""
    ctx = np.asarray(state["ctx"])
    if ctx.ndim == 3:  # class-specific: the mean context (the reference raises here, :80)
        ctx = ctx.mean(axis=0)
    layers = [("input", ctx)]
    deep = state.get("compound_text", state.get("text_deep"))
    if deep is not None:
        deep = ([np.asarray(d) for d in deep] if isinstance(deep, (list, tuple))
                else list(np.asarray(deep)))
        layers += [(f"layer {i + 2}", d) for i, d in enumerate(deep)]
    return layers


def token_embedding(backbone):
    path = find_clip_weights(backbone)
    if path is not None:
        params, _ = load_openai_checkpoint(path)
    else:
        print("(no pretrained weights found; using random embedding table)")
        params = random_clip_params(ARCHS[backbone], seed=0)
    return np.asarray(params["text"]["token_embedding"], np.float32)


def nearest_tokens(vectors, table, topk, device=None):
    """For each row of ``vectors``: the ``topk`` nearest rows of ``table``
    by Euclidean distance, as (token ids, distances), on ``device``
    (default cuda)."""
    device = resolve_device(device)
    table = torch.as_tensor(table, dtype=torch.float32).to(device)
    out = []
    for vec in np.asarray(vectors, np.float32):
        dist = torch.linalg.vector_norm(table - torch.from_numpy(vec).to(device), dim=1)
        d, idx = torch.topk(dist, topk, largest=False, sorted=True)
        out.append((idx.cpu().numpy(), d.cpu().numpy()))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="trainer checkpoint (model.pkl-*)")
    p.add_argument("--backbone", default="ViT-B/16")
    p.add_argument("--topk", type=int, default=4)
    p.add_argument("--device", default=None, help="torch device (default cuda; cpu for tests)")
    args = p.parse_args(argv)

    layers = prompt_layers(load_checkpoint(args.checkpoint)["state_dict"])
    print(f"Size of context: {layers[0][1].shape}")
    table = token_embedding(args.backbone)
    decoder = get_tokenizer().decoder
    for name, vectors in layers:
        if len(layers) > 1:
            print(f"== {name} context ==")
        for i, (idxs, dists) in enumerate(nearest_tokens(vectors, table, args.topk, args.device)):
            pretty = ", ".join(f"{decoder.get(int(j), '?')!r} ({float(d):.3f})"
                               for j, d in zip(idxs, dists))
            print(f"ctx[{i}]: {pretty}")


if __name__ == "__main__":
    main()
