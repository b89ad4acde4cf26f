"""Reference-trained PyTorch prompt checkpoints in and out of the port's
checkpoint format (counterpart of fsvlm_tpu.trainers.import_torch).

The reference saves dassl checkpoints (``model.pth.tar-<E>`` /
``model-best.pth.tar``: torch pickles of ``{"state_dict", "epoch",
"optimizer", "scheduler", "val_result"}``, dassl torchtools.py:27-74) whose
state-dict layout differs per trainer family:

- CoOp / CoCoOp register ONLY the prompt-learner module
  (trainers/coop.py:431, cocoop.py:304), so keys are learner-relative:
  ``ctx``, ``meta_net.linear1.weight`` ... plus the ``token_prefix`` /
  ``token_suffix`` buffers the reference itself deletes on load
  (coop.py:488-510).
- MaPLe / IVLP / PromptSRC register the WHOLE CustomCLIP
  (maple.py:301, independentVL.py:401, promptsrc.py:262): prompt leaves sit
  under ``prompt_learner.*`` and, for the deep-VPT families, inside the
  encoders (``image_encoder.VPT``, ``{image_encoder,text_encoder}
  .transformer.resblocks.{i}.VPT_shallow`` for 1 <= i < depth,
  clip/model.py:211-221,345-352,386); every frozen-tower tensor in the file
  is ignored.

``torch_prompt_params`` maps such a state dict to the JAX tree layout that
the port's checkpoints hold (``engine/checkpoint.py``), so that
``python -m fsvlm_tpu_torch.tools.import_torch_prompts`` writes a file that
``--eval-only`` loads unchanged; ``export_torch_checkpoint`` goes back.
The files are read with ``torch.load(..., weights_only=False)``, as the JAX
importer reads them: a dassl pickle holds an optimizer and scheduler state
(and may hold other objects) that the weights-only loader refuses, so only
checkpoints from a trusted source should be imported.
"""

import re

import numpy as np
import torch

from ..engine.checkpoint import load_checkpoint

# the trainers' model_name (checkpoint subdirectory) per family — identical to
# the reference's registered names, so directory trees line up too
MODEL_NAMES = {
    "CoOp": "prompt_learner",
    "CoCoOp": "prompt_learner",
    "MaPLe": "MultiModalPromptLearner",
    "IVLP": "VLPromptLearner",
    "PromptSRC": "VLPromptLearner",
}


def _np(t):
    if isinstance(t, np.ndarray):
        arr = t
    else:
        arr = t.detach().cpu().numpy()
    # reference checkpoints may carry fp16 leaves (CUDA-era .half() casts)
    return arr.astype(np.float32)


def _strip_module(sd):
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def _stack_vpt(sd, prefix):
    """Collect resblocks.{i}.VPT_shallow for i>=1 into a (depth-1, n, D)
    stack ordered by layer index; None when the family has no deep prompts."""
    found = {}
    pat = re.compile(re.escape(prefix) + r"\.transformer\.resblocks\.(\d+)\.VPT_shallow$")
    for k, v in sd.items():
        m = pat.match(k)
        if m:
            found[int(m.group(1))] = _np(v)
    if not found:
        return None
    idxs = sorted(found)
    if idxs != list(range(1, len(idxs) + 1)):
        raise ValueError(f"non-contiguous VPT layers under {prefix}: {idxs}")
    return np.stack([found[i] for i in idxs])


def torch_prompt_params(sd, trainer):
    """Map a reference state dict to the fsvlm trainable pytree for
    ``trainer``.  Unknown trainer names raise; missing prompt leaves raise
    (a silent partial import would eval garbage)."""
    sd = _strip_module(sd)
    if trainer in ("CoOp", "CoCoOp"):
        # learner-relative keys; tolerate full-model dumps too
        pl = {
            re.sub(r"^prompt_learner\.", "", k): v
            for k, v in sd.items()
            if "prompt_learner." in k or "." not in k or k.startswith("meta_net")
        }
        if "ctx" not in pl:
            raise ValueError("no 'ctx' leaf in checkpoint — not a CoOp-family file")
        params = {"ctx": _np(pl["ctx"])}
        if trainer == "CoCoOp":
            params["meta_net"] = {
                "w1": _np(pl["meta_net.linear1.weight"]).T,
                "b1": _np(pl["meta_net.linear1.bias"]),
                "w2": _np(pl["meta_net.linear2.weight"]).T,
                "b2": _np(pl["meta_net.linear2.bias"]),
            }
        return params

    if trainer == "MaPLe":
        params = {
            "ctx": _np(sd["prompt_learner.ctx"]),
            "proj": {
                "w": _np(sd["prompt_learner.proj.weight"]).T,
                "b": _np(sd["prompt_learner.proj.bias"]),
            },
        }
        compound = {}
        pat = re.compile(r"^prompt_learner\.compound_prompts_text\.(\d+)$")
        for k, v in sd.items():
            m = pat.match(k)
            if m:
                compound[int(m.group(1))] = _np(v)
        if compound:
            idxs = sorted(compound)
            params["compound_text"] = np.stack([compound[i] for i in idxs])
            ws, bs = [], []
            for i in idxs:
                p = f"prompt_learner.compound_prompt_projections.{i}"
                ws.append(_np(sd[p + ".weight"]).T)
                bs.append(_np(sd[p + ".bias"]))
            params["compound_proj"] = {"w": np.stack(ws), "b": np.stack(bs)}
        return params

    if trainer in ("IVLP", "PromptSRC"):
        if "prompt_learner.ctx" not in sd:
            raise ValueError(
                "no 'prompt_learner.ctx' leaf — not a full-model IVLP/PromptSRC file"
            )
        params = {"ctx": _np(sd["prompt_learner.ctx"])}
        if "image_encoder.VPT" in sd:
            params["vpt_shallow"] = _np(sd["image_encoder.VPT"])
        vision_deep = _stack_vpt(sd, "image_encoder")
        if vision_deep is not None:
            params["vision_deep"] = vision_deep
        text_deep = _stack_vpt(sd, "text_encoder")
        if text_deep is not None:
            params["text_deep"] = text_deep
        return params

    raise ValueError(
        f"unsupported trainer {trainer!r}; importable: {sorted(MODEL_NAMES)}"
    )


def import_lora_checkpoint(path, backbone="ViT-B/16"):
    """Convert a reference LoRA checkpoint (``best.pt``: ``{"weights":
    {"layer_{i}": {"q_proj": {"w_lora_A", "w_lora_B"}, ...}}, "metadata"}``,
    lora.py:467-491) into the fsvlm LoRA payload.

    The reference enumerates layers text-tower-first in ascending block
    order over INDEX_POSITIONS_TEXT[position], then the vision tower over
    INDEX_POSITIONS_VISION (lora.py:63-101); factors are loralib-shaped
    (A: (r, in), B: (out, r), layers.py:100-107) while ours are stacked
    x-side factors (a = A.T, b = B.T) gated by a per-layer mask.
    """
    from ..models.clip import ARCHS
    from .lora import INDEX_POSITIONS_TEXT, INDEX_POSITIONS_VISION

    loaded = torch.load(path, map_location="cpu", weights_only=False)
    meta = loaded["metadata"]
    weights = loaded["weights"]
    arch = ARCHS[backbone]
    r = int(meta["r"])
    encoder, position = meta["encoder"], meta["position"]
    name_map = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "proj"}

    towers = []  # (ours_key, layer_indices, n_layers, width)
    if encoder in ("text", "both"):
        # the reference intersects the position table with the blocks that
        # exist (lora.py:68 `if i in indices` over enumerate(resblocks))
        idxs = [i for i in INDEX_POSITIONS_TEXT[position]
                if i < arch.transformer_layers]
        towers.append(("text", idxs, arch.transformer_layers, arch.transformer_width))
    if encoder in ("vision", "both"):
        idxs = INDEX_POSITIONS_VISION.get(position) or list(range(arch.vision_layers))
        idxs = [i for i in idxs if i < arch.vision_layers]
        towers.append(("vision", idxs, arch.vision_layers, arch.vision_width))

    params = {}
    flat = 0  # reference's global layer_{i} counter across towers
    for which, idxs, n_layers, width in towers:
        factors = {}
        for p in meta["params"]:
            a = np.zeros((n_layers, width, r), np.float32)
            b = np.zeros((n_layers, r, width), np.float32)
            factors[p] = [a, b]
        for li in idxs:
            layer_w = weights[f"layer_{flat}"]
            for p in meta["params"]:
                ref = layer_w[name_map[p]]
                factors[p][0][li] = _np(ref["w_lora_A"]).T
                factors[p][1][li] = _np(ref["w_lora_B"]).T
            flat += 1
        params[which] = {p: tuple(ab) for p, ab in factors.items()}

    payload = {
        "weights": params,
        "metadata": {
            "r": r,
            "alpha": float(meta["alpha"]),
            "encoder": encoder,
            "params": list(meta["params"]),
            "position": position,
        },
        "epoch": int(loaded.get("epoch", 0)),
        "val_result": loaded.get("val_result"),
    }
    return payload


def import_torch_checkpoint(path, trainer):
    """Load a reference ``model.pth.tar-*`` and return
    ``(params, epoch, val_result)``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" not in ckpt:
        raise ValueError(f"{path} is not a dassl checkpoint (no state_dict)")
    params = torch_prompt_params(ckpt["state_dict"], trainer)
    return params, int(ckpt.get("epoch", 0)), ckpt.get("val_result")


def torch_state_dict_from_params(params, trainer):
    """Inverse of :func:`torch_prompt_params`: fsvlm trainable pytree ->
    reference-keyed torch state dict (the exact keys the reference's own
    ``load_model`` strict=False loads, coop.py:488-510 / maple.py:342-367 /
    promptsrc.py:389-419): lets a prompt trained here be evaluated in the
    reference stack."""
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    if trainer == "CoOp":
        return {"ctx": t(params["ctx"])}
    if trainer == "CoCoOp":
        mn = params["meta_net"]
        return {
            "ctx": t(params["ctx"]),
            "meta_net.linear1.weight": t(np.asarray(mn["w1"]).T),
            "meta_net.linear1.bias": t(mn["b1"]),
            "meta_net.linear2.weight": t(np.asarray(mn["w2"]).T),
            "meta_net.linear2.bias": t(mn["b2"]),
        }
    if trainer == "MaPLe":
        sd = {
            "prompt_learner.ctx": t(params["ctx"]),
            "prompt_learner.proj.weight": t(np.asarray(params["proj"]["w"]).T),
            "prompt_learner.proj.bias": t(params["proj"]["b"]),
        }
        for i, (c, w, b) in enumerate(
            zip(
                params.get("compound_text", ()),
                params.get("compound_proj", {}).get("w", ()),
                params.get("compound_proj", {}).get("b", ()),
            )
        ):
            sd[f"prompt_learner.compound_prompts_text.{i}"] = t(c)
            sd[f"prompt_learner.compound_prompt_projections.{i}.weight"] = t(
                np.asarray(w).T
            )
            sd[f"prompt_learner.compound_prompt_projections.{i}.bias"] = t(b)
        return sd
    if trainer in ("IVLP", "PromptSRC"):
        sd = {"prompt_learner.ctx": t(params["ctx"])}
        if "vpt_shallow" in params:
            sd["image_encoder.VPT"] = t(params["vpt_shallow"])
        for enc, key in (("image_encoder", "vision_deep"),
                         ("text_encoder", "text_deep")):
            for j, v in enumerate(params.get(key, ())):
                sd[f"{enc}.transformer.resblocks.{j + 1}.VPT_shallow"] = t(v)
        return sd
    raise ValueError(
        f"unsupported trainer {trainer!r}; exportable: {sorted(MODEL_NAMES)}"
    )


def export_torch_checkpoint(ckpt_path, trainer, out_path):
    """A checkpoint of this format (model.pkl-*, either package's) -> a
    reference model.pth.tar-* file."""
    ckpt = load_checkpoint(ckpt_path)
    sd = torch_state_dict_from_params(ckpt["state_dict"], trainer)
    torch.save(
        {
            "state_dict": sd,
            "epoch": int(ckpt.get("epoch", 0)),
            "val_result": ckpt.get("val_result"),
        },
        out_path,
    )
    return sd
