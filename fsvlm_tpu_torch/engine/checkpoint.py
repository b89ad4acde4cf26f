"""Checkpoints in the JAX package's format (counterpart of
fsvlm_tpu.engine.checkpoint, :1-75).

Per model name, a pickle of {"state_dict", "epoch", "optimizer",
"val_result", "extra"} at ``<dir>/<name>/model.pkl-<epoch>``, with a
``checkpoint`` pointer file naming the latest; a best-val save goes to
``model-best.pkl`` and leaves the pointer alone.  Everything in the file is
numpy or builtins: ``state_dict`` is the prompt tensors in the JAX
package's tree layout (a flat name "meta_net.w1" nests as
{"meta_net": {"w1": ...}}), so that either package loads the other's
prompts.  A JAX-written checkpoint's optimizer state holds optax classes;
they are read as inert stand-ins, so that loading needs neither JAX nor
optax.
"""

import os
import pickle

import numpy as np
import torch

from ..utils import mkdir_if_missing

_PICKLE_MODULES = ("builtins", "collections", "copyreg", "_codecs")


class _Opaque:
    """Stand-in for a class the port does not import (optimizer states)."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" or module in _PICKLE_MODULES:
            return super().find_class(module, name)
        return type(name, (_Opaque,), {"__module__": module})


def nest(flat):
    """{"a.b": x} -> {"a": {"b": x}}, values as numpy arrays."""
    out = {}
    for name, value in flat.items():
        *parents, leaf = name.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = (value.detach().cpu().numpy() if torch.is_tensor(value)
                      else np.asarray(value)).copy()
    return out


def flatten(tree, prefix=""):
    """The inverse of ``nest``; a tuple or list node's items are named by
    their index ({"q": (A, B)} -> "q.0", "q.1")."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, tuple, list)):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def save_checkpoint(state, save_dir, model_name=""):
    """Pickle ``state`` (numpy and builtins only) to ``model_name``, by
    default ``model.pkl-<epoch>``, which alone moves the pointer."""
    mkdir_if_missing(save_dir)
    update_pointer = not model_name
    model_name = model_name or f"model.pkl-{state['epoch']}"
    fpath = os.path.join(save_dir, model_name)
    with open(fpath, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"Checkpoint saved to {fpath}")
    if update_pointer:
        with open(os.path.join(save_dir, "checkpoint"), "w") as f:
            f.write(os.path.basename(fpath))
    return fpath


def load_checkpoint(fpath):
    if fpath is None or not os.path.exists(fpath):
        raise FileNotFoundError(f'File is not found at "{fpath}"')
    with open(fpath, "rb") as f:
        return _CheckpointUnpickler(f).load()


def resume_from_checkpoint(fdir):
    """The checkpoint that ``<fdir>/checkpoint`` names, or None."""
    pointer = os.path.join(fdir, "checkpoint")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        fpath = os.path.join(fdir, f.read().strip())
    if not os.path.exists(fpath):
        return None
    print(f'Loading checkpoint from "{fpath}"')
    return load_checkpoint(fpath)


def coerce_prompt_params(live, loaded):
    """Take each live prompt tensor's value from ``loaded`` (a tree in the
    JAX layout, or flat) where the name is there and the shape fits; keep
    the live value otherwise (parity: SimpleTrainer._coerce_params)."""
    loaded = flatten(loaded)
    out = {}
    for name, value in live.items():
        if name not in loaded:
            print(f"Warning: /{name} missing from checkpoint; keeping init")
            out[name] = value
            continue
        arr = np.asarray(loaded[name], np.float32)
        if arr.shape != tuple(value.shape):
            print(f"Warning: shape mismatch at /{name} ({arr.shape} vs "
                  f"{tuple(value.shape)}); keeping init")
            out[name] = value
            continue
        out[name] = torch.from_numpy(arr.copy()).to(value.device)
    return out
