"""Small helpers (counterpart of the parts of fsvlm_tpu.utils.tools that the
train path uses)."""

import json
import os
import platform
import random

import numpy as np
import torch


def set_random_seed(seed):
    """Seed Python's, numpy's and torch's global generators (dassl
    tools.py:72-76).  The trainers draw from generators of their own,
    seeded from SEED; this covers any global draw."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def mkdir_if_missing(dirname):
    if dirname:
        os.makedirs(dirname, exist_ok=True)


def read_json(fpath):
    with open(fpath, "r") as f:
        return json.load(f)


def write_json(obj, fpath):
    mkdir_if_missing(os.path.dirname(fpath))
    with open(fpath, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))


def read_image(path):
    """The RGB image of a file as uint8 (H, W, 3), as the JAX package's
    ``Image.open(path).convert("RGB")`` gives it, through the port's JPEG,
    PNG, BMP, Netpbm, GIF, TIFF and WebP decoders (``fsvlm_tpu_torch.native``);
    raises IOError for a missing file, ValueError for corrupt data and a
    layout Pillow refuses too, and NotImplementedError (ROADMAP A16) for a
    file in another format or a variant the port does not read yet (TIFF's
    LZMA, ZSTD, WebP, Thunderscan and SGILog compressions among them)."""
    from ..native import read_image as decode

    return decode(path)


def listdir_nohidden(path, sort=False):
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items


def collect_env_info():
    """The environment summary printed at startup: Python, torch, CUDA and
    the visible cards."""
    cuda = torch.cuda.is_available()
    lines = [
        f"python: {platform.python_version()}",
        f"torch: {torch.__version__}",
        f"cuda: {torch.version.cuda if cuda else 'not available'}",
        f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}"
        if cuda else "devices: ['cpu']",
    ]
    return "\n".join(lines)
