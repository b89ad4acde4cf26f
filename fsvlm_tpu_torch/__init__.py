"""fsvlm_tpu_torch: the PyTorch/CUDA port of fsvlm_tpu for NVIDIA Hopper.

The JAX package ``fsvlm_tpu`` stays the reference; this package keeps its
layout and names so that each module has an obvious counterpart, and imports
nothing of it (nor JAX).  Plain tensor code is PyTorch; every Pallas kernel on
a ported path is a hand-written Hopper kernel under ``ops/kernels/``.

Entry points run on the card unless the caller asks for the CPU: ``device``
defaults to ``cuda``, and asking for ``cuda`` where there is none raises
instead of quietly falling back.
"""

import torch

__version__ = "0.1.0"


def default_device():
    return torch.device("cuda")


def resolve_device(device=None):
    """``device`` or the default (cuda), with the CUDA index made explicit;
    raises if CUDA is asked for but absent."""
    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
