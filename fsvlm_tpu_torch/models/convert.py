"""The zoo's JAX pytrees <-> the port's modules (the zoo counterpart of
models/clip/convert.py).

The JAX zoo keeps a network as ``params`` and ``state`` pytrees of numpy
arrays (NHWC/HWIO, linear weights (in, out)); the port keeps the weights in
``nn.Module``s, named by their paths in those trees, and the BatchNorm
statistics as nested dicts of tensors.  The transposes live here alone
(ROADMAP C.3): each leaf module's ``layouts`` names the JAX layout of a
tensor stored otherwise ("hwio" conv kernels -> OIHW, "io" linear weights
-> (out, in), "kio" stacked linears, DAELDG's and DAEL's experts and M3SDA's
classifier pairs -> (K, out, in)); every other
tensor (biases, BatchNorm scale/bias/mean/var) is the same array.  A flat
feature order needs no permutation: the port flattens in NHWC order, as
the JAX package does.

- ``load_params(module, params)`` / ``params_tree(module)``: one network;
- ``load_state(state, device)`` / ``state_tree(state)``: its statistics;
- ``load_zoo(trainer, params, state)`` / ``zoo_trees(trainer)``: a zoo
  trainer's groups ({"net": ...}, or CrossGrad's {"F", "D"}, DDAIG's
  {"F", "D", "G"}, DAELDG's and DAEL's {"F", "E"}, DANN's and ADDA's
  {"net", "critic"}, MCD's {"F", "C1", "C2"}, MME's {"net", "C"}, M3SDA's
  {"F", "C": {"c1", "c2"}}, CDAC's {"F", "C"}; the SSL trainers' {"net"})
  as the JAX trainer holds them in ``params`` and ``model_state``; a
  method's frozen networks (ADDA's source model, SE's and MeanTeacher's
  teachers) go through ``params_tree`` / ``load_params`` into the
  checkpoint's ``method_extra`` (trainers/zoo/base.py).  Every backbone,
  the wide ResNets included, names its tensors as the JAX tree does, so no
  network needs a table of its own here.
"""

import numpy as np
import torch

from ..engine.checkpoint import flatten as _flatten
from ..engine.checkpoint import nest
from .backbones.common import TO_JAX, TO_PORT


def _named(module):
    """(dotted name, parameter, JAX layout or None) for every parameter."""
    for mod_name, mod in module.named_modules():
        layouts = getattr(mod, "layouts", {})
        for pname, p in mod._parameters.items():
            if p is not None:
                yield (f"{mod_name}.{pname}" if mod_name else pname), p, layouts.get(pname)


def flatten(tree):
    """{"a": {"b": x}} -> {"a.b": x} for the array leaves (the JAX dynamic
    conv's int "groups" is left out)."""
    return {k: v for k, v in _flatten(tree).items() if hasattr(v, "shape")}


@torch.no_grad()
def load_params(module, params):
    """Copy a JAX ``params`` tree into ``module``'s weights; every weight
    must be in the tree, at its shape, and every array of the tree must be
    a weight."""
    flat = {k: np.asarray(v, np.float32) for k, v in flatten(params).items()}
    named = list(_named(module))
    missing = [n for n, _, _ in named if n not in flat]
    extra = sorted(set(flat) - {n for n, _, _ in named})
    if missing or extra:
        raise KeyError(f"JAX tree and module differ: missing {missing[:5]}, extra {extra[:5]}")
    for name, p, layout in named:
        a = TO_PORT[layout](flat[name]) if layout else flat[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX {flat[name].shape} -> {a.shape}, port {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, np.float32)))


def params_tree(module, tensors=None):
    """``module``'s weights as the JAX ``params`` tree (numpy); ``tensors``:
    other tensors keyed as the weights (an optimizer's buffers) to lay out
    the same way."""
    flat = {}
    for name, p, layout in _named(module):
        t = p if tensors is None else tensors[name]
        a = t.detach().cpu().numpy()
        flat[name] = np.ascontiguousarray(TO_JAX[layout](a) if layout else a).copy()
    return nest(flat)


def load_state(state, device):
    """A JAX ``state`` tree as nested dicts of fp32 tensors on ``device``."""
    return {k: load_state(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in state.items()}


def state_tree(state):
    return {k: state_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy().copy()
            for k, v in state.items()}


def load_zoo(trainer, params, state=None):
    """Set a zoo trainer's networks (``trainer.nets``) and statistics
    (``trainer.model_state``) from the JAX trainer's ``params`` and
    ``model_state`` trees."""
    for group, tree in params.items():
        load_params(trainer.nets[group], tree)
    if state is not None:
        trainer.model_state = {g: load_state(s, trainer.device) for g, s in state.items()}


def zoo_trees(trainer):
    """(params, model_state) of a zoo trainer as the JAX trainer's trees."""
    return ({g: params_tree(m) for g, m in trainer.nets.items()},
            {g: state_tree(s) for g, s in trainer.model_state.items()})
