"""Data-parallel training across ranks (counterpart of
fsvlm_tpu.parallel.mesh).

The JAX package runs one SPMD step over a 1-D ``data`` mesh: parameters
replicated, the batch padded with its last row to the mesh size (``valid``
False on the pad rows) and sharded on axis 0, gradients and BatchNorm
moments reduced over the whole padded batch by XLA's psums.  The port runs
one process per device under ``torch.distributed`` (NCCL on cuda, gloo on
the CPU), and a step on R ranks computes what the JAX step computes on an
R-device mesh:

- ``shard_batch``: every rank assembles the same global batch (the samplers
  are seeded), pads it as the JAX package's ``shard_batch`` and keeps its
  own contiguous rows;
- a loss reduced over rows divides its local sum by the *global* count
  (the valid rows of every rank, or every rank's rows),
  so that the ranks' losses sum to the global loss; the optimizer sums the
  gradients over the ranks (``all_reduce_``) before its update;
- BatchNorm's batch moments and those counts are sums over every rank's
  rows (``all_reduce_sum``, differentiable: its backward sums the gradients
  over the ranks, as SyncBatchNorm's), so that the running statistics stay
  equal on every rank;
- a term that pairs rows across the batch (NT-Xent's negatives, mixup's
  partners) reads the other ranks' rows: ``gather_rows_grad`` (whose
  backward sums the gradients over the ranks and keeps this rank's rows)
  where they carry a gradient, ``gather_rows`` where they do not;
- a term that reads the replicated parameters alone (an L1 between
  prompted and frozen text features, a penalty on the context) is computed
  whole on every rank and weighted 1/R (``replicated_term``), so that the
  summed gradients and metrics count it once;
- a step's metrics are summed over the ranks, eval logits are gathered
  (``gather_rows``) and rank 0 alone writes.

``active()`` is whether a process group is up; the numerics change only
where ``distributed()`` (more than one rank): on one rank the local
moments and counts are the global ones, so the one-rank step, with or
without a process group, is the step without one.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist


def active():
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if active() else 1


def rank():
    return dist.get_rank() if active() else 0


def distributed():
    return world_size() > 1


def is_main():
    return rank() == 0


def init_from_env(device_type="cuda"):
    """Start the process group that the environment asks for (the JAX
    package's train.py:159-190): under FSVLM_MULTIHOST=1, the rendezvous at
    FSVLM_COORDINATOR=host:port with FSVLM_NUM_PROCESSES ranks, this one
    FSVLM_PROCESS_ID, within FSVLM_INIT_TIMEOUT seconds (default 600); without
    FSVLM_COORDINATOR, torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  NCCL on cuda, each rank on its local card
    (LOCAL_RANK, else the rank modulo the cards); gloo on the CPU.  Returns
    (world size, rank); (1, 0) without FSVLM_MULTIHOST."""
    if os.environ.get("FSVLM_MULTIHOST") != "1":
        return 1, 0
    if active():
        return world_size(), rank()
    timeout = datetime.timedelta(seconds=int(os.environ.get("FSVLM_INIT_TIMEOUT", "600")))
    backend = "nccl" if device_type == "cuda" else "gloo"
    coord = os.environ.get("FSVLM_COORDINATOR")
    if coord:
        r = int(os.environ["FSVLM_PROCESS_ID"])
        kw = {"init_method": f"tcp://{coord}", "world_size": int(os.environ["FSVLM_NUM_PROCESSES"]),
              "rank": r}
    else:
        r = int(os.environ["RANK"])
        kw = {"init_method": "env://"}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", r % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, timeout=timeout, **kw)
    return world_size(), rank()


def shard_batch(batch, world=None, index=None):
    """This rank's rows of a host (numpy) batch dict: every array padded
    along axis 0 to a multiple of the world size by repeating its last row,
    ``valid`` (where present) extended with False, and rank ``index``'s
    contiguous block kept; "impath" is dropped (mesh.py:29-63)."""
    world = world_size() if world is None else world
    index = rank() if index is None else index
    b = next(np.shape(v)[0] for k, v in batch.items() if k != "impath")
    pad = (-b) % world
    rows = (b + pad) // world

    def put(key, x):
        x = np.asarray(x)
        if pad:
            fill = (np.zeros((pad,) + x.shape[1:], x.dtype) if key == "valid"
                    else np.repeat(x[-1:], pad, axis=0))
            x = np.concatenate([x, fill], axis=0)
        return x[index * rows:(index + 1) * rows] if world > 1 else x

    return {k: put(k, v) for k, v in batch.items() if k != "impath"}


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x):
    """The sum of ``x`` over the ranks, differentiable (the backward sums
    the gradients over the ranks); ``x`` itself on one rank."""
    return _AllReduceSum.apply(x) if distributed() else x


def replicated_term(x):
    """A loss term that every rank computes whole from the replicated
    parameters alone, weighted 1/R across ranks, so that the ranks' values
    (and their gradients) sum to it once; ``x`` on one rank."""
    return x / world_size() if distributed() else x


def global_mean(x, valid=None):
    """The mean of ``x`` over the global batch: of its rows weighted by
    ``valid`` (``x`` (B,), ``valid`` (B,) bool or weights; the entries of
    weight 0 are selected away, so they may be inf or NaN), else of every
    element.  Across ranks, this rank's sum over the global weight, so that
    the ranks' values sum to the global mean."""
    if valid is None:
        return x.sum() / (x.numel() * world_size()) if distributed() else x.mean()
    w = valid.to(x.dtype)
    safe = torch.where(w != 0, x * w, torch.zeros_like(x))
    return safe.sum() / all_reduce_sum(w.sum()).clamp_min(1.0)


@torch.no_grad()
def all_reduce_(tensors):
    """Sum a list of tensors over the ranks in place, in one collective per
    dtype; nothing without a process group."""
    if not active() or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        i = 0
        for t in group:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
    return tensors


def shard_rows(x):
    """This rank's rows of a tensor, padded as ``shard_batch`` pads; ``x``
    without a process group."""
    if not active():
        return x
    world, r = world_size(), rank()
    pad = (-x.shape[0]) % world
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))], 0)
    rows = x.shape[0] // world
    return x[r * rows:(r + 1) * rows]


def shard_columns(index, valid, *rest):
    """This rank's columns of an epoch schedule's (steps, B) index and valid
    tensors (and of ``rest``, such as its labels), padded along the batch
    axis as ``shard_batch`` pads rows: the last column repeated, valid
    False (trainer.py:535-551)."""
    world, r = world_size(), rank()
    pad = (-index.shape[1]) % world
    cols = (index.shape[1] + pad) // world

    def put(t, fill):
        if pad:
            t = torch.cat([t, t.new_zeros((t.shape[0], pad)) if fill else
                           t[:, -1:].expand(-1, pad)], 1)
        return t[:, r * cols:(r + 1) * cols]

    return (put(index, False), put(valid, True)) + tuple(put(t, False) for t in rest)


def _all_gather(x):
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, 0)


@torch.no_grad()
def gather_rows(x):
    """Every rank's rows of ``x`` concatenated along axis 0, in rank order
    (the global batch), without a gradient; ``x`` on one rank."""
    return _all_gather(x) if distributed() else x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_gather(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        rows = g.shape[0] // world_size()
        return g[rank() * rows:(rank() + 1) * rows]


def gather_rows_grad(x):
    """``gather_rows``, differentiable: the backward sums the global batch's
    gradient over the ranks (each rank's loss reads every rank's rows) and
    returns this rank's block of rows; ``x`` itself on one rank."""
    return _GatherRows.apply(x) if distributed() else x


@torch.no_grad()
def broadcast_(tensors):
    """Rank 0's values of ``tensors`` on every rank, in place."""
    if active():
        for t in tensors:
            dist.broadcast(t, 0)
    return tensors
