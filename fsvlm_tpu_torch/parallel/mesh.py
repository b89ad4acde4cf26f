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
  (``gather_rows``) and rank 0 alone writes;
- a random value drawn for each row (a dropout mask, a style-mixing
  weight or partner, a crop) is drawn for the global batch, at its shape,
  and this rank keeps its rows (``draw_rows``): every rank draws the same
  values from the same generator state, in one process's order, and a
  test replays the JAX package's global draws unchanged;
- a forward whose rows are not one contiguous shard of one global batch
  says how its rows sit in the global batch (``rows``): FixMatch's weak
  pass over [x; u] is two segments ([x_all; u_all] in the JAX package),
  and the per-domain blocks of DAELDG, M3SDA and DAEL (``shard_blocks``:
  each rank keeps its share of *every* block of ``split`` rows, so that
  each rank runs the feature net once per block with every rank taking
  part in each block's collectives in the same order) are one segment of
  ``split`` global rows each.  Where R does not divide ``split`` the block
  is padded with its last row; the pad rows count nowhere: BatchNorm
  weighs them 0 (``row_weight``), the block's losses and moments take the
  block's mask.  The JAX step needs no such padding (its blocks are slices
  of the global array, its mesh padding past them); padding each block,
  rather than giving ranks unequal shares, keeps every gather at one shape.

``active()`` is whether a process group is up; the numerics change only
where ``distributed()`` (more than one rank): on one rank the local
moments and counts are the global ones, so the one-rank step, with or
without a process group, is the step without one.
"""

import contextlib
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


# ----------------------------------------------------------------- row layouts


class Rows:
    """Where this rank's rows of a forward's batch sit in the global batch:
    ``segments`` (local rows b, global rows n) in order, each the rank's
    share of one global batch of n rows, cut in blocks of b = ceil(n / R)
    rows and padded with its last row (the JAX package's [x; u] is the
    segments' global batches one after the other).  ``index`` is each
    local row's global row (a pad row's: its segment's last), ``weight``
    each local row's count (None where no segment holds a pad row),
    ``pos`` each global row's place among the gathered local rows.  They
    are built on the device asked for (no host copy) and kept."""

    def __init__(self, segments):
        world = world_size()
        self.segments = tuple((int(b), int(n)) for b, n in segments)
        for b, n in self.segments:
            if b != -(-n // world):
                raise ValueError(f"a segment of {n} global rows has {-(-n // world)} rows on each "
                                 f"of {world} ranks, not {b}")
        self.local = sum(b for b, _ in self.segments)
        self.n = sum(n for _, n in self.segments)
        self.padded = any(b * world != n for b, n in self.segments)
        self._built = {}

    def _build(self, device):
        key = str(device)
        if key not in self._built:
            r = rank()
            index, pos, valid = [], [], []
            goff = loff = 0
            for b, n in self.segments:
                t = r * b + torch.arange(b, device=device)
                index.append(goff + t.clamp_max(n - 1))
                valid.append(t < n)
                g = torch.arange(n, device=device)
                pos.append(torch.div(g, b, rounding_mode="floor") * self.local + loff + g % b)
                goff, loff = goff + n, loff + b
            self._built[key] = tuple(torch.cat(v) for v in (index, pos, valid))
        return self._built[key]

    def index(self, device):
        return self._build(device)[0]

    def pos(self, device):
        return self._build(device)[1]

    def weight(self, device):
        return self._build(device)[2] if self.padded else None


_LAYOUTS = {}  # (segments, world, rank) -> Rows


def _rows_of(segments):
    key = (tuple(segments), world_size(), rank())
    if key not in _LAYOUTS:
        _LAYOUTS[key] = Rows(segments)
    return _LAYOUTS[key]


_ROWS = []


@contextlib.contextmanager
def rows(*segments):
    """Within: the forward's local batch is ``segments`` one after the
    other, each an int b (a contiguous shard: b x R global rows) or a pair
    (b, n) (n global rows, b = ceil(n / R) on each rank, padded)."""
    world = world_size()
    _ROWS.append(_rows_of(tuple((s, s * world) if isinstance(s, int) else tuple(s)
                                for s in segments)))
    try:
        yield _ROWS[-1]
    finally:
        _ROWS.pop()


def layout(local):
    """The current ``Rows`` of a forward's ``local`` rows: the innermost
    ``rows`` context, else one contiguous shard."""
    if not _ROWS:
        return _rows_of(((local, local * world_size()),))
    if _ROWS[-1].local != local:
        raise ValueError(f"a tensor of {local} rows in a forward of {_ROWS[-1].local}")
    return _ROWS[-1]


def draw_rows(draw, local):
    """This rank's rows of a per-row draw: ``draw(n)`` draws the global
    batch's n rows (the same values on every rank, from the same state),
    of which the rows of ``layout(local)`` are kept; ``draw(local)`` on one
    rank."""
    if not distributed():
        return draw(local)
    lay = layout(local)
    full = draw(lay.n)
    return full[lay.index(full.device)]


def global_rows(x, grad=False):
    """The global batch of a per-row tensor, in the global row order of
    ``layout``: the ranks' rows gathered (``gather_rows_grad`` with
    ``grad``, else ``gather_rows``) and put in place; ``x`` on one rank."""
    if not distributed():
        return x
    lay = layout(x.shape[0])
    full = gather_rows_grad(x) if grad else gather_rows(x)
    return full[lay.pos(x.device)]


def row_weight(local, device):
    """Each of the forward's ``local`` rows' weight in BatchNorm's moments
    (0 on a block's pad rows), and the global count of rows; the weight is
    None where every row counts."""
    lay = layout(local)
    return lay.weight(device), lay.n


def block_rows(split):
    """Each rank's rows of a block of ``split`` global rows."""
    return -(-split // world_size())


def shard_blocks(batch, split, n_blocks, world=None, index=None):
    """This rank's rows of a RandomDomainSampler host batch: of each of its
    ``n_blocks`` blocks of ``split`` rows (one domain each) the rank's
    ``block_rows(split)`` rows, each block sharded as ``shard_batch`` shards
    a batch (its last row repeated, ``valid`` False on the pad); the rows
    past the blocks are dropped (no block reads them), and so is "impath".
    The batch as it is on one rank."""
    world = world_size() if world is None else world
    index = rank() if index is None else index
    if world == 1:
        return {k: v for k, v in batch.items() if k != "impath"}
    if "valid" not in batch:
        b = next(np.shape(v)[0] for k, v in batch.items() if k != "impath")
        batch = dict(batch, valid=np.ones(b, bool))
    parts = [shard_batch({k: np.asarray(v)[i * split:(i + 1) * split] for k, v in batch.items()
                          if k != "impath"}, world, index) for i in range(n_blocks)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def global_moments(f, valid=None, ddof=0):
    """The per-feature mean and variance (``ddof`` off the count) of the
    global batch's rows of ``f`` (B, D), rows weighted by ``valid``: the
    weighted sums and squared deviations summed over the ranks
    (differentiable), over the global count."""
    if valid is None:
        if not distributed():
            return f.mean(0), f.var(0, correction=ddof)
        n = torch.tensor(float(f.shape[0] * world_size()), dtype=f.dtype, device=f.device)
        mu = all_reduce_sum(f.sum(0)) / n
        return mu, all_reduce_sum(((f - mu) ** 2).sum(0)) / (n - ddof).clamp_min(1.0)
    w = valid.to(f.dtype)[:, None]
    n = all_reduce_sum(w.sum()).clamp_min(1.0)
    mu = all_reduce_sum((f * w).sum(0)) / n
    return mu, all_reduce_sum(((f - mu) ** 2 * w).sum(0)) / (n - ddof).clamp_min(1.0)


def global_pair_mean(x, valid=None):
    """The mean of a pairwise matrix over the global batch, where both rows
    are valid: ``x`` (B, N) this rank's rows against the global batch's N
    columns (``global_rows``), ``valid`` (B,) this rank's rows' mask; this
    rank's sum over the global count of valid pairs, so that the ranks'
    values sum to the global mean."""
    if valid is None:
        if not distributed():
            return x.mean()
        return x.sum() / (x.shape[0] * world_size() * x.shape[1])
    w = valid.to(x.dtype)
    cols = global_rows(w)
    ww = w[:, None] * cols[None, :]
    return (x * ww).sum() / (all_reduce_sum(w.sum()) * cols.sum()).clamp_min(1.0)
