"""LR schedules and the SGD optimizer (counterpart of fsvlm_tpu.engine.optim).

The reference steps its torch schedulers once per epoch; the JAX package
makes the schedule a pure function of the optimizer's step count with
steps_per_epoch baked in, so that per-step updates realize the same
per-epoch staircase (optim.py:57-112):

- warmup (epoch < WARMUP_EPOCH): constant WARMUP_CONS_LR, or linear
  LR * epoch / WARMUP_EPOCH (WARMUP_MIN_LR at epoch 0);
- after warmup the successor counts from the end of warmup
  (WARMUP_RECOUNT, dassl/optim/lr_scheduler.py:27-33):
    cosine:      LR * (1 + cos(pi * (e - w) / MAX_EPOCH)) / 2
    single_step: LR * GAMMA ** ((e - w) // STEPSIZE[-1])
    multi_step:  LR * GAMMA ** #(milestones <= e - w)
    constant:    LR

lr(step) = table[min(step // steps_per_epoch, MAX_EPOCH)], a gather from a
table on the device: no host sync.

``build_optimizer`` ports the ``sgd`` chain of optim.py:115-172:
optax.add_decayed_weights (coupled decay) -> trace (momentum, optional
Nesterov; the trace starts at zero) -> scale_by_learning_rate(schedule),
wrapped in optax.apply_if_finite(..., max_consecutive_errors=8): a step whose
gradients are not all finite leaves the parameters, the momentum and the
schedule's count unchanged, unless it is the 9th or later such step in a
row, which is applied anyway.  The finite test and the selects run on the
device (torch.where), so a step needs no host sync.
"""

import math

import numpy as np
import torch

from .. import resolve_device

AVAI_OPTIMS = ["sgd"]
AVAI_SCHEDS = ["single_step", "multi_step", "cosine", "constant"]
MAX_CONSECUTIVE_ERRORS = 8


class LRSchedule:
    """lr(step) on the device, and ``lr_at_epoch`` for the host."""

    def __init__(self, lr_at_epoch, max_epoch, steps_per_epoch, device):
        self.lr_at_epoch = lr_at_epoch
        self.max_epoch = max_epoch
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.table = torch.tensor([lr_at_epoch(e) for e in range(max_epoch + 1)],
                                  dtype=torch.float32, device=device)

    def __call__(self, count):
        """lr at step ``count`` (an int, or an integer tensor on the table's
        device): a 0-dim float32 tensor."""
        count = torch.as_tensor(count, device=self.table.device)
        # take, not [], which reads a 0-dim index back to the host
        return torch.take(self.table, torch.clamp(count // self.steps_per_epoch, max=self.max_epoch))


def make_lr_schedule(cfg, steps_per_epoch, device=None):
    """dassl's per-epoch schedule as lr(step), with its table on ``device``
    (default cuda)."""
    o = cfg.OPTIM
    base_lr, max_epoch, sched = o.LR, o.MAX_EPOCH, o.LR_SCHEDULER
    warmup_epoch, warmup_type = o.WARMUP_EPOCH, o.WARMUP_TYPE
    if sched not in AVAI_SCHEDS:
        raise ValueError(f"Unknown LR_SCHEDULER: {sched} (choices {AVAI_SCHEDS})")
    if warmup_epoch > 0 and not o.WARMUP_RECOUNT:
        raise NotImplementedError("WARMUP_RECOUNT=False is not supported")

    def lr_at_epoch(epoch):
        if warmup_epoch > 0 and epoch < warmup_epoch:
            if warmup_type == "constant":
                return o.WARMUP_CONS_LR
            if warmup_type == "linear":
                return o.WARMUP_MIN_LR if epoch == 0 else base_lr * epoch / warmup_epoch
            raise ValueError(f"Unknown WARMUP_TYPE: {warmup_type}")
        t = epoch - warmup_epoch if warmup_epoch > 0 else epoch
        if sched == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / max_epoch))
        if sched == "single_step":
            # the reference takes the LAST stepsize entry (lr_scheduler.py:101-102)
            ss = o.STEPSIZE[-1] if isinstance(o.STEPSIZE, (tuple, list)) else o.STEPSIZE
            return base_lr * o.GAMMA ** (t // (ss if ss > 0 else max_epoch))
        if sched == "multi_step":
            return base_lr * o.GAMMA ** sum(1 for m in o.STEPSIZE if t >= m)
        return base_lr

    return LRSchedule(lr_at_epoch, max_epoch, steps_per_epoch, resolve_device(device))


class SGD:
    """optax's sgd chain under apply_if_finite, on a list of fp32 tensors
    updated in place.  State: ``count`` (the schedule's step count),
    ``trace`` (momentum buffers), ``notfinite_count`` (consecutive
    non-finite steps); all on the parameters' device."""

    def __init__(self, params, schedule, weight_decay, momentum, nesterov):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay, self.momentum, self.nesterov = weight_decay, momentum, nesterov
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int64, device=dev)
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        self.notfinite_count = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                           self.notfinite_count + 1)
        apply = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)
        neg_lr = -self.schedule(self.count)
        for p, g, t in zip(self.params, grads, self.trace):
            u = g + self.weight_decay * p if self.weight_decay else g
            if self.momentum:
                new_t = u + self.momentum * t
                u = u + self.momentum * new_t if self.nesterov else new_t
                t.copy_(torch.where(apply, new_t, t))
            p.copy_(torch.where(apply, p + neg_lr * u, p))
        self.count = torch.where(apply, self.count + 1, self.count)

    def state_dict(self, names):
        """The state as numpy: the step counts, and the momentum buffers keyed
        by ``names`` (the parameters' names, in order)."""
        def copy(t):
            return t.detach().cpu().numpy().copy()

        return {"count": copy(self.count), "notfinite_count": copy(self.notfinite_count),
                "trace": {n: copy(t) for n, t in zip(names, self.trace)}}

    @torch.no_grad()
    def load_state_dict(self, state, names):
        """Restore what ``state_dict`` saved, exactly."""
        dev = self.count.device
        self.count = torch.as_tensor(state["count"], dtype=torch.int64).to(dev)
        self.notfinite_count = torch.as_tensor(state["notfinite_count"], dtype=torch.int64).to(dev)
        for n, t in zip(names, self.trace):
            t.copy_(torch.from_numpy(np.array(state["trace"][n], dtype=np.float32)))


def build_optimizer(cfg, params, steps_per_epoch):
    """The optimizer of OPTIM.NAME over ``params`` (a list of fp32 tensors)
    and its schedule, both on the parameters' device."""
    o = cfg.OPTIM
    if o.NAME not in AVAI_OPTIMS:
        raise NotImplementedError(f"OPTIM.NAME {o.NAME!r} is not ported (ported: {AVAI_OPTIMS})")
    params = list(params)
    schedule = make_lr_schedule(cfg, steps_per_epoch, params[0].device)
    return SGD(params, schedule, o.WEIGHT_DECAY, o.MOMENTUM, o.SGD_NESTEROV), schedule
