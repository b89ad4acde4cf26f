"""LR schedules and the optimizers (counterpart of fsvlm_tpu.engine.optim).

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

``build_optimizer`` ports the optax chains of optim.py:115-172 for every
OPTIM.NAME (AVAI_OPTIMS), on a list of fp32 tensors updated in place:

- coupled decay first (optax.add_decayed_weights: g + WEIGHT_DECAY * p
  before the statistics) for every optimizer but adamw;
- sgd: trace (momentum, optional Nesterov; the trace starts at zero);
- adam: scale_by_adam (eps 1e-8 outside the root), bias-corrected with
  the update's own step count t = 1, 2, ...;
- amsgrad: the JAX package's ``_scale_by_amsgrad_torch`` (:29-53): the
  running max of the RAW second moment, bias-corrected after;
- adamw: scale_by_adam, then + WEIGHT_DECAY * p (decoupled);
- rmsprop: scale_by_rms(decay=RMSPROP_ALPHA, initial_scale=0), in optax
  0.2.6 g * rsqrt(nu + 1e-8) (torch's RMSprop divides by sqrt(nu) + eps),
  then a momentum trace when MOMENTUM is nonzero;
- radam: scale_by_radam (eps 1e-8), rectified where rho_t >= 5 (torch's
  RAdam tests rho_t > 5), else the bias-corrected first moment;

then scale_by_learning_rate(schedule), the whole chain wrapped in
optax.apply_if_finite(..., max_consecutive_errors=8): a step whose
gradients are not all finite leaves the parameters, every moment buffer and
the step count unchanged, unless it is the 9th or later such step in a row,
which is applied anyway.  The finite test and the selects run on the device
(torch.where), with the step count a device tensor, so a step needs no host
sync.  The schedule's count and the moments' count are one: both advance on
every applied step.

Staged LR (optim.py:163-168): ``param_labels`` ("base" or "new", one per
tensor) with ``lr_mult`` scale the "base" tensors' learning rate by
lr_mult and the "new" ones' by 1.0, as optax.multi_transform of two chains
does (both chains advance together, so one count serves them);
``schedule_override`` replaces the staircase by another lr(step) on the
device (the zoo's groups stepped k times per iteration).
"""

import math

import numpy as np
import torch

from .. import resolve_device
from ..parallel import mesh

AVAI_OPTIMS = ["adam", "amsgrad", "sgd", "rmsprop", "radam", "adamw"]
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


class Optimizer:
    """One optax chain under apply_if_finite, on a list of fp32 tensors
    updated in place.  State: ``count`` (the applied steps: the schedule's
    step, and t - 1 of the bias corrections), ``notfinite_count``
    (consecutive non-finite steps), and per parameter the buffers named in
    ``buffers`` (lists of tensors, attributes of those names); all on the
    parameters' device.  A subclass gives ``scalars(t)`` (per-step device
    scalars) and ``update(p, g, buf, s)`` -> (the update before the
    learning rate, {buffer: its new value})."""

    name = None

    def __init__(self, params, schedule, weight_decay, buffers):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.buffers = tuple(buffers)
        self.lr_scales = None  # per tensor: staged LR's multiplier (build_optimizer)
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int64, device=dev)
        for b in self.buffers:
            setattr(self, b, [torch.zeros_like(p) for p in self.params])

    def scalars(self, t):
        return {}

    def tensors(self):
        """Every state tensor: the counts and the buffers."""
        return [self.count, self.notfinite_count] + [t for b in self.buffers
                                                     for t in getattr(self, b)]

    def update(self, p, g, buf, s):
        raise NotImplementedError

    def decayed(self, p, g):
        """optax.add_decayed_weights: g + WEIGHT_DECAY * p (coupled decay)."""
        return g + self.weight_decay * p if self.weight_decay else g

    @torch.no_grad()
    def step(self, grads):
        mesh.all_reduce_(grads)  # the global gradient: summed over the ranks
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        self.notfinite_count = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                           self.notfinite_count + 1)
        apply = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)
        lr = self.schedule(self.count)
        neg_lr = {1.0: -lr}
        s = self.scalars((self.count + 1).to(torch.float32))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            buf = {b: getattr(self, b)[i] for b in self.buffers}
            u, new = self.update(p, g, buf, s)
            for b, v in new.items():
                buf[b].copy_(torch.where(apply, v, buf[b]))
            scale = 1.0 if self.lr_scales is None else self.lr_scales[i]
            if scale not in neg_lr:
                neg_lr[scale] = -(scale * lr)
            p.copy_(torch.where(apply, p + neg_lr[scale] * u, p))
        self.count = torch.where(apply, self.count + 1, self.count)

    def state_dict(self, names):
        """The state as numpy: the optimizer's name, the step counts, and
        each buffer keyed by ``names`` (the parameters' names, in order)."""
        def copy(t):
            return t.detach().cpu().numpy().copy()

        state = {"name": self.name, "count": copy(self.count),
                 "notfinite_count": copy(self.notfinite_count)}
        for b in self.buffers:
            state[b] = {n: copy(t) for n, t in zip(names, getattr(self, b))}
        return state

    def accepts(self, state):
        """Whether ``state`` (a ``state_dict``) is this optimizer's: its name
        (an SGD state written before states were named holds only "trace")
        and its buffers."""
        name = state.get("name", "sgd" if "trace" in state else None)
        return name == self.name and all(b in state for b in self.buffers)

    @torch.no_grad()
    def load_state_dict(self, state, names):
        """Restore what ``state_dict`` saved, exactly; another optimizer's
        state raises ValueError."""
        if not self.accepts(state):
            raise ValueError(f"the optimizer state is {state.get('name')!r}'s, not "
                             f"{self.name!r}'s (buffers {sorted(k for k in state if k not in ('name', 'count', 'notfinite_count'))})")
        dev = self.count.device
        self.count = torch.as_tensor(state["count"], dtype=torch.int64).to(dev)
        self.notfinite_count = torch.as_tensor(state["notfinite_count"], dtype=torch.int64).to(dev)
        for b in self.buffers:
            for n, t in zip(names, getattr(self, b)):
                t.copy_(torch.from_numpy(np.array(state[b][n], dtype=np.float32)))


class SGD(Optimizer):
    """sgd: coupled decay -> optax.trace (momentum, optional Nesterov)."""

    name = "sgd"

    def __init__(self, params, schedule, weight_decay, momentum, nesterov):
        super().__init__(params, schedule, weight_decay, ["trace"])
        self.momentum, self.nesterov = momentum, nesterov

    def update(self, p, g, buf, s):
        u = self.decayed(p, g)
        if not self.momentum:
            return u, {}
        t = u + self.momentum * buf["trace"]
        return (u + self.momentum * t if self.nesterov else t), {"trace": t}


def _moments(g, buf, b1, b2):
    """optax's update_moment and update_moment_per_elem_norm."""
    return (1 - b1) * g + b1 * buf["mu"], (1 - b2) * g ** 2 + b2 * buf["nu"]


class Adam(Optimizer):
    """adam, amsgrad and adamw: optax.scale_by_adam (adamw then adds the
    decay after it), or the JAX package's amsgrad."""

    EPS = 1e-8

    def __init__(self, params, schedule, weight_decay, b1, b2, name):
        self.name = name
        super().__init__(params, schedule, weight_decay,
                         ["mu", "nu", "nu_max"] if name == "amsgrad" else ["mu", "nu"])
        self.b1, self.b2 = b1, b2

    def scalars(self, t):
        return {"bc1": 1 - torch.pow(self.b1, t), "bc2": 1 - torch.pow(self.b2, t)}

    def update(self, p, g, buf, s):
        u = g if self.name == "adamw" else self.decayed(p, g)
        mu, nu = _moments(u, buf, self.b1, self.b2)
        if self.name == "amsgrad":
            nu_max = torch.maximum(buf["nu_max"], nu)
            out = (mu / s["bc1"]) / (torch.sqrt(nu_max / s["bc2"]) + self.EPS)
            return out, {"mu": mu, "nu": nu, "nu_max": nu_max}
        out = (mu / s["bc1"]) / (torch.sqrt(nu / s["bc2"]) + self.EPS)
        if self.name == "adamw":
            out = self.decayed(p, out)
        return out, {"mu": mu, "nu": nu}


class RMSprop(Optimizer):
    """rmsprop: coupled decay -> optax.scale_by_rms(decay=RMSPROP_ALPHA,
    initial_scale=0) -> optax.trace(MOMENTUM) when MOMENTUM is nonzero."""

    name = "rmsprop"
    EPS = 1e-8

    def __init__(self, params, schedule, weight_decay, alpha, momentum):
        super().__init__(params, schedule, weight_decay, ["nu", "trace"] if momentum else ["nu"])
        self.alpha, self.momentum = alpha, momentum

    def update(self, p, g, buf, s):
        u = self.decayed(p, g)
        nu = (1 - self.alpha) * u ** 2 + self.alpha * buf["nu"]
        out = torch.rsqrt(nu + self.EPS) * u
        if not self.momentum:
            return out, {"nu": nu}
        t = out + self.momentum * buf["trace"]
        return t, {"nu": nu, "trace": t}


class RAdam(Optimizer):
    """radam: coupled decay -> optax.scale_by_radam (threshold 5)."""

    name = "radam"
    EPS = 1e-8
    THRESHOLD = 5.0

    def __init__(self, params, schedule, weight_decay, b1, b2):
        super().__init__(params, schedule, weight_decay, ["mu", "nu"])
        self.b1, self.b2 = b1, b2

    def scalars(self, t):
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = torch.pow(self.b2, t)
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return {"bc1": 1 - torch.pow(self.b1, t), "bc2": 1 - b2t, "r": r,
                "rectify": ro >= self.THRESHOLD}

    def update(self, p, g, buf, s):
        mu, nu = _moments(self.decayed(p, g), buf, self.b1, self.b2)
        mu_hat, nu_hat = mu / s["bc1"], nu / s["bc2"]
        out = torch.where(s["rectify"], s["r"] * mu_hat / (torch.sqrt(nu_hat) + self.EPS), mu_hat)
        return out, {"mu": mu, "nu": nu}


def build_optimizer(cfg, params, steps_per_epoch, param_labels=None, lr_mult=None,
                    schedule_override=None):
    """The optimizer of OPTIM.NAME over ``params`` (a list of fp32 tensors)
    and its schedule, both on the parameters' device; ``param_labels`` and
    ``lr_mult``: staged LR; ``schedule_override``: lr(step) instead of the
    staircase (the module docstring)."""
    o = cfg.OPTIM
    if o.NAME not in AVAI_OPTIMS:
        raise ValueError(f"Unknown OPTIM.NAME: {o.NAME} (choices {AVAI_OPTIMS})")
    params = list(params)
    schedule = (schedule_override if schedule_override is not None
                else make_lr_schedule(cfg, steps_per_epoch, params[0].device))
    wd = o.WEIGHT_DECAY
    if o.NAME == "sgd":
        opt = SGD(params, schedule, wd, o.MOMENTUM, o.SGD_NESTEROV)
    elif o.NAME == "rmsprop":
        opt = RMSprop(params, schedule, wd, o.RMSPROP_ALPHA, o.MOMENTUM)
    elif o.NAME == "radam":
        opt = RAdam(params, schedule, wd, o.ADAM_BETA1, o.ADAM_BETA2)
    else:
        opt = Adam(params, schedule, wd, o.ADAM_BETA1, o.ADAM_BETA2, o.NAME)
    if param_labels is not None and lr_mult is not None:
        if len(param_labels) != len(params) or set(param_labels) - {"base", "new"}:
            raise ValueError("param_labels: one of 'base' or 'new' per tensor")
        opt.lr_scales = [float(lr_mult) if lab == "base" else 1.0 for lab in param_labels]
    return opt, schedule
