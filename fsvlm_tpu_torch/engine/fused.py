"""The fused epoch's device state (counterpart of the JAX package's
``train_epoch_resident``, engine/trainer.py:182-210, and
``_run_epoch_fused``, :508-568).

The JAX package runs an epoch over its device-resident train set as one
``lax.scan`` over the step.  Here one step is captured as a
``torch.cuda.CUDAGraph`` and the graph is replayed once per step; the step
reads everything that changes from step to step from static device
buffers:

- the epoch's (steps, B) index, valid and label schedule, copied into
  ``index``, ``valid`` and ``label`` at the epoch's start;
- ``counter``, a device step counter, zeroed before the epoch and advanced
  by the step itself: the step takes its schedule row (``row``), and under
  mixup its lam, with ``index_select`` at the counter;
- ``metrics``, (steps, n) float64, where the step writes its metrics at the
  counter; the epoch reads it back once, at its end.

The first step of the first fused epoch (and of the first after a
recapture) runs eagerly on a side stream: it is a real training step, and
it builds the kernels and sets their attributes before the capture.  The
capture then records the second step, which the first replay runs.  The
trainer's ``torch.Generator`` is registered with the graph, so each replay
draws fresh values in the order the eager steps draw them; the optimizer
updates its state in place (``engine/optim.py``), so the replays read and
write the live tensors.  A capture that fails raises, naming the
trainer: there is no quiet per-step fallback.

The kernels' launch counters (``LAUNCHES`` of ``ops/flash_attention.py``
and ``ops/quant.py``) count the wrappers' calls: those of the warm-up step
and of the captured one, whose launches the graph records.  A replay calls
no wrapper and counts nothing there; ``STEPS`` counts the steps each way,
``tally`` holds the captured step's wrapper calls, and a profiler's trace
shows the replays' kernels, one ``cudaGraphLaunch`` each.

On the CPU (the tests) the same buffers, counter and metric rows are used
and the step runs eagerly ``steps`` times: no graph.
"""

import gc
import time

import torch

from ..ops import flash_attention, quant

LAUNCH_COUNTERS = (flash_attention.LAUNCHES, quant.LAUNCHES)
# the fused epochs' steps by how they ran: "eager" (a warm-up before a
# capture; every step on the CPU), "captured" (recorded, not run: the first
# replay runs it) and "replays" (graph launches); a step ran once for each
# eager step and each replay
STEPS = {"eager": 0, "captured": 0, "replays": 0}


def _counts():
    return [dict(c) for c in LAUNCH_COUNTERS]


class FusedEpoch:
    """Static buffers for up to ``capacity`` steps of ``batch`` rows on
    ``device``, and the captured step.  ``key`` is what the captured graph
    depends on besides the buffers (the batch size, the attention route's
    environment, the compute dtype): another key needs another
    FusedEpoch.  ``owner`` names the trainer in errors."""

    def __init__(self, device, capacity, batch, key, owner):
        self.device = device
        self.index = torch.zeros((capacity, batch), dtype=torch.long, device=device)
        self.valid = torch.zeros((capacity, batch), dtype=torch.bool, device=device)
        self.label = torch.zeros((capacity, batch), dtype=torch.long, device=device)
        self.counter = torch.zeros((), dtype=torch.long, device=device)
        self.metrics = None  # (capacity, n) float64, made by the first step
        self.names = None
        self.key, self.owner = key, owner
        self.active = False  # set while the trainer runs its steps
        self.graph = None
        self.tally = None  # the captured step's wrapper calls, per counter
        # ms of the capture: "setup" (the collector, torch's sync and cache),
        # "capture", "instantiate"
        self.timings = {}

    def fits(self, steps, key):
        return steps <= self.index.shape[0] and key == self.key

    def load(self, index, valid, label):
        """Copy an epoch's (steps, B) schedule in and zero the counter."""
        n = len(index)
        self.index[:n].copy_(index)
        self.valid[:n].copy_(valid)
        self.label[:n].copy_(label)
        self.counter.zero_()

    def row(self, t):
        """Row ``counter`` of a (capacity, ...) buffer, read on the device."""
        return t.index_select(0, self.counter.view(1))[0]

    def _step(self, step_fn):
        metrics = step_fn()
        if self.names is None:
            self.names = list(metrics)
            self.metrics = torch.zeros((self.index.shape[0], len(self.names)),
                                       dtype=torch.float64, device=self.device)
        vals = torch.stack([metrics[k].detach().to(torch.float64).reshape(()) for k in self.names])
        self.metrics.index_copy_(0, self.counter.view(1), vals[None])
        self.counter.add_(1)

    def run(self, steps, step_fn, generator):
        """``steps`` training steps from the loaded schedule, ``step_fn()``
        being one step on the row at ``counter`` that returns its metrics
        (0-dim device tensors): eagerly on the CPU; on the card the
        captured step's replays, after a warm-up step and the capture where
        there is no graph yet."""
        if self.device.type != "cuda":
            for _ in range(steps):
                self._step(step_fn)
            STEPS["eager"] += steps
            return
        start = 0
        if self.graph is None:
            self._warm_up(step_fn)
            start = 1
            if steps > 1:
                self._capture(step_fn, generator)
        for _ in range(start, steps):
            self.replay()

    def replay(self):
        self.graph.replay()
        STEPS["replays"] += 1

    def _warm_up(self, step_fn):
        """Step 0, eagerly on a side stream (torch's rule before a
        capture): a real step, its launches counted as they happen."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step(step_fn)
        torch.cuda.current_stream(dev).wait_stream(side)
        STEPS["eager"] += 1

    def _capture(self, step_fn, generator):
        """Record one step into a new graph.  Two things outside the step
        can end a capture.  The cycle collector may free another trainer's
        graph in the middle of it, and a graph's teardown is a CUDA call
        that a capture forbids: the collector runs before the capture and
        is off during it.  cuBLAS keeps a workspace per (handle, stream)
        made on first use, and one made inside an earlier capture lies in
        that graph's pool: the workspaces are dropped before and after the
        capture, as torch's own CUDA-graph trees do, so that it makes its
        own, which its pool holds for the replays."""
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        try:
            graph.register_generator_state(generator)
            t0 = time.perf_counter()
            gc.collect()
            gc.disable()
            torch._C._cuda_clearCublasWorkspaces()
            try:
                with torch.cuda.graph(graph):
                    t1 = time.perf_counter()
                    self._step(step_fn)
                    t2 = time.perf_counter()
            finally:
                torch._C._cuda_clearCublasWorkspaces()
                if collecting:
                    gc.enable()
            t3 = time.perf_counter()
        except Exception as e:
            raise RuntimeError(f"{self.owner}: capturing the fused epoch's step as a CUDA graph "
                               f"failed (TRAIN.EPOCH_FUSE off runs the epoch step by step): "
                               f"{type(e).__name__}: {e}") from e
        self.tally = [{k: a[k] - b.get(k, 0) for k in a} for a, b in zip(_counts(), before)]
        STEPS["captured"] += 1
        self.graph = graph
        self.timings = {"capture": (t2 - t1) * 1e3,
                        "instantiate": (t3 - t2) * 1e3,
                        "setup": (t1 - t0) * 1e3}

    def host_metrics(self, steps):
        """The epoch's metrics as a list of {name: float}, one read-back."""
        rows = self.metrics[:steps].cpu().tolist()
        return [dict(zip(self.names, r)) for r in rows]
