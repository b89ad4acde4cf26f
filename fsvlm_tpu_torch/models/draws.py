"""A train step's random draws, through one replaceable object.

The JAX package draws from threefry keys, which torch cannot reproduce
(ROADMAP C.3).  Every stochastic piece of the zoo (MixStyle's and EFDMix's
gate, Beta weights and partners, dropout masks, DomainMix's weight and
partners) asks a ``Draws`` for its values, in a fixed order within a step:

- ``Draws(generator)``: on the generator's device, from it alone and with
  no host sync.  Beta(a, b) is X / (X + Y) of two Gamma draws, each
  Gamma(a + 1) by Marsaglia and Tsang's method (the first accepted of 16
  candidates: all 16 are rejected with probability below 1e-20) times
  U^(1/a), in log space, so that a small a (MixStyle's 0.1) underflows to
  neither 0 nor NaN.  The categorical is Gumbel-max.
- ``Record(draws)``: the same draws, each also kept in ``values``;
- ``Replay(values)``: hands out given values in order (a test's JAX draws,
  or what a ``Record`` kept on another device), on the device asked for.
"""

import math

import numpy as np
import torch

GAMMA_CANDIDATES = 16


class Draws:
    def __init__(self, generator):
        self.generator = generator
        self.device = generator.device

    def _rand(self, shape):
        """U(0, 1] (log-safe)."""
        return 1.0 - torch.rand(shape, generator=self.generator, device=self.device)

    def uniform(self, shape=()):
        return torch.rand(shape, generator=self.generator, device=self.device)

    def _log_gamma(self, a, shape):
        d = a + 1.0 - 1.0 / 3.0
        c = 1.0 / math.sqrt(9.0 * d)
        z = torch.randn((*shape, GAMMA_CANDIDATES), generator=self.generator,
                        device=self.device)
        u = self._rand((*shape, GAMMA_CANDIDATES))
        v = (1.0 + c * z) ** 3
        log_v = torch.log(v.clamp_min(1e-30))
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * log_v)
        first = ok.to(torch.uint8).argmax(-1, keepdim=True)
        log_g = math.log(d) + log_v.gather(-1, first).squeeze(-1)
        return log_g + torch.log(self._rand(shape)) / a

    def beta(self, a, b, shape=()):
        shape = tuple(shape)
        return torch.sigmoid(self._log_gamma(a, shape) - self._log_gamma(b, shape))

    def permutation(self, n):
        return torch.randperm(n, generator=self.generator, device=self.device)

    def bernoulli(self, p, shape):
        """A keep mask: True with probability ``p``."""
        return torch.rand(shape, generator=self.generator, device=self.device) < p

    def categorical(self, logits):
        """One index per row of ``logits`` (B, N), with replacement."""
        g = -torch.log(-torch.log(self._rand(logits.shape)))
        return (logits + g).argmax(-1)


class Record:
    """``draws``' values, each also appended to ``values`` (a list)."""

    def __init__(self, draws, values=None):
        self.draws = draws
        self.values = [] if values is None else values

    def __getattr__(self, name):
        fn = getattr(self.draws, name)
        if not callable(fn):  # device, generator
            return fn

        def recorded(*args, **kw):
            out = fn(*args, **kw)
            self.values.append(out)
            return out

        return recorded


class Replay:
    """The given values in order, as tensors on ``device``, whatever is
    asked; the shape must be the one asked for."""

    def __init__(self, values, device):
        self.values = list(values)
        self.device = device
        self.used = 0

    def _next(self, shape=None):
        if self.used >= len(self.values):
            raise IndexError(f"Replay: all {len(self.values)} values were used")
        v = self.values[self.used]
        v = (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))).to(self.device)
        self.used += 1
        if shape is not None and tuple(v.shape) != tuple(shape):
            raise ValueError(f"Replay: value {self.used - 1} has shape {tuple(v.shape)}, "
                             f"asked for {tuple(shape)}")
        return v

    def uniform(self, shape=()):
        return self._next(shape)

    def beta(self, a, b, shape=()):
        return self._next(shape)

    def permutation(self, n):
        return self._next((n,)).long()

    def bernoulli(self, p, shape):
        return self._next(shape).bool()

    def categorical(self, logits):
        return self._next(logits.shape[:-1]).long()
