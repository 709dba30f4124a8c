"""Preemption handling and straggler detection for the train loop: the
one-card part of ``repro.train.elastic``.

  * ``PreemptionHandler`` - SIGTERM sets ``triggered`` instead of ending
    the process; the loop checks it each step, checkpoints and returns.
    ``restore`` puts the earlier handlers back.
  * ``StepTimer`` - EMA of step times; a step slower than
    ``straggler_factor`` times the EMA counts as a straggler.

The JAX module's ``choose_mesh`` and ``reshard`` rebuild a TPU mesh from
the devices that survive and move every array onto its new
``NamedSharding``; they wait with the parameter sharding of
``distributed/sharding.py`` (ROADMAP A14).
"""
from __future__ import annotations

import contextlib
import signal
import time
from typing import Optional


class PreemptionHandler:
    """Registers ``signals`` (SIGTERM); sets ``triggered`` instead of
    dying. Outside the main thread no handler can be installed, and
    ``triggered`` stays False."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.triggered = False
        self._old = {}
        for s in signals:
            try:
                self._old[s] = signal.signal(s, self._handle)
            except ValueError:          # not the main thread
                pass

    def _handle(self, signum, frame):
        self.triggered = True

    def restore(self):
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old = {}


class StepTimer:
    """EMA step timing and straggler counting."""

    def __init__(self, alpha: float = 0.1, straggler_factor: float = 2.0):
        self.alpha = alpha
        self.factor = straggler_factor
        self.ema: Optional[float] = None
        self.last: float = 0.0
        self.n_steps = 0
        self.n_stragglers = 0

    @contextlib.contextmanager
    def measure(self):
        """Observe the host wall time of the ``with`` body."""
        t0 = time.perf_counter()
        yield
        self.observe(time.perf_counter() - t0)

    def observe(self, dt: float):
        self.last = dt
        self.n_steps += 1
        if self.ema is None:
            self.ema = dt
            return
        if dt > self.factor * self.ema:
            self.n_stragglers += 1
        self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
