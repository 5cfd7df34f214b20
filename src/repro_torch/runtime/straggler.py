"""Straggler / anomaly detection for the train loop: the port's own copy
of the JAX package's ``repro.runtime.straggler.StepTimer``.

The watchdog tracks an EMA + variance of step wall-times, flags outliers
(> mean + k·σ and > abs_floor), and invokes a pluggable callback.
Detection is host-side and free — no device sync beyond the one the loop
already does on metrics.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class StepTimer:
    def __init__(self, *, ema: float = 0.9, k_sigma: float = 3.0,
                 warmup_steps: int = 5, abs_floor_s: float = 0.05,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None):
        self.ema = ema
        self.k = k_sigma
        self.warmup = warmup_steps
        self.abs_floor = abs_floor_s
        self.on_straggler = on_straggler
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.anomalies: list[tuple[int, float]] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else \
                (self.mean * (self.n - 1) + dt) / self.n
            return dt
        std = self.var ** 0.5
        if dt > max(self.mean + self.k * std, self.mean + self.abs_floor):
            self.anomalies.append((step, dt))
            if self.on_straggler:
                self.on_straggler(step, dt, self.mean)
        d = dt - self.mean
        self.mean += (1 - self.ema) * d
        self.var = self.ema * (self.var + (1 - self.ema) * d * d)
        return dt
