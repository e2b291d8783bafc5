"""Divergence canary: rolling-loss NaN/Inf and explosion detection (copy
of ``glint_word2vec_tpu/obs/canary.py``).

A rolling window over the per-step SGNS loss with two trip conditions:

- **non-finite**: any NaN/Inf loss;
- **explosion**: a loss more than ``factor`` times the window median once
  the window holds ``min_history`` healthy samples.

The canary only classifies; ``obs.ObsRun`` decides warn or abort and
owns the abort's side effects.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional


class TrainingDiverged(RuntimeError):
    """Raised by the abort-mode canary after the event log is flushed;
    the fit loop writes the final ``ckpt-diverged`` snapshot on the way
    out."""


class DivergenceCanary:
    """Rolling loss window; :meth:`check` returns None while healthy,
    else a one-line reason. A tripped sample stays out of the window, so
    a sustained explosion keeps tripping."""

    def __init__(self, window: int = 64, factor: float = 10.0,
                 min_history: int = 8):
        self.window: deque = deque(maxlen=max(2, int(window)))
        self.factor = float(factor)
        self.min_history = max(2, int(min_history))
        self.trips = 0
        self.last_reason: Optional[str] = None

    def _median(self) -> float:
        vals = sorted(self.window)
        mid = len(vals) // 2
        if len(vals) % 2:
            return vals[mid]
        return 0.5 * (vals[mid - 1] + vals[mid])

    def check(self, step: int, loss: float) -> Optional[str]:
        loss = float(loss)
        if not math.isfinite(loss):
            self.trips += 1
            self.last_reason = f"non-finite loss {loss} at step {step}"
            return self.last_reason
        if len(self.window) >= self.min_history:
            med = self._median()
            if med > 0 and loss > self.factor * med:
                self.trips += 1
                self.last_reason = (
                    f"loss {loss:.4g} at step {step} is {loss / med:.1f}x "
                    f"the rolling median {med:.4g} "
                    f"(threshold {self.factor:g}x)"
                )
                return self.last_reason
        self.window.append(loss)
        return None
