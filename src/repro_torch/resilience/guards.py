"""Training guards: non-finite update policies + windowed divergence (a
copy of ``repro.resilience.guards``).

The *detection* is on-device and free: the training step checks
``isfinite(loss) & isfinite(grad_norm)`` per minibatch (``grad_norm`` is a
global reduction, so any NaN/Inf gradient leaf poisons it) and, with
``Trainer(skip_nonfinite=True)``, applies the Adam update through a
``torch.where`` on that flag — a poisoned minibatch leaves params/opt
bit-identical instead of spreading NaNs. The count of skipped minibatch
updates rides in the existing packed metric array (``nonfinite`` key), so
the guard costs **zero extra host syncs**.

``TrainGuard`` is the host-side policy layer the orchestrator consults
once per step with that (already transferred) metric dict:

* ``policy="skip"``   — count skipped updates; training continues (the
  on-device where already protected the params).
* ``policy="rollback"`` — additionally restore the latest checkpoint when
  a step reports non-finite updates or the windowed divergence detector
  trips.
* ``policy="off"``    — observe only.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, Optional

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.tracing import instant

GUARD_POLICIES = ("off", "skip", "rollback")


class DivergenceDetector:
    """Windowed loss-divergence detector.

    Trips when the newest loss is non-finite, or exceeds
    ``mean + threshold_sigmas * std`` of the trailing window (computed
    *excluding* the newest sample, with at least ``min_window`` history).
    """

    def __init__(self, window: int = 16, threshold_sigmas: float = 6.0,
                 min_window: int = 8):
        self.window = window
        self.threshold_sigmas = threshold_sigmas
        self.min_window = min_window
        self._losses: Deque[float] = deque(maxlen=window)

    def update(self, loss: float) -> bool:
        """Feed one step loss; True when this step looks divergent (the
        divergent sample is *not* folded into the window)."""
        if not math.isfinite(loss):
            return True
        hist = list(self._losses)
        tripped = False
        if len(hist) >= self.min_window:
            mean = sum(hist) / len(hist)
            var = sum((x - mean) ** 2 for x in hist) / len(hist)
            std = math.sqrt(var)
            if std > 0 and loss > mean + self.threshold_sigmas * std:
                tripped = True
        if not tripped:
            self._losses.append(loss)
        return tripped

    def reset(self) -> None:
        self._losses.clear()


@dataclasses.dataclass
class GuardVerdict:
    action: str                 # "ok" | "skip" | "rollback"
    nonfinite_updates: float = 0.0
    diverged: bool = False


class TrainGuard:
    """Per-step policy over the packed metrics the step already produced."""

    def __init__(self, policy: str = "skip",
                 detector: Optional[DivergenceDetector] = None):
        assert policy in GUARD_POLICIES, policy
        self.policy = policy
        self.detector = detector or DivergenceDetector()
        self.skipped_updates = 0
        self.rollbacks = 0
        self.divergences = 0

    def after_step(self, metrics: Dict[str, float]) -> GuardVerdict:
        """Inspect one step's metric dict; returns the verdict the caller
        acts on (``rollback`` => restore the latest checkpoint)."""
        nonfinite = float(metrics.get("nonfinite", 0.0))
        reg = get_registry()
        if self.policy == "off":
            return GuardVerdict("ok", nonfinite)
        diverged = False
        loss = float(metrics.get("loss", 0.0))
        if math.isfinite(loss) or nonfinite == 0.0:
            # a step whose every minibatch was skipped reports a NaN loss
            # mean; only feed the detector meaningful losses
            diverged = self.detector.update(loss)
            if diverged:
                self.divergences += 1
                reg.counter("resilience_divergences_total").inc()
                instant("divergence_detected", loss=loss)
        if nonfinite > 0:
            self.skipped_updates += int(nonfinite)
            reg.counter("resilience_skipped_updates_total").inc(nonfinite)
            instant("nonfinite_update_skipped", count=nonfinite)
        if self.policy == "rollback" and (nonfinite > 0 or diverged):
            self.rollbacks += 1
            reg.counter("resilience_rollbacks_total").inc()
            self.detector.reset()
            return GuardVerdict("rollback", nonfinite, diverged)
        if nonfinite > 0:
            return GuardVerdict("skip", nonfinite, diverged)
        return GuardVerdict("ok", nonfinite, diverged)
