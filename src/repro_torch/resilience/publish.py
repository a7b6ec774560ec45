"""Weight-publish retries with backoff (serving graceful degradation; a
copy of ``repro.resilience.publish``).

``ResilientPublisher`` wraps ``WeightStore.publish``: a failed publish
(injected via the fault plane, or a real exception from a store listener)
is retried under exponential backoff with seeded jitter. Until the retry
lands, serving simply keeps decoding under the previous version — the
store is untouched by a failed attempt, in-flight sequences never see a
half-published version, and per-token staleness stamps stay truthful
(tokens decoded during the outage carry the old version, which *is* the
version that produced them).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.async_rl.weights import WeightStore
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.tracing import instant
from repro_torch.resilience.faults import FaultPlan, InjectedFault


class PublishError(RuntimeError):
    """A weight publish attempt failed (injected or real)."""


class ResilientPublisher:
    def __init__(self, store: WeightStore, *,
                 faults: Optional[FaultPlan] = None, max_retries: int = 5,
                 backoff_base_s: float = 0.01, backoff_max_s: float = 0.5,
                 jitter_frac: float = 0.5, seed: int = 0):
        self.store = store
        self.faults = faults
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter_frac = jitter_frac
        self._rng = np.random.default_rng(seed)
        self.retries = 0      # lifetime retry count
        self.failures = 0     # publishes that exhausted the budget

    def _backoff_s(self, n: int) -> float:
        base = min(self.backoff_base_s * (2.0 ** n), self.backoff_max_s)
        return base * (1.0 + self.jitter_frac * float(self._rng.random()))

    def publish(self, params, version: int) -> int:
        """Publish with retries; returns the number of attempts used.

        Raises ``PublishError`` once ``max_retries`` retries are spent —
        the store still holds the previous version (serving keeps going);
        the caller decides whether that is fatal for training.
        """
        reg = get_registry()
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    spec = self.faults.check("publish_delay")
                    if spec is not None and spec.magnitude > 0:
                        time.sleep(spec.magnitude)
                    self.faults.maybe_crash("publish_fail")
                self.store.publish(params, version)
                if attempt:
                    reg.counter("resilience_publish_recoveries_total").inc()
                    instant("publish_recovered", version=version,
                            attempts=attempt + 1)
                return attempt + 1
            except (InjectedFault, PublishError) as e:
                if attempt >= self.max_retries:
                    self.failures += 1
                    reg.counter("resilience_publish_failures_total").inc()
                    raise PublishError(
                        f"weight publish v{version} failed after "
                        f"{attempt + 1} attempts: {e}") from e
                self.retries += 1
                reg.counter("resilience_publish_retries_total").inc()
                time.sleep(self._backoff_s(attempt))
                attempt += 1
