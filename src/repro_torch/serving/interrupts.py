"""Interruptible generation: weight publishes land mid-decode (a copy of
``repro.serving.interrupts``).

The rollout engines the paper builds on (AReaL-style) either drain
in-flight requests before swapping weights (head-of-line blocking) or
restart them (wasted prefill). The control plane does neither: on
``WeightStore.publish`` the in-flight sequences *keep their paged KV* and
simply continue decoding under the new params — the per-token version
stamps recorded by ``ContinuousBatchingEngine.step`` mark exactly where
the behavior policy changed, which is what turns ``a3po.staleness`` from a
per-sequence scalar into an honest ``[B, T]`` signal.

``InterruptController`` is the bridge: it subscribes to the store, and the
serving loop calls ``poll()`` once per step to pick up the freshest
(params, version) plus an ``interrupted`` edge flag for metrics.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, List, Tuple

from repro_torch.async_rl.weights import WeightStore


@dataclasses.dataclass
class InterruptEvent:
    """One weight publish observed by the serving loop."""

    old_version: int
    new_version: int
    inflight: int   # sequences that resumed under the new params


class InterruptController:
    def __init__(self, store: WeightStore):
        self._store = store
        self._published = threading.Event()
        subscribe = getattr(store, "subscribe", None)
        if subscribe is not None:
            subscribe(self._on_publish)
        self._seen_version = store.version
        self.events: List[InterruptEvent] = []

    def _on_publish(self, version: int) -> None:
        self._published.set()

    def poll(self, inflight: int = 0) -> Tuple[Any, int, bool]:
        """Latest (params, version, interrupted-edge).

        ``interrupted`` is True exactly once per observed publish; when
        ``inflight`` > 0 the event is recorded (those sequences resume
        under the new params instead of being drained or restarted).
        """
        params, version = self._store.latest()
        changed = version != self._seen_version
        interrupted = changed or self._published.is_set()
        self._published.clear()
        if changed:
            self.events.append(InterruptEvent(self._seen_version, version,
                                              inflight))
            self._seen_version = version
        return params, version, interrupted

    @property
    def n_interrupts(self) -> int:
        return len(self.events)
