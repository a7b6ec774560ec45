"""Versioned weight store — the trainer->rollout weight-sync channel (a
copy of ``repro.async_rl.weights``).

In AReaL this is an NCCL broadcast between GPU pools; here it is a lock-
protected (version, params) cell. The store hands out the published tree
itself, so a publisher must not update a published tree in place: the
trainer returns new parameter tensors every step (``donate_params=False``).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple


class WeightStore:
    def __init__(self, params: Any, version: int = 0):
        self._lock = threading.Lock()
        self._params = params
        self._version = version
        self._listeners: List[Callable[[int], None]] = []

    def subscribe(self, fn: Callable[[int], None]) -> None:
        """Register a publish listener (serving control plane interrupts).

        ``fn(version)`` is invoked synchronously after every publish, from
        the publisher's thread and outside the lock — listeners must be
        cheap and thread-safe (the InterruptController just sets an event).
        """
        with self._lock:
            self._listeners.append(fn)

    def publish(self, params: Any, version: int) -> None:
        with self._lock:
            self._params = params
            self._version = version
            listeners = list(self._listeners)
        for fn in listeners:
            fn(version)

    def latest(self) -> Tuple[Any, int]:
        with self._lock:
            return self._params, self._version

    @property
    def version(self) -> int:
        with self._lock:
            return self._version
