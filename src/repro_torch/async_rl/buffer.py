"""Bounded rollout queue with staleness filtering (AReaL-style gate); a
copy of ``repro.async_rl.buffer``."""
from __future__ import annotations

import queue
import threading
from typing import List, Optional

from repro_torch.rollout.engine import RolloutBatch


class QueueClosed(RuntimeError):
    """Push/pop against a closed ``RolloutQueue`` — a dead peer raises
    instead of blocking forever."""


class RolloutQueue:
    """Thread-safe FIFO of rollout batches with a bounded-staleness gate.

    ``pop_fresh`` drops batches whose behavior version is more than
    ``max_staleness`` behind — the same data-discard policy AReaL applies to
    keep off-policyness bounded.

    Fault tolerance: ``close()`` flips a ``closed`` flag; subsequent pushes
    and pops raise ``QueueClosed`` (pops drain remaining items first), and
    blocked pops wake up at their next poll tick. ``pop``/``pop_fresh``
    raise ``TimeoutError`` after ``timeout`` seconds, so a consumer facing
    a dead producer fails loudly instead of deadlocking (the orchestrator
    pairs this with ``resilience.supervisor.pop_with_health``).
    """

    # closed-flag poll interval for blocking pops
    _POLL_S = 0.25

    def __init__(self, capacity: int = 16, max_staleness: int = 4):
        self._q: "queue.Queue[RolloutBatch]" = queue.Queue(maxsize=capacity)
        self.capacity = capacity
        self.max_staleness = max_staleness
        self.dropped = 0
        self._lock = threading.Lock()
        self._closed = threading.Event()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        """Mark the queue dead (producer or consumer going away)."""
        self._closed.set()

    def push(self, batch: RolloutBatch, timeout: Optional[float] = None
             ) -> bool:
        """False on a full queue (back-pressure); raises ``QueueClosed``
        once the queue is closed."""
        if self.closed:
            raise QueueClosed("push to closed RolloutQueue")
        try:
            self._q.put(batch, timeout=timeout)
            return True
        except queue.Full:
            return False

    def pop(self, timeout: Optional[float] = None) -> RolloutBatch:
        """One batch, no staleness gate. Raises ``TimeoutError`` after
        ``timeout`` seconds and ``QueueClosed`` when the queue is closed
        and drained (pending items are still delivered)."""
        deadline = None if timeout is None else \
            threading.TIMEOUT_MAX if timeout < 0 else timeout
        waited = 0.0
        while True:
            if self.closed:
                try:
                    return self._q.get_nowait()
                except queue.Empty:
                    raise QueueClosed("pop from closed, drained "
                                      "RolloutQueue") from None
            step = self._POLL_S if deadline is None \
                else min(self._POLL_S, max(deadline - waited, 0.0))
            try:
                return self._q.get(timeout=step)
            except queue.Empty:
                waited += step
                if deadline is not None and waited >= deadline:
                    raise TimeoutError(
                        f"RolloutQueue.pop timed out after {waited:.1f}s"
                    ) from None

    def pop_fresh(self, current_version: int, n: int = 1,
                  timeout: float = 30.0) -> List[RolloutBatch]:
        """Blocking pop of ``n`` sufficiently-fresh batches.

        ``timeout`` bounds the whole call (not per item); stale batches
        are dropped and counted without resetting the clock.
        """
        import time

        out: List[RolloutBatch] = []
        t0 = time.perf_counter()
        while len(out) < n:
            remaining = None if timeout is None \
                else timeout - (time.perf_counter() - t0)
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"RolloutQueue.pop_fresh: {len(out)}/{n} fresh batches "
                    f"within {timeout:.1f}s")
            batch = self.pop(timeout=remaining)
            # min_version: with per-token stamps (interruptible serving)
            # the *oldest* token in the batch decides its staleness
            if current_version - batch.min_version() > self.max_staleness:
                with self._lock:
                    self.dropped += 1
                continue
            out.append(batch)
        return out

    def qsize(self) -> int:
        return self._q.qsize()

    @property
    def depth_fraction(self) -> float:
        """Queue fullness in [0, 1] — the scheduler's backpressure signal."""
        return self._q.qsize() / self.capacity if self.capacity else 0.0
