"""Supervised worker threads: heartbeats, capture, bounded restarts (a
copy of ``repro.resilience.supervisor``).

``SupervisedWorker`` wraps a worker body (e.g. the orchestrator's rollout
loop) in a supervisor thread that:

* runs the body with a ``WorkerContext`` (stop flag + heartbeat stamp);
* captures any exception as a ``CrashRecord`` (type, message, traceback)
  instead of letting the thread die silently;
* restarts the body up to ``max_restarts`` times under exponential
  backoff with seeded jitter (deterministic given the seed);
* flips ``failed`` once the restart budget is exhausted, so consumers
  polling the queue can raise instead of blocking forever.

The consumer side of the contract is ``pop_with_health``: a bounded-
wall-clock queue pop that interleaves short pop timeouts with worker
health checks (permanent failure, heartbeat silence) — the trainer can
never deadlock on a dead or hung producer.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Callable, List, Optional

import numpy as np

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.tracing import instant


@dataclasses.dataclass
class CrashRecord:
    t_crash_s: float          # perf_counter stamp of the crash
    exc_type: str
    message: str
    traceback_str: str
    restart_n: int            # how many restarts had already happened
    t_restarted_s: float = -1.0  # stamp of the successful restart (-1: none)

    @property
    def recovery_s(self) -> float:
        """Crash-to-restart wall time (the per-crash MTTR sample)."""
        return (self.t_restarted_s - self.t_crash_s
                if self.t_restarted_s >= 0 else float("nan"))


class WorkerContext:
    """What a supervised body sees: a stop flag and a heartbeat."""

    def __init__(self, stop_event: threading.Event,
                 heartbeat_fn: Callable[[], None]):
        self._stop = stop_event
        self._beat = heartbeat_fn

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def heartbeat(self) -> None:
        self._beat()


class WorkerFailed(RuntimeError):
    """The supervised producer is permanently down (restart budget spent
    or heartbeat silence) — raised by ``pop_with_health`` instead of a
    deadlocked queue pop."""


class SupervisedWorker:
    """Heartbeat-monitored worker thread with bounded seeded restarts.

    ``target(ctx, *args)`` must loop on ``ctx.should_stop()`` and call
    ``ctx.heartbeat()`` at least once per iteration. A return is a clean
    exit; an exception is a crash (captured + restarted while budget
    remains).
    """

    def __init__(self, name: str, target: Callable, args: tuple = (),
                 *, max_restarts: int = 3, backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0, jitter_frac: float = 0.5,
                 heartbeat_timeout_s: float = 60.0, seed: int = 0,
                 stop_event: Optional[threading.Event] = None):
        self.name = name
        self._target = target
        self._args = args
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter_frac = jitter_frac
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._rng = np.random.default_rng(seed)
        self._stop = stop_event or threading.Event()
        self._lock = threading.Lock()
        self._last_beat = time.perf_counter()
        self.crashes: List[CrashRecord] = []
        self.restarts = 0
        self.failed = False
        self._thread = threading.Thread(target=self._supervise, daemon=True,
                                        name=f"supervised-{name}")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "SupervisedWorker":
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    # ------------------------------------------------------------ heartbeat
    def _heartbeat(self) -> None:
        with self._lock:
            self._last_beat = time.perf_counter()

    def heartbeat_age_s(self) -> float:
        with self._lock:
            return time.perf_counter() - self._last_beat

    @property
    def last_crash(self) -> Optional[CrashRecord]:
        return self.crashes[-1] if self.crashes else None

    def health_error(self) -> Optional[str]:
        """Why this worker can no longer make progress (None = healthy)."""
        if self.failed:
            last = self.last_crash
            detail = f": {last.exc_type}: {last.message}" if last else ""
            return (f"worker {self.name!r} failed permanently after "
                    f"{self.restarts} restarts{detail}")
        if not self.alive and not self._stop.is_set():
            return f"worker {self.name!r} thread exited unexpectedly"
        if self.heartbeat_age_s() > self.heartbeat_timeout_s:
            return (f"worker {self.name!r} heartbeat silent for "
                    f"{self.heartbeat_age_s():.1f}s "
                    f"(> {self.heartbeat_timeout_s:.1f}s)")
        return None

    # ----------------------------------------------------------- supervisor
    def _backoff_s(self, n: int) -> float:
        base = min(self.backoff_base_s * (2.0 ** n), self.backoff_max_s)
        return base * (1.0 + self.jitter_frac * float(self._rng.random()))

    def _supervise(self) -> None:
        ctx = WorkerContext(self._stop, self._heartbeat)
        reg = get_registry()
        while not self._stop.is_set():
            self._heartbeat()
            try:
                self._target(ctx, *self._args)
                return  # clean exit
            except Exception as e:  # noqa: BLE001 — capture everything
                rec = CrashRecord(
                    t_crash_s=time.perf_counter(),
                    exc_type=type(e).__name__, message=str(e),
                    traceback_str=traceback.format_exc(),
                    restart_n=self.restarts)
                self.crashes.append(rec)
                reg.counter("resilience_worker_crashes_total").inc()
                instant("worker_crash", worker=self.name,
                        exc=rec.exc_type, restart_n=self.restarts)
                if self._stop.is_set():
                    return
                if self.restarts >= self.max_restarts:
                    self.failed = True
                    reg.counter("resilience_worker_failures_total").inc()
                    return
                delay = self._backoff_s(self.restarts)
                self.restarts += 1
                reg.counter("resilience_worker_restarts_total").inc()
                # interruptible backoff sleep
                self._stop.wait(delay)
                rec.t_restarted_s = time.perf_counter()
                instant("worker_restart", worker=self.name,
                        restart_n=self.restarts, backoff_s=round(delay, 4))


def pop_with_health(queue, worker: Optional[SupervisedWorker],
                    current_version: int, n: int = 1, *,
                    poll_s: float = 1.0, deadline_s: float = 120.0):
    """``RolloutQueue.pop_fresh`` with bounded wall-clock and producer
    health checks: raises ``WorkerFailed`` (dead/hung producer) or
    ``TimeoutError`` (deadline) instead of blocking forever."""
    from repro_torch.async_rl.buffer import QueueClosed

    t0 = time.perf_counter()
    while True:
        try:
            return queue.pop_fresh(current_version, n=n, timeout=poll_s)
        except QueueClosed:
            raise WorkerFailed(
                "rollout queue closed while the trainer was waiting")
        except TimeoutError:
            pass
        if worker is not None:
            err = worker.health_error()
            if err is not None:
                get_registry().counter(
                    "resilience_queue_timeouts_total").inc()
                raise WorkerFailed(err)
        if time.perf_counter() - t0 > deadline_s:
            get_registry().counter("resilience_queue_timeouts_total").inc()
            raise TimeoutError(
                f"no fresh rollout batch within {deadline_s:.0f}s "
                f"(queue depth {queue.qsize()})")
