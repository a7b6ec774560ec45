"""Fault tolerance for the async runtime, in part (``repro.resilience``).

Ported so far: ``supervisor`` — heartbeat-monitored worker threads with
bounded seeded-backoff restarts and deadlock-free queue pops, which the
async orchestrator's rollout worker runs under. Fault injection, guards,
crash-consistent checkpoints and publish retries are not ported yet.
"""
from repro_torch.resilience.supervisor import (  # noqa: F401
    CrashRecord,
    SupervisedWorker,
    WorkerFailed,
    pop_with_health,
)

__all__ = ["CrashRecord", "SupervisedWorker", "WorkerFailed",
           "pop_with_health"]
