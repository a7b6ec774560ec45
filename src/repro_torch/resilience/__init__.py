"""Fault tolerance for the async runtime (``repro.resilience``).

Pieces (each independently usable):

* ``faults``     — seeded deterministic fault-injection plane
                   (``FaultPlan``, ``--fault KIND@STEP`` grammar);
* ``supervisor`` — heartbeat-monitored worker threads with bounded
                   seeded-backoff restarts + deadlock-free queue pops;
* ``guards``     — non-finite update policies (on-device detection rides
                   the packed metric array) and a divergence detector;
* ``checkpoint`` — crash-consistent step-named checkpoints with a
                   ``latest`` pointer and full-RNG capture (the rollout
                   ``torch.Generator``'s state, the task's numpy RNG) for
                   bit-exact resume;
* ``publish``    — weight-publish retries with backoff while serving
                   keeps decoding the old version.

``ResilienceConfig`` bundles them for ``AsyncOrchestrator`` /
``simulate_async``; every event lands in the ``resilience_*`` counter
family (``faults.resilience_snapshot``) and as tracer instants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.resilience.checkpoint import CheckpointManager, ResumeInfo
from repro_torch.resilience.faults import (
    FAULT_KINDS,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    parse_fault,
    resilience_snapshot,
)
from repro_torch.resilience.guards import (
    GUARD_POLICIES,
    DivergenceDetector,
    GuardVerdict,
    TrainGuard,
)
from repro_torch.resilience.publish import PublishError, ResilientPublisher
from repro_torch.resilience.supervisor import (
    CrashRecord,
    SupervisedWorker,
    WorkerFailed,
    pop_with_health,
)

__all__ = [
    "FAULT_KINDS", "GUARD_POLICIES", "CheckpointManager", "CrashRecord",
    "DivergenceDetector", "FaultPlan", "FaultSpec", "GuardVerdict",
    "InjectedFault", "PublishError", "ResilienceConfig",
    "ResilientPublisher", "ResumeInfo", "SupervisedWorker", "TrainGuard",
    "WorkerFailed", "parse_fault", "pop_with_health",
    "resilience_snapshot",
]


@dataclasses.dataclass
class ResilienceConfig:
    """Everything the async runtime needs to survive and resume.

    ``ckpt_every`` > 0 (with a ``checkpointer``) commits a checkpoint
    after every N completed steps; ``pop_deadline_s`` bounds the
    trainer's wait for a fresh rollout batch before declaring the
    producer dead.
    """

    faults: Optional[FaultPlan] = None
    guard: Optional[TrainGuard] = None
    checkpointer: Optional[CheckpointManager] = None
    ckpt_every: int = 0
    max_worker_restarts: int = 3
    heartbeat_timeout_s: float = 60.0
    pop_deadline_s: float = 120.0
    publish_max_retries: int = 5
    seed: int = 0

    def maybe_checkpoint(self, step_done: int) -> bool:
        """Should a checkpoint be committed after ``step_done``?"""
        return (self.checkpointer is not None and self.ckpt_every > 0
                and (step_done + 1) % self.ckpt_every == 0)
