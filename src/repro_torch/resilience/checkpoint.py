"""Step-named crash-consistent checkpoints + ``latest`` pointer
(``repro.resilience.checkpoint``, the same files and layout).

Built on the atomic ``training.checkpoints`` primitive (tmp + fsync +
``os.replace`` of the npz/json pair with an embedded checksum). The
manager adds what a resumable async run needs:

* step-named checkpoints (``step_00000004.npz/json``) with bounded
  retention — a torn write of step k can never damage step k-1;
* a ``latest`` pointer file, itself atomically replaced, naming the last
  committed checkpoint;
* a full capture of everything bit-exact resume requires: params, Adam
  state, weight version, the rollout generator's state, the task's numpy
  RNG state, and the staleness history (behavior-policy param trees);
* ``restore_latest`` that falls back to scanning (newest valid first)
  when the pointer or its target is torn/corrupt.

Where the reference stores the rollout PRNG key (a JAX ``uint32[2]``),
this stores ``torch.Generator.get_state()`` (a CPU ``uint8`` tensor) under
``generator``; a reference checkpoint therefore has no state to resume a
port loop's sampling from. Restores go to a device: params (and history
trees) come back as trainable ``ParamTree``s in the dtype they were saved
from (bf16 leaves are written as float32, which holds them exactly, and
cast back), Adam moments as float32 trees and ``t`` / ``version`` as
0-d int32 tensors.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import ParamTree
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.tracing import instant
from repro_torch.training.checkpoints import (
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.training.optimizer import flatten
from repro_torch.training.trainer import TrainState

_LATEST = "latest"
_STEP_RE = re.compile(r"^(?P<prefix>.+)_(?P<step>\d{8})\.json$")
# metadata key: flat paths of the leaves that were bfloat16 when saved
_BF16_KEY = "bfloat16_leaves"


@dataclasses.dataclass
class ResumeInfo:
    """Everything needed to continue a run from a checkpoint."""

    state: TrainState
    step: int                       # first step index still to run
    # rollout torch.Generator state (Generator.get_state(): CPU uint8)
    generator_state: Optional[torch.Tensor] = None
    history: Optional[List[Tuple[Any, int]]] = None  # staleness history
    task_rng_state: Optional[Dict] = None   # numpy Generator state dict
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    path: str = ""


def _bf16_paths(tree, prefix: str) -> List[str]:
    return sorted(f"{prefix}/{k}" for k, v in flatten(tree).items()
                  if v.dtype == torch.bfloat16)


def _to_device(node, device, bf16: set, path: str):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (bf16 where the saved leaf was)."""
    if isinstance(node, dict):
        return {k: _to_device(v, device, bf16, f"{path}/{k}")
                for k, v in node.items()}
    t = torch.from_numpy(np.array(node, copy=True))
    return t.to(device=device,
                dtype=torch.bfloat16 if path in bf16 else t.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 prefix: str = "step"):
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- paths
    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:08d}")

    def _latest_pointer(self) -> str:
        return os.path.join(self.directory, _LATEST)

    def _scan(self) -> List[Tuple[int, str]]:
        """(step, base path) of every on-disk checkpoint, newest first."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and m.group("prefix") == self.prefix:
                base = os.path.join(self.directory, name[:-5])
                if os.path.exists(base + ".npz"):
                    out.append((int(m.group("step")), base))
        return sorted(out, reverse=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: TrainState, *,
             generator_state: Optional[torch.Tensor] = None,
             history: Optional[List[Tuple[Any, int]]] = None,
             task_rng_state: Optional[Dict] = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Commit a checkpoint for resuming *at* ``step`` (i.e. steps
        ``0..step-1`` are done). Returns the base path."""
        tree: Dict[str, Any] = {"params": state.params, "opt": state.opt}
        bf16 = _bf16_paths(state.params, "params")
        if generator_state is not None:
            tree["generator"] = generator_state.cpu().numpy()
        if history is not None:
            tree["history"] = [
                {"params": p, "version": np.int32(v)} for p, v in history]
            for i, (p, _) in enumerate(history):
                bf16 += _bf16_paths(p, f"history/#{i}/params")
        meta: Dict[str, Any] = dict(extra or {})
        meta["step"] = int(step)
        meta["version"] = int(state.version)
        meta["has_generator_state"] = generator_state is not None
        meta["has_history"] = history is not None
        meta[_BF16_KEY] = bf16
        if task_rng_state is not None:
            meta["task_rng_state"] = task_rng_state
        path = self.path_for(step)
        save_checkpoint(path, tree, meta)
        self._write_latest(step, path)
        self._retain()
        get_registry().counter("resilience_checkpoint_saves_total").inc()
        instant("checkpoint_saved", step=step, version=meta["version"])
        return path

    def _write_latest(self, step: int, base_path: str) -> None:
        ptr = {"step": int(step),
               "name": os.path.basename(base_path)}
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=".latest-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(ptr, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._latest_pointer())
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _retain(self) -> None:
        for _, base in self._scan()[self.keep:]:
            for ext in (".npz", ".json"):
                try:
                    os.unlink(base + ext)
                except OSError:
                    pass

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        info = self._read_pointer()
        if info is not None:
            return info[0]
        scan = self._scan()
        return scan[0][0] if scan else None

    def _read_pointer(self) -> Optional[Tuple[int, str]]:
        try:
            with open(self._latest_pointer()) as f:
                ptr = json.load(f)
            base = os.path.join(self.directory, ptr["name"])
            if os.path.exists(base + ".npz"):
                return int(ptr["step"]), base
        except (OSError, ValueError, KeyError):
            pass
        return None

    def restore(self, base_path: str, device="cuda") -> ResumeInfo:
        """Load ``base_path`` into a ``TrainState`` on ``device``."""
        tree, meta = load_checkpoint(base_path)
        device = torch.device(device)
        bf16 = set(meta.get(_BF16_KEY, ()))
        version = int(meta.get("version", 0))

        def params_of(node, path):
            return ParamTree(_to_device(node, device, bf16, path),
                             requires_grad=True)

        opt = tree["opt"]
        state = TrainState(
            params_of(tree["params"], "params"),
            {"m": _to_device(opt["m"], device, bf16, "opt/m"),
             "v": _to_device(opt["v"], device, bf16, "opt/v"),
             "t": torch.tensor(int(opt["t"]), dtype=torch.int32,
                               device=device)},
            torch.tensor(version, dtype=torch.int32, device=device))
        gen = (torch.from_numpy(np.array(tree["generator"], np.uint8))
               if "generator" in tree else None)
        history = None
        if "history" in tree:
            history = [(params_of(h["params"], f"history/#{i}/params"),
                        int(h["version"]))
                       for i, h in enumerate(tree["history"])]
        info = ResumeInfo(state=state, step=int(meta.get("step", 0)),
                          generator_state=gen, history=history,
                          task_rng_state=meta.get("task_rng_state"),
                          metadata=meta, path=base_path)
        get_registry().counter("resilience_checkpoint_restores_total").inc()
        instant("checkpoint_restored", step=info.step, version=version)
        return info

    def restore_latest(self, device="cuda") -> Optional[ResumeInfo]:
        """Restore the newest *valid* checkpoint: the ``latest`` pointer
        first, then a newest-first scan skipping torn/corrupt pairs.
        Returns None when the directory holds no usable checkpoint."""
        tried = set()
        candidates: List[Tuple[int, str]] = []
        ptr = self._read_pointer()
        if ptr is not None:
            candidates.append(ptr)
        candidates.extend(self._scan())
        for _, base in candidates:
            if base in tried:
                continue
            tried.add(base)
            try:
                return self.restore(base, device)
            except CheckpointError:
                get_registry().counter(
                    "resilience_checkpoint_corrupt_total").inc()
                continue
        return None
