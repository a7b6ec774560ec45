"""Training cells: ``Trainer.step`` of the port, back to back on
device-resident batches from the traffic file's pool.

Set-up builds one trainer and one state (seeded weights, zero Adam
state) and drives it through the pool's first ``CHECKED_STEPS`` batches
with the window's own call and hand-over; those steps warm every shape
the window uses, and their losses, metrics, first Adam moments and
weight changes are what the reference is compared with once the window
has closed. The window then runs steps on the pool's batches in turn,
each re-stamped against the trainer's current version, and closes at
the end of the first step that ends after ``--seconds``; a traced run
then traces one more step on each of the pool's batches.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import torch

from perfbench import check, traffic, weights as W
from perfbench.reference.common import BFLOAT16, PRECISIONS
from perfbench.reference.train import score, train as reference_train
from perfbench.trace import SPAN, read as read_trace

CHECKED_STEPS = 3

# fields the file sets as published where the port's registry keeps
# another value; they change no shape and no operation
_AS_FILED = ("norm_eps",)


def port_config(model: dict):
    """The port's ``ModelConfig`` for a configuration file: the
    registry's entry of that name with the file's fields, which must agree
    with the entry on every field outside ``_AS_FILED``, or (a test's small
    configuration) one built from the file."""
    import dataclasses

    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.registry import REGISTRY
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in model.items() if k in fields}
    entry = REGISTRY.get(model["name"])
    if entry is None:
        return ModelConfig(**kw)
    cfg = dataclasses.replace(entry, **kw)
    differ = [k for k in kw
              if k not in _AS_FILED and getattr(cfg, k) != getattr(entry, k)]
    if differ:
        raise ValueError(f"{model['name']}: the configuration file and the "
                         f"port's registry differ on {differ}")
    return cfg


def check_layout(cfg, weights: Dict[str, torch.Tensor]) -> None:
    """The benchmark's weights have the port's paths and shapes."""
    from repro_torch.models import model as M
    from repro_torch.models.params import walk
    port = {"/".join(p): tuple(s.shape) for p, s in walk(M.model_spec(cfg))}
    ours = {k: tuple(v.shape) for k, v in weights.items()}
    if port != ours:
        raise ValueError(f"weight layout differs from the port's: "
                         f"{sorted(set(port.items()) ^ set(ours.items()))[:6]}")


def nested(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def device_pool(pool: List[dict], model: dict, tr: dict, w, device
                ) -> List[Dict[str, torch.Tensor]]:
    """The pool on the device, with behaviour log-probs: the reference's
    bf16 log-probs under the initial weights, drifted by ``behav_drift``
    per version of staleness (a row d versions stale differs from the
    current policy by d updates), 0 off the response."""
    out = []
    for b in pool:
        t = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
        logp = score(w, model, t["tokens"], BFLOAT16)
        drift = tr["behav_drift"] * t["stale"].float()[:, None] * t["drift"]
        t["behav"] = (logp + drift) * t["mask"]
        t["stale_f"] = t["stale"].float()
        del t["drift"]
        out.append(t)
    return out


def rl_config(tr: dict):
    from repro_torch.configs.base import RLConfig
    return RLConfig(group_size=tr["group"], num_minibatches=tr["minibatches"],
                    **tr["rl"])


def reference_rl(tr: dict) -> dict:
    return dict(tr["rl"], group_size=tr["group"],
                num_minibatches=tr["minibatches"])


def handover(b: Dict[str, torch.Tensor], version: torch.Tensor):
    """A pool batch as the trainer takes it, its rows stamped d versions
    behind the trainer's current version (on the device: no sync)."""
    from repro_torch.training import TrainBatch
    return TrainBatch(tokens=b["tokens"], response_mask=b["mask"],
                      behav_logp=b["behav"],
                      versions=(version - b["stale"]).to(torch.int32),
                      rewards=b["rewards"])


class Program:
    """The system under test: one trainer and its state."""

    def __init__(self, model: dict, tr: dict, w: Dict[str, torch.Tensor],
                 device, fault: Optional[str] = None):
        from repro_torch.models.params import ParamTree
        from repro_torch.training import Trainer, TrainState, adam_init
        cfg = port_config(model)
        check_layout(cfg, w)
        self.trainer = Trainer(cfg, rl_config(tr), tr["algo"])
        params = ParamTree(nested(w), requires_grad=True)
        self.state = TrainState(params, adam_init(params),
                                torch.zeros((), dtype=torch.int32,
                                            device=device))
        self.fault = fault

    def step(self, b: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One ``Trainer.step``; it ends at the step's own host transfer.
        ``fault`` plants a fault the comparison has to catch: "half"
        hands over only the first half of the rows (where that splits a
        group, all rows with the second half's tokens masked out), so the
        means are taken over the rest; "unchanged" returns the state as
        it was (weights and Adam moments)."""
        st = self.state
        batch = handover(b, st.version)
        if self.fault == "half":
            n = batch.tokens.shape[0] // 2
            if n % self.trainer.rl.group_size == 0:
                for f in ("tokens", "response_mask", "behav_logp",
                          "versions", "rewards"):
                    setattr(batch, f, getattr(batch, f)[:n])
            else:  # one group: its second half's tokens left out instead
                batch.response_mask = batch.response_mask.clone()
                batch.response_mask[n:] = 0
        if self.fault == "unchanged":
            saved = {k: [t.clone() for t in _leaves(st.opt[k])]
                     for k in ("m", "v")}
            t_old = st.opt["t"].clone()
        new, out = self.trainer.step(st, batch)
        if self.fault == "unchanged":
            for k in ("m", "v"):
                for dst, src in zip(_leaves(st.opt[k]), saved[k]):
                    dst.copy_(src)
            st.opt["t"].copy_(t_old)
            new = type(st)(st.params, st.opt, new.version)
        self.state = new
        return out

    def leaf_norms(self, key: str) -> Dict[str, torch.Tensor]:
        from repro_torch.training.optimizer import flatten
        return {k: v.float().norm() for k, v in
                flatten(self.state.opt[key]).items()}

    def change_norms(self, w0: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        from repro_torch.training.optimizer import flatten
        p = flatten(self.state.params)
        return {k: (p[k].detach().float() - w0[k].float()).norm()
                for k in w0}


def _leaves(tree) -> List[torch.Tensor]:
    from repro_torch.training.optimizer import flatten
    return list(flatten(tree).values())


def _host(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(d)
    vals = torch.stack([d[k] for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


STEP_KEYS = ("loss", "grad_norm", "entropy", "iw_mean")


def checked_steps(prog: Program, pool_dev, w0) -> dict:
    """The first steps, recorded for the comparison."""
    rec = {"steps": [], "seconds": []}
    for s in range(CHECKED_STEPS):
        t0 = time.perf_counter()
        out = prog.step(pool_dev[s])
        rec["seconds"].append(time.perf_counter() - t0)
        rec["steps"].append({k: out[k] for k in STEP_KEYS})
        if s == 0:
            rec["m1"] = _host(prog.leaf_norms("m"))
    rec["change"] = _host(prog.change_norms(w0))
    return rec


def reference_readings(model, tr, seed, pool_dev, device,
                       precision: str = "float32") -> dict:
    """The reference's first steps from the same seeded weights and
    batches."""
    w = W.draw(model, seed, device)
    batches = [dict(b, stale=b["stale_f"]) for b in pool_dev[:CHECKED_STEPS]]
    return reference_train(w, model, reference_rl(tr), tr["algo"], batches,
                           CHECKED_STEPS, PRECISIONS[precision])


def setup(run, device, fault=None, control: Optional[str] = None):
    """Weights, the pool and the program, driven through the checked
    steps (``control``: the reference at that precision in the
    program's place)."""
    model, tr = run.model, run.traffic
    parts = run.setup_parts = {"before": time.perf_counter() - run.t_start}
    t = time.perf_counter()
    run.pool = traffic.generate(tr, model["vocab_size"], run.seed)
    w = W.draw(model, run.seed, device)
    parts["weights"] = time.perf_counter() - t
    run.pool_dev = device_pool(run.pool, model, tr, w, device)
    parts["pool"] = time.perf_counter() - t - parts["weights"]
    if control is not None:
        del w
        run.program_readings = reference_readings(model, tr, run.seed,
                                                  run.pool_dev, device,
                                                  control)
        return None
    prog = Program(model, tr, w, device, fault)
    run.program_readings = checked_steps(prog, run.pool_dev, w)
    parts["checked_steps"] = run.program_readings.pop("seconds")
    del w
    return prog


def _steps(run, prog: Program, done: int, until_s: float = math.inf,
           count: Optional[int] = None) -> List[dict]:
    """Steps on the pool's batches in turn, from the pool slot after
    ``done`` steps, until the first that ends after ``until_s`` or after
    ``count`` steps; each step's end from the first step's start."""
    from torch.profiler import record_function
    steps: List[dict] = []
    t0 = time.perf_counter()
    while True:
        slot = (CHECKED_STEPS + done + len(steps)) % len(run.pool)
        with record_function(SPAN + "train_step"):
            out = prog.step(run.pool_dev[slot])
        t = time.perf_counter() - t0
        steps.append({"slot": slot, "end_s": t,
                      "prox_s": out["prox_time_s"],
                      "finite": bool(math.isfinite(out["loss"])
                                     and out["nonfinite"] == 0)})
        if t >= until_s or len(steps) == count:
            return steps


def window(run, prog: Program, seconds: float, trace: bool) -> None:
    """Steps until the first that ends after ``seconds``. With ``trace``,
    one more step on each of the pool's batches under the profiler: its
    host cost slows a step by a share that varies from host to host (8-55
    % on an H100), so the window's own numbers are read without it."""
    from torch.profiler import ProfilerActivity, profile
    cuda = run.device.type == "cuda"
    # set-up's objects out of the collector's way: a full collection over
    # them would stall a step
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    run.setup_s = time.perf_counter() - run.t_start
    run.steps = _steps(run, prog, 0, until_s=seconds)
    run.window_s = run.steps[-1]["end_s"]
    if trace:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            run.traced_steps = _steps(run, prog, len(run.steps),
                                      count=len(run.pool))
        run.trace = read_trace(prof, run.traced_steps[-1]["end_s"])
    gc.unfreeze()
    run.peak_bytes = (torch.cuda.max_memory_allocated(run.device)
                      if cuda else 0)


def execute(run, fault: Optional[str] = None) -> None:
    """Set-up, the window and the comparison; fills ``run``."""
    prog = setup(run, run.device, fault)
    window(run, prog, run.seconds, run.trace_on)
    del prog
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    compare(run)


def compare(run) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ref = reference_readings(run.model, run.traffic, run.seed, run.pool_dev,
                             run.device)
    run.reference_s = time.perf_counter() - t0
    run.numbers = check.numbers(run.program_readings, ref)
    run.nought = check.nought_leaves(ref)
    run.correct, run.compared = check.judge(run.numbers, run.limits)

