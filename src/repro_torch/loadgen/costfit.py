"""Fit virtual-clock ``CostModel`` coefficients from the real engine
(``repro.loadgen.costfit``).

The load harness replays traces on a virtual clock whose step cost is a
frozen ``CostModel`` (overhead + per-prefill-chunk + per-decoded-token).
For single-arch policy comparisons the absolute coefficients cancel out,
but a *multi-architecture* replay table is only meaningful if each
architecture's clock reflects its actual step cost — an SSD decode step
and a paged-attention decode step are different machines.

``fit_cost_model`` measures a live ``ContinuousBatchingEngine``:

* ``prefill_chunk_s`` — warm median wall time of one full-width chunk
  launch (the first launch is discarded as the warm-up);
* ``decode_token_s`` — marginal cost per decoded token, from the slope
  of warm horizon time across two horizon lengths at full occupancy
  (the engine's launches are fixed-shape over ``max_seqs``, so active
  slot count does not move wall time — scan length does);
* ``step_overhead_s`` — the short-horizon time minus its per-token
  share (the intercept).

Wall-clock fits are machine-specific by nature; a replay pins the
coefficients it was given, so the replay itself stays deterministic. On
the card each timing ends in ``torch.cuda.synchronize`` (the engine's
launches return before the device is done); the engine decodes greedily,
so no generator is drawn from.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.loadgen.harness import CostModel
from repro_torch.rollout.continuous import ContinuousBatchingEngine, Request

_EPS_S = 1e-7  # floor: coefficients must stay positive for the replay


def _median(xs) -> float:
    return float(np.median(np.asarray(xs, np.float64)))


def _slot_of(engine: ContinuousBatchingEngine, rid: int) -> int:
    return next(s for s, r in engine.slots.items()
                if r is not None and r.rid == rid)


def fit_cost_model(cfg, params, *, max_seqs: int = 2,
                   decode_horizon: int = 4, prefill_chunk: int = 16,
                   block_size: int = 16, repeats: int = 3,
                   seed: int = 0, device="cuda") -> CostModel:
    """Measure one engine build's step costs; returns a ``CostModel``.

    Uses the same engine geometry the load harness builds so the fitted
    coefficients price the steps the replay actually counts. All timed
    launches are warm (the first discarded); each timing waits for the
    device.
    """
    rng = np.random.RandomState(seed)
    h_short, h_long = decode_horizon, 3 * decode_horizon

    def prompt(n: int) -> np.ndarray:
        return rng.randint(3, cfg.vocab_size, size=(n,)).astype(np.int32)

    def build(horizon: int) -> ContinuousBatchingEngine:
        mb = -(-(prefill_chunk + h_long * (repeats + 3)) // block_size) + 1
        return ContinuousBatchingEngine(
            cfg, max_seqs=max_seqs, block_size=block_size,
            n_blocks=max_seqs * mb + 1, max_blocks_per_seq=mb,
            greedy=True, decode_horizon=horizon,
            prefill_chunk=prefill_chunk, device=device)

    # --- prefill: one full-width chunk launch per timing ----------------
    # start_prefill (the control plane's streaming entry) only registers
    # the slot; the timed prefill_step owns the whole chunk launch.
    engine = build(h_short)
    dev = engine.device

    def wait() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prefill_times = []
    for it in range(repeats + 1):  # launch 0 is the warm-up
        engine._rid += 1
        req = Request(engine._rid, prompt(prefill_chunk), 1)
        slot = engine.free_slots()[0]
        engine.start_prefill(slot, req)
        wait()
        t0 = time.perf_counter()
        launched = engine.prefill_step(params, max_chunks=1)
        wait()
        prefill_times.append(time.perf_counter() - t0)
        assert launched == 1 and not engine.prefilling_slots()
        engine.release_slot(slot)
    prefill_chunk_s = max(_median(prefill_times[1:]), _EPS_S)

    # --- decode: warm horizon time at full occupancy, two horizons ------
    def horizon_time(engine: ContinuousBatchingEngine) -> float:
        max_new = engine.decode_horizon * (repeats + 2)
        rids = [engine.submit(prompt(4), max_new=max_new)
                for _ in range(max_seqs)]
        engine._admit(params)
        while engine.prefilling_slots():
            engine.prefill_step(params)
        engine.step_horizon(params)  # warm-up
        times = []
        for _ in range(repeats):
            wait()
            t0 = time.perf_counter()
            engine.step_horizon(params)  # ends in a blocking drain
            times.append(time.perf_counter() - t0)
        for rid in rids:
            engine.release_slot(_slot_of(engine, rid))
        return _median(times)

    t_short = horizon_time(engine)
    t_long = horizon_time(build(h_long))

    decode_token_s = max(
        (t_long - t_short) / (max_seqs * (h_long - h_short)), _EPS_S)
    step_overhead_s = max(t_short - max_seqs * h_short * decode_token_s,
                          _EPS_S)
    return CostModel(step_overhead_s=round(step_overhead_s, 7),
                     prefill_chunk_s=round(prefill_chunk_s, 7),
                     decode_token_s=round(decode_token_s, 7))


def describe(cost: CostModel) -> str:
    return (f"overhead={cost.step_overhead_s * 1e3:.3f}ms "
            f"chunk={cost.prefill_chunk_s * 1e3:.3f}ms "
            f"token={cost.decode_token_s * 1e3:.3f}ms")
