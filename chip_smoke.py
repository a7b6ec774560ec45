"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — requires CUDA (exits 2 otherwise, before printing any result)
             and prints the card's name and power limit from nvidia-smi.
2. build   — builds every CUDA source under src/repro_torch/kernels/csrc
             with nvcc, all at once, and prints the seconds.
3. kernels — each paged-attention kernel against its plain PyTorch version
             on the same inputs: bf16 at Qwen2.5-1.5B shapes (H=12, KV=2,
             hd=128, block 16, 8 slots, ragged lengths up to 2048, unmapped
             table entries, prefill padding rows) and float32 at toy-2m
             shapes, with the plain version in float32. Prints the errors
             against the stated tolerance (relative in bf16), shows that
             the tolerance fails a kernel one key or one page short, and
             the times of kernel, plain version and a library yardstick
             (SDPA over K/V gathered to dense, never called by the port),
             beside the least time the card could take. Paged decode also
             runs at the paged engine's own lengths (its first 8 prompts +
             16), at zamba2's shared-attention heads (H 32, KV 32, hd 64),
             at groups of 12 and 48 query heads per KV head, all timed, and
             at lengths on split and page boundaries with a wrong reference
             one key short past a split boundary; paged prefill also runs
             at the last chunk of a 1024-token prompt, the engine's first
             packed chunk, zamba2's heads and groups of 12 and 48, all
             timed, and at rows on split and page boundaries with the same
             extra wrong reference; each record gives the wrapper's split
             plan.
4. engine  — serves 16 seeded requests through 8 slots of the port's
             ContinuousBatchingEngine with Qwen2.5-1.5B at full width and
             depth (28 layers, bf16, seeded random weights, layer weights
             scaled x8 so the layers decide the tokens): launch counts of
             both kernels, pool drained, and for every request the
             whole-sequence forward_logits agrees with each recorded greedy
             token and behaviour logp; the same again in float32. A traced
             run of the same requests gives the prefill / decode split, and
             a profiled run the device time by kernel and the device's idle
             share.
5. training kernels — an empty kernel's launch (the floor); the reduced
             A-3PO kernels (the objective of a minibatch, its metrics and
             its gradient, one launch each way; float32, T = 2300, 1001 and
             2^20, the clip active on both sides, the iw cap active, the
             mask partial, as the training step calls it, with the KL and
             entropy terms set, and with the largest iw on masked-out
             tokens): c, the clipped count and the iw extremes bit for bit,
             every other sum within 1e-5 x sum(|terms|) / denom, which
             references that drop the last block's last pass, take iw_max
             over masked-out tokens or divide by T must fail; two launches
             bit-equal; the backward within 1e-6 relative; each timed
             beside its bound, its plain version, the launch floor and, on
             the same inputs, the parent's path (the per-token kernel, then
             eager reductions and autograd's backward) and the new op's,
             and at T 2300 and 2^20 at other grids; the per-token kernels
             (T = 2300 and 1001; 1e-6 relative, clip_tok exact); the
             token logprob + entropy (forward at the training step's shapes,
             T 2300, d 1536, V 151,936, bf16, through the TMA + wgmma
             kernel, and at V 1000 in float32 through the first design,
             against the plain version in float32 on the same values, with a
             tolerance a reference one vocab tile short fails; backward dh,
             dw at T 2300 (three token chunks) through the wgmma route
             against the plain float32 backward on the same logz, mu and
             cotangents, and at T 512 through autograd against autograd of
             the plain version, each with a reference that drops the
             entropy's cotangent failing it; the kernel's dl, a bf16 high
             part and remainder, against the plain float32 dl; dh, dw from
             the high parts alone recorded beside), each timed beside its
             bound (the backward's: its three products of 2 T d V flops at
             the bf16 tensor-core rate), its plain version and, where one
             exists, a library yardstick; the backward also with its peak
             device memory above its inputs.
6. training — Qwen2.5-1.5B at full width and depth (bf16, layer weights
             x8) serves two batches of 16 sampled requests (4 prompts x a
             group of 4, prompts 64-512 tokens, 64 new tokens) through the
             engine, and the A-3PO trainer takes three steps on them at
             staleness 0, 1 and 2 (batch A, B, A), checking every metric,
             the staleness-dependent invariants (alpha = 0: ratio 1, nothing
             clipped, iw near 1, i.e. the trainer's logp agrees with the
             engine's behaviour logp; alpha = 1: iw exactly 1), one host
             transfer per step, both training kernels launched and every
             logprob forward through the wgmma kernel; then one
             `recompute` step from the state before step 2, for the A-3PO
             against recompute step time; the profile of a step, with the
             device kernels of one A3PO.loss + backward at B 4 x T 575
             (at most 16, each reduced kernel once) beside the parent's
             path's.
7. training_float32 — the same step in float32 at full width and 4 layers,
             once through the kernels and once from a copy of the state with
             both training ops on their plain versions: every metric and
             every updated parameter agree, and the trainer's logp matches
             the engine's behaviour logp at staleness 0 to 1e-3.
8. dense kernels — flash attention (causal, B 16, S 1024, H 12, KV 2,
             hd 128; again with window 256 and at S 1000) and dense-cache
             decode attention (B 16, L 1056, lengths 1 .. L) on bf16 inputs,
             each against its plain version in float32 on the same values
             within 1e-4 + 1e-2 |ref|, which a wrong reference must fail
             (flash: the diagonal masked; decode: lengths - 1 and one key
             short at the longest row), timed beside its bound, its plain
             version and SDPA as a yardstick (flash also in TFLOP/s); both
             again at groups of 12 and 48 query heads over one KV head
             (flash at B 4), timed; dense decode also at lengths on its
             split and 16-key tile boundaries at L 1056 and L 1000 (not a
             multiple of the tile), with a wrong reference one key short
             at the row one key past a split boundary; each decode record
             gives the wrapper's split plan.
9. rollout — the dense RolloutEngine (prefill through the flash kernel,
             decode through the dense decode kernel) at Qwen2.5-1.5B, full
             width and depth, bf16, layer weights x8: PR 11's 16 requests
             right-padded to 1024, 32 greedy tokens, 28 flash and 28 x 32
             decode launches, every token and behaviour logp held against
             forward_logits.
10. async RL — `python -m repro_torch.launch.train --arch qwen2.5-1.5b
             --steps 4 --staleness 2` through its main() for a3po and
             recompute, its seeded initial layer weights x8 and the task's
             rewards replaced by seeded Bernoulli draws (staleness 0, 1, 2, 2; one host transfer per step, two
             for recompute; the kernels of both paths launched). After each
             run: step s generated with the version max(0, s - 2) tree,
             which still holds its values, the parameters moved, every
             behaviour logp agrees with forward_logits of its tree, and
             each kernel op is held against its plain version (with the
             wrong references of phases 3, 5 and 8) on the inputs of its
             last call in the run. Then simulate_async with x8 layer
             weights (the parameters move, the step-0 tree keeps its
             values) and the threaded AsyncOrchestrator (one record per
             step, staleness within the gate).
11. ssd kernels — the SSD decode step (8 slots, hd 64, nh 32 / ds 128 and
             nh 64 / ds 64) and the SSD intra-chunk block (8 rows x chunk
             256 at both models' widths, and x 64; the paged engine's
             own shapes, one row of 256 and a ragged one of 232 at both
             widths; the dense generate's 16 rows of 4 chunks of 256 at
             both widths) on bf16 inputs (xdt and
             state float32) against their plain versions in float32 on the
             same values, with wrong references the tolerance must fail
             (decode: the decay left out; intra-chunk: the diagonal j = i
             dropped, an exclusive cumsum, and the bf16 mma kernel's hi
             parts without its lo products); the intra-chunk kernel's
             in-chunk cumsum (which the scan uses) against torch.cumsum;
             the decode kernel in place under a mask leaves masked rows
             untouched; each timed as the path calls it (the intra-chunk
             kernel writing cum) beside its bound and its plain version
             (no single library call computes either); each record gives
             the wrapper's launch plan.
12. ssm serving — mamba2-370m (48 SSM layers) and zamba2-1.2b (32 SSM
             layers + 6 applications of one shared attention block) at full
             width and depth, bf16, seeded random weights: 16 requests
             through 8 slots of the paged engine (horizon 8, greedy,
             prefill chunks of 256), launch counts of both SSD kernels (and
             of the paged kernels for zamba2), pool and SSM slots drained,
             every token and behaviour logp held against forward_logits
             (phase 4's tolerances and floors); the same in float32; one
             dense RolloutEngine.generate of the ragged prompts, held the
             same way; the traced prefill / decode split, the device idle
             share of a profiled run and peak memory.
13. control plane — (a) Qwen2.5-1.5B at full width and depth (bf16,
             layer weights x8) through the serving control plane over the
             paged engine (8 slots, block 16, chunks of 256, horizon 8,
             greedy, prefill budget 2, radix cache on): a warm wave of 4
             distinct prompts (200, 511, 777, 1000 tokens), then a group
             wave of those 4 x a group of 4, 32 new tokens, with a
             pure-stamp publish (the same tree as version 1) after its
             second step: every group request hits the cache at P - 1,
             forks its shared partial tail page, and prefills one token
             (16 in all, against 9,952 without the cache); every token and
             behaviour logp held against forward_logits (phase 4's
             tolerances and floors), stamps monotone with versions 0 and 1,
             one interrupt; both paged kernels held on their last call over
             shared pages, with wrong references one key and one page
             short; the pool drained once the cache is cleared; the group
             wave's host-clock seconds, prefill chunks and prefill seconds
             with and without the cache; in float32 at 4 layers the cached
             waves give the uncached greedy tokens, logps within 2e-4.
             (b) `python -m repro_torch.launch.train --arch qwen2.5-1.5b
             --steps 4 --staleness 2 --engine async` through its main()
             (the threaded orchestrator over the control plane: block 8, 32
             slots), seeded initial layer weights x8 and seeded Bernoulli
             rewards: 4 records with serving snapshots, staleness within
             the gate, one host transfer a step, both paged and both
             training kernels launched, slots free and the pool drained,
             and each of the four held on the inputs of its last call with
             the wrong references of phases 3 and 5.
14. resilience — (a) the launcher at Qwen2.5-1.5B, full width, depth
             cut to 4 layers (a checkpoint holds params, Adam m and v and
             two history trees: ~8.4 GB at 4 layers, ~31 GB at 28), a3po
             at staleness 1, layer weights x8, Bernoulli rewards from the
             task's RNG: run A --steps 4 --ckpt-every 2, run B with
             --fault train_crash@3 (raises InjectedFault), run C
             --resume auto on B's directory (resumes at step 2): C's
             params, Adam m, v, t and version equal A's bit for bit, the
             step-2 and step-3 records too; C's resume again with the
             rollout generator's state left behind must differ; each
             save's bytes and seconds, each restore's seconds and the
             free disk. (b)
             full depth, --fault nan_grad@1 --guard skip: the one
             poisoned minibatch update skipped, params and Adam state bit
             for bit as before it, every param finite. (c) full depth,
             --engine async under rollout_crash, publish_fail,
             kv_exhaust (the whole free pool, 3 serving steps) and
             nan_logits: all steps, a worker restart, every fault fired,
             no non-finite behaviour logp trained on, the hold released,
             the run log valid under the port's obs.validate; both paged
             kernels held and timed on their last call.
15. loadgen — `python -m repro_torch.loadgen --arch qwen2.5-1.5b --quick`
             (float32, full depth) twice: byte-identical lifecycle JSONL,
             valid under validate_loadgen_jsonl; the paged kernels held
             and timed on their last call; a replay with --fault
             kv_exhaust; fit_cost_model on the card, its coefficients
             beside the card's name and power limit.
16. MoE, MLA and the frontend stacks — (a) qwen3-moe-30b-a3b at full
             width and depth (bf16, 61 GB, FFN weights x8) through the
             dense RolloutEngine: 8 right-padded prompts of up to 256
             tokens, 16 greedy new tokens; flash once per layer, dense
             decode once per layer per token, each held against its plain
             version on its last call and timed there; the share of
             dropped routed pairs per layer at prefill, tokens/s, peak
             memory, busy time and idle share. (b) `python -m
             repro_torch.launch.serve --arch deepseek-v2-lite-16b`: the
             full config in float32 (64.8 GB), two waves, exit 0 and each
             wave's tokens/s; one MLA layer in float32, the absorbed
             decode against the whole-sequence path. (c) qwen3-moe and
             deepseek-v2-lite at full width, 2 layers, bf16: 4 prompts x
             a group of 4 sampled through RolloutEngine, then Trainer.step
             (A-3PO at staleness 1, recompute after it): metrics finite,
             parameters moved, MoE aux above 0, the logprob and A-3PO
             kernels launched, held against their plain versions on
             their last call and timed there. (d) llava-next-mistral-7b
             (2880 image-patch rows) and musicgen-large (512 audio-frame
             rows) at full size in bf16, layer weights x8: forward_logits,
             then prefill +
             decode_step, the decode logits against forward_logits' last
             position; flash (S = prefix + 63; hd 64, G 1 for musicgen)
             and decode held and timed on their last call.
17. step programs and the dry-run — Qwen2.5-1.5B at full width and
             depth, bf16, layer weights x8, through launch/steps.py: (a)
             make_train_step with A-3PO and 4 microbatches on 8 seeded
             prompts of 992 tokens, each with 32 tokens sampled by the
             RolloutEngine (which gives the behaviour logps), seeded
             advantages: loss, entropy and gradient norm finite, the
             parameters moved, the logprob forward and backward and the
             A-3PO reduced op held against their plain versions on their
             last call and timed there; in float32 at 4 layers, 4
             microbatches against 1 (loss within rtol 1e-5, parameters
             within rtol 5e-3, atol 5e-5). (b) make_prefill_step with 4
             microbatches against 1 on 8 full 1024-token prompts: the
             last-token logits and every cache leaf within the bf16
             tolerance; flash held and timed on its last call. (c)
             make_decode_step for 16 greedy tokens after a prefill into a
             cache with room for them, each step's logits against
             forward_logits; dense decode held and timed on its last call.
             (d) restore_sharded of (a)'s parameters onto
             make_local_mesh(): bit-equal, on the card. (e) moe_apply_ep on
             the card's one-rank mesh at qwen3-moe-30b-a3b's layer shapes
             (float32, one layer, no pair dropped) against moe_apply. (f)
             on the card's host, subprocesses started after the build that
             run beside phases 3-16: `python -m repro_torch.launch.dryrun --arch
             qwen2.5-1.5b` for each of the four shapes and `--arch
             qwen3-moe-30b-a3b --shape train_4k --ep-moe` on the 16x16
             fake mesh, and `python -m repro_torch.launch.train --mesh
             prod --arch qwen2.5-1.5b`: each exits 0; each record's
             per-device argument GB, flops, collective bytes by kind and
             dominant term printed (an H100 data-sheet roofline over a
             fake mesh, not a measurement). The phase's seconds.
18. examples — (a) each of the seven examples under examples/ (the
             port's: torch_*.py) through its main() in this process at its
             toy defaults (toy-2m in its bf16), from a scratch directory,
             with --steps 3 where it has that flag and --sft-steps 20
             where it has that one, train_async_rl once more with
             --threaded: each ends normally with its summary as its last
             line, and the counts, set to 0 just before each, show it
             launched every kernel of its path (quickstart: the reduced
             A-3PO forward; train_async_rl and ablate_alpha: flash, dense
             decode, logprob and A-3PO both ways; serve_batch: flash and
             dense decode; serve_paged, serve_control_plane and
             loadgen_trace: paged prefill and paged decode); then
             torch_quickstart.py as a user runs it, a subprocess with
             PYTHONPATH=src, exit 0. (b) train_async_rl's path at
             Qwen2.5-1.5B, full width and depth, bf16, no weight scaling,
             on the arithmetic task's own rewards: sft_warmup (EX_SFT), the
             base eval (n 64), then from that one base simulate_async for
             a3po and recompute in turn (8 prompts x a group of 4, 6 new
             tokens, staleness 2, 8 steps, eval_reward n 32 every 4 steps):
             every SFT loss and step metric finite, the last 10 SFT losses'
             mean under half the first 10's, the base eval strictly
             between 0 and 1, the parameters moved in each run, a3po's mean
             prox time below recompute's, each kernel of the path held
             against its plain version on its last call and timed there;
             the SFT loss curve and seconds, the evals, reward curves, prox
             ms, step seconds, peak memory and launches printed beside the
             card's name and power limit. The RL lr (EX_RL) was chosen with
             `chip_sft_sweep.py --mode rl`; neither run may collapse: its
             last step's entropy at least half of step 0's and its final
             eval (n 64) at most 0.15 below the base eval.
19. dense prefill — the paged engine's prefill_mode="dense" against its
             chunk lane, Qwen2.5-1.5B full width and depth, bf16, layer
             weights x8, through the serving control plane (no radix
             cache, prefill budget 2) on bench_prefill's mix scaled to the
             model (12 prompts of 32-64 tokens, 2 of 1024 spread through
             the queue; 16 greedy tokens; 4 slots, pages of 16, chunks of
             256): each mode once with its kernels captured and its
             launches counted (the counts at 0 just before), then timed in
             turn (dense, chunked, chunked, dense): wall s, tokens/s, TTFT
             p50 / p99, prefill shapes and launches; every token and logp
             of both held against forward_logits. Then a dense-mode radix
             wave: 4 prompts, then 4 x 4 members sharing all but their
             last 8 tokens with one of them, so each member's tail runs
             through _prefill_suffix and forks the shared page, a
             pure-stamp publish mid-wave: hits, forks, stamps and tokens
             checked, the pool drained. In float32 at 4 layers, dense and
             chunked give the same greedy tokens and each prompt's
             next-token logits within 1e-4. Flash (its last whole-prompt
             prefill), paged decode (the decode lane's and the suffix's
             one-active-slot step) and paged prefill (the chunk lane's)
             held on their last calls, each wrong reference failing, and
             timed there.
20. ssm training — mamba2-370m and zamba2-1.2b at full width and depth,
             bf16, SSM in_proj / out_proj x8: (b) 4 prompts of 64-480
             tokens x a group of 4 sampled through the dense
             RolloutEngine (64 tokens, rows of up to 544: three chunks of
             256, the last padded), seeded Bernoulli rewards, then one
             a3po Trainer.step at staleness 1 and one recompute step:
             every metric finite, every leaf given a gradient (its Adam
             first moment moved; bf16 leaves near 1 round an lr-sized
             update away, so the unmoved ones are listed), the intra-chunk
             kernel not launched in a3po's step and once per SSM layer in
             recompute's prox forward; the logprob forward and backward
             (at mamba2's V 50,280, not a multiple of the 128-entry vocab
             tile) and the A-3PO loss held against their plain versions
             on their last call, with the wrong references of phase 10,
             the intra-chunk kernel on its last call (the prox forward)
             with phase 11's, each timed there; step s, prox s and peak
             memory; for mamba2 also launch/steps.py's make_train_step
             (A-3PO, 4 microbatches, seeded advantages): finite loss, the
             parameters moved, the intra-chunk kernel not launched; the
             profile of an a3po step. (a) At recompute's parameters its
             prox logps (the kernel route) against the training
             forward's route (the
             differentiable scan, gradients enabled) within the bf16
             tolerance, which a kernel route that drops the state carried
             into the second chunk must fail; at full width, 2 layers,
             float32, every SSM leaf's gradient on the card against the
             same on the CPU. (c) The launcher through its main(): mamba2
             `--engine sim` at staleness 2 sampled at top-p 0.9, zamba2
             `--engine async`, 4 steps, a3po: staleness, host syncs, the
             path's kernels launched; every behaviour logp against
             forward_logits of the tree that made it (across a publish,
             token by token on one cache under each token's stamp); the
             SSD, paged, logprob and A-3PO kernels held on their last
             call and timed there; rollout and train s a step.
21. the kernels line (all ten kernels, each with the shape its ms and
             bound belong to; the logprob forward's and backward's also with
             their wgmma launches on the main path, the backward's with its
             peak memory, dense decode's with its split plan, the A-3PO
             loss's with the launch floor and the parent's and the new
             op's path times; the control plane's kernels with their
             launches on its two paths; every kernel's launches on each
             path of phases 14 and 15, each path driven with the counts
             at 0; the paged kernels' times at phase 14 (c)'s and 15's
             shapes, and rows 3-6's launches and times on the paths of
             phases 16, 17 and 18, rows 1, 2 and 4's on phase 19's, and
             rows 1, 2 and 5-8's on phase 20's), then
             the contract line (last):
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises, so the script exits non-zero without a last line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# card peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
# Kernel vs plain version, elementwise |out - ref| <= atol + rtol * |ref|.
# The plain version runs in float32 on the kernel's own (bf16 or float32)
# input values. The kernel accumulates in float32 and rounds only its
# output, a relative 2**-9 in bf16, so bf16 gets rtol 5x that rounding and
# an atol for float32 summation order. Attention outputs over ~1000 keys are
# ~0.04 in size, so an absolute tolerance alone cannot see a missing key;
# each check also holds the kernel against references with one key and one
# page too few at the longest row, and those must fail it.
TOL = {"bfloat16": {"rtol": 1e-2, "atol": 1e-4},
       "float32": {"rtol": 0.0, "atol": 2e-5}}
# bf16 engine vs whole-sequence reference. The two run different product
# shapes and attention orders in bf16 over 28 layers, so their hidden states
# differ by bf16 rounding. A recorded logp must be within ENGINE_LOGP_TOL
# of the reference's (it carries the log-sum-exp over 151,936 logits, which
# moves with every one of them; measured <= 0.118 over the 16 requests on
# an H100). A recorded greedy token must be within ENGINE_GAP_TOL of the
# reference's best log-prob at its step: where two tokens are closer than
# the rounding moves each logit, either side may win (measured <= 0.088);
# MIN_ARGMAX_AGREE bounds how often that may happen.
ENGINE_GAP_TOL = 0.25
ENGINE_LOGP_TOL = 0.25
# the same check in float32: only summation order differs
F32_TOL = 5e-3
# At the reference's init stds the tied embedding dominates and the random
# model repeats its last token with logp ~0, which would pass any check of
# the layers. Scaled x8, the layer weights decide the tokens (flat,
# input-dependent outputs, logp ~ -7.5).
SCALE = 8.0
# floors that a degenerate output (one token repeated at logp ~0) fails:
# share of recorded tokens that are the reference's argmax, distinct
# tokens per request (summed over the requests; greedy loops make single
# requests repeat), and the mean behaviour logp
MIN_ARGMAX_AGREE = 0.9
MIN_DISTINCT_PER_REQUEST = 2.0
MAX_MEAN_LOGP = -1.0


# --- training
# one minibatch of the training step: 4 sequences x 575 scored positions
TRAIN_T = 2300
# fused A-3PO loss kernel vs its plain version: both round every operation
# as PyTorch's float32 ops do, so only expf may differ (by an ulp or two)
A3PO_RTOL = 1e-6
# The reduced A-3PO kernels at the training step's T, an odd T and a long
# minibatch (128 x 8192 tokens). Against the plain version: c, the clipped
# count and the iw extremes bit for bit; every other slot is a float32 sum
# in another order, held within A3PO_SUM_RTOL x sum(|terms|) / denom (the
# loss and the KL are signed sums that cancel, so a tolerance relative to
# the result has no floor).
A3PO_TS = (TRAIN_T, 1001, 2 ** 20)
A3PO_SUM_RTOL = 1e-5
# the cases held at each T: (kl_coef, entropy_coef, iw_cap, masked-out
# behav shift). "path" is the training step's call (entropy reported, no
# regularizer: the timed case); "uncapped" puts the largest iw on
# masked-out tokens, so that an iw_max over them shows
A3PO_CASES = {"path": (0.0, 0.0, 5.0, 0.0),
              "regularized": (0.1, 0.01, 5.0, 0.0),
              "uncapped": (0.0, 0.0, 1e4, -8.0)}
# float32 operations a token (an exp counted as one): the token pass and
# its seven sums and two extremes; the backward's product and sum
A3PO_FWD_OPS, A3PO_BWD_OPS = 36, 3
# logprob kernel vs its plain version in float32 on the same values: the
# kernel accumulates in float32 in another order. logp ~ -12 at V = 151,936
# and one 128-entry vocab tile moves logz by ~128 / V ~ 8e-4, so this
# tolerance (2.2e-4 at |ref| = 12) must fail a kernel a tile short: the
# check holds the kernel against such a reference too.
LOGPROB_TOL = {"rtol": 1e-5, "atol": 1e-4}
# logprob backward: dh and dw are rounded to the operand dtype (bf16: a
# relative 2**-9); |out - ref| <= 1e-5 max|ref| + rtol |ref|
LOGPROB_BWD_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
# training at full width: 4 prompts x a group of 4 sampled completions
GROUP = 4
TRAIN_PROMPTS = 4
TRAIN_MAX_NEW = 64
TRAIN_PROMPT_PAD = 512
TRAIN_ENGINE_KW = dict(max_seqs=16, block_size=16, n_blocks=1024,
                       max_blocks_per_seq=40, prefill_chunk=512,
                       decode_horizon=8)
# at staleness 0 the trainer's logp must match the engine's behaviour logp:
# in bf16 the two run different product shapes (measured up to 0.118 per
# token in the engine check), so the mean importance weight exp(logp -
# behav) is held to [0.9, 1.1]; in float32 each logp to 1e-3
IW_MEAN_BAND = (0.9, 1.1)
F32_LOGP_TOL = 1e-3
# float32 step, kernels vs plain versions (tests/test_torch_training.py's
# tolerances). lr 1e-3 moves the weights well past the tolerance; Adam eps
# 1e-4 keeps Adam's first (sign-like) step smooth in gradients that the two
# paths round differently, as in those tests
STEP_METRIC_TOL = {"rtol": 2e-4, "atol": 1e-5}
STEP_PARAM_TOL = {"rtol": 2e-4, "atol": 1e-6}
F32_LAYERS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: v["ptxas"].splitlines() for k, v in report.items()}})


# ------------------------------------------------------------------ kernels
# ~0.1 ms of device time at the H100's clock: longer than any wrapper's
# host work, which a small kernel's time would otherwise take in
SPIN_CYCLES = 200_000


class Timer:
    """CUDA-event time of one call, with the L2 cache flushed before each
    launch (the engine finds each layer's pages cold): the median over
    ``iters`` launches, so that a rare stall of the host (longer than the
    spin) does not move it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")  # 256 MB > 50 MB L2

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            # keep the card busy while the host runs the wrapper, so that
            # the events time the device's work, never an idle gap
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def _pool(torch, g, *, n_blocks, bs, KV, hd, S, mb, max_len, dtype,
          lengths=None):
    """A shuffled pool, ragged lengths in [1, max_len] (or ``lengths``),
    tables mapped up to each slot's length and -1 beyond (as the engine
    leaves them)."""
    pool_k = torch.randn(n_blocks, bs, KV, hd, generator=g,
                         device="cuda").to(dtype)
    pool_v = torch.randn(n_blocks, bs, KV, hd, generator=g,
                         device="cuda").to(dtype)
    perm = torch.randperm(n_blocks, generator=g, device="cuda")
    tables = perm[: S * mb].reshape(S, mb).to(torch.int32)
    if lengths is not None:
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    else:
        lengths = torch.randint(1, max_len + 1, (S,), generator=g,
                                device="cuda").to(torch.int32)
        lengths[0] = max_len  # one slot filled to the whole table
    for s in range(S):
        tables[s, -(-int(lengths[s]) // bs):] = -1
    return pool_k, pool_v, tables, lengths


def _prefill_rows(torch, lengths, C, pad_rows):
    """A packed chunk: each slot in turn contributes a contiguous run of
    its last positions; the last ``pad_rows`` rows are padding."""
    seg, pos = [], []
    S = lengths.shape[0]
    lens = lengths.tolist()
    per = (C - pad_rows) // S
    for s in range(S):
        n = min(per, lens[s])
        seg += [s] * n
        pos += list(range(lens[s] - n, lens[s]))
    seg += [-1] * (C - len(seg))
    pos += [0] * (C - len(pos))
    dev = lengths.device
    return (torch.tensor(seg, dtype=torch.int32, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


def _sdpa_dense(torch, q, pool_k, pool_v, row_tables, row_lens):
    """SDPA over per-row K/V gathered to dense (the yardstick's inputs)."""
    R, mb = row_tables.shape
    bs = pool_k.shape[1]
    safe = row_tables.clamp_min(0).long()
    k = pool_k[safe].reshape(R, mb * bs, *pool_k.shape[2:]).transpose(1, 2)
    v = pool_v[safe].reshape(R, mb * bs, *pool_v.shape[2:]).transpose(1, 2)
    mask = (torch.arange(mb * bs, device=q.device)[None, :]
            < row_lens[:, None])[:, None, None, :]
    qq = q[:, :, None, :]  # [R, H, 1, hd]
    F = torch.nn.functional

    def call():
        return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return call


def phase_kernels(torch):
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn.ref import paged_decode_attention_ref
    from repro_torch.kernels.prefill_attn import ops as pops
    from repro_torch.kernels.prefill_attn.ref import (
        paged_prefill_attention_ref,
    )

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    shapes = [
        # (dtype, H, KV, hd, bs, n_blocks, S, mb, max_len, C, timed)
        ("bfloat16", 12, 2, 128, 16, 4096, 8, 128, 2048, 256, True),
        ("float32", 2, 1, 64, 8, 256, 4, 16, 128, 32, False),
    ]
    for (dname, H, KV, hd, bs, n_blocks, S, mb, max_len, C,
         timed) in shapes:
        dtype = getattr(torch, dname)
        tol = TOL[dname]
        pool_k, pool_v, tables, lengths = _pool(
            torch, g, n_blocks=n_blocks, bs=bs, KV=KV, hd=hd, S=S, mb=mb,
            max_len=max_len, dtype=dtype)
        esize = pool_k.element_size()
        k32, v32 = pool_k.float(), pool_v.float()
        # ---- decode (slot 0 is the longest row)
        q = torch.randn(S, H, hd, generator=g, device="cuda").to(dtype)
        out = dops.paged_decode_attention_op(q, pool_k, pool_v, tables,
                                             lengths)
        q32 = q.float()

        def dref(lens):
            return paged_decode_attention_ref(q32, k32, v32, tables, lens)

        wrong = {}
        for label, cut in (("one_key_short", 1), ("one_page_short", bs)):
            lens = lengths.clone()
            lens[0] -= cut
            wrong[label] = dref(lens)
        n_keys = int(lengths.sum())
        rec = {"phase": "kernel", "name": "paged_decode_attention",
               "dtype": dname, "shape": {"S": S, "H": H, "KV": KV, "hd": hd,
                                         "bs": bs, "mb": mb,
                                         "keys": n_keys},
               "splits": _decode_splits(torch, mb, bs, S, KV)}
        _hold(torch, rec, out, dref(lengths), tol, wrong)
        rec["max_abs_err_vs_plain_in_" + dname] = (
            out.float() - paged_decode_attention_ref(
                q, pool_k, pool_v, tables, lengths).float()).abs().max().item()
        if timed:
            nbytes = (2 * q.numel() * esize + 2 * n_keys * KV * hd * esize
                      + tables.numel() * 4 + lengths.numel() * 4)
            flops = 4 * H * hd * n_keys
            rec.update(_times(torch, timer, dname, nbytes, flops,
                              lambda: dops.paged_decode_attention_op(
                                  q, pool_k, pool_v, tables, lengths),
                              lambda: paged_decode_attention_ref(
                                  q, pool_k, pool_v, tables, lengths),
                              _sdpa_dense(torch, q, pool_k, pool_v, tables,
                                          lengths)))
            results["paged_decode_attention"] = rec
        emit(rec)
        # ---- prefill (the row at the largest position is the longest)
        seg, pos = _prefill_rows(torch, lengths, C, pad_rows=3)
        qc = torch.randn(C, H, hd, generator=g, device="cuda").to(dtype)
        out = pops.paged_prefill_attention_op(qc, pool_k, pool_v, tables,
                                              seg, pos)
        qc32 = qc.float()

        def pref(p):
            return paged_prefill_attention_ref(qc32, k32, v32, tables, seg, p)

        wrong = {}
        longest = int(torch.argmax(torch.where(seg < 0, -1, pos)))
        for label, cut in (("one_key_short", 1), ("one_page_short", bs)):
            p = pos.clone()
            p[longest] -= cut
            wrong[label] = pref(p)
        pad = seg < 0
        row_keys = torch.where(pad, 0, pos + 1)
        seg_keys = sum(int(row_keys[seg == s].max())
                       for s in range(S) if bool((seg == s).any()))
        rec = {"phase": "kernel", "name": "paged_prefill_attention",
               "dtype": dname, "shape": {"C": C, "H": H, "KV": KV, "hd": hd,
                                         "bs": bs, "mb": mb,
                                         "pad_rows": int(pad.sum()),
                                         "row_keys": int(row_keys.sum())}}
        _hold(torch, rec, out, pref(pos), tol, wrong)
        rec["max_abs_err_vs_plain_in_" + dname] = (
            out.float() - paged_prefill_attention_ref(
                qc, pool_k, pool_v, tables, seg, pos).float()
        ).abs().max().item()
        if bool(out[pad].any()):
            raise AssertionError(f"paged_prefill_attention: padding rows "
                                 f"not zero: {rec}")
        if timed:
            nbytes = (2 * qc.numel() * esize
                      + 2 * seg_keys * KV * hd * esize
                      + tables.numel() * 4 + 2 * C * 4)
            flops = 4 * H * hd * int(row_keys.sum())
            row_tables = tables[seg.clamp_min(0).long()]
            rec.update(_times(torch, timer, dname, nbytes, flops,
                              lambda: pops.paged_prefill_attention_op(
                                  qc, pool_k, pool_v, tables, seg, pos),
                              lambda: paged_prefill_attention_ref(
                                  qc, pool_k, pool_v, tables, seg, pos),
                              _sdpa_dense(torch, qc, pool_k, pool_v,
                                          row_tables, row_keys),
                              plain_iters=5))
            results["paged_prefill_attention"] = rec
        emit(rec)
    for case in _decode_cases(torch):
        emit(_decode_case(torch, timer, g, **case))
    for case in _prefill_cases(torch):
        emit(_prefill_case(torch, timer, g, **case))
    return results


def _decode_splits(torch, mb, bs, S, KV):
    """The paged decode wrapper's split plan for these sizes."""
    from repro_torch.kernels.decode_attn import paged_kernel
    pps, n = paged_kernel.split_plan(
        mb, bs, S, KV, paged_kernel.sm_count(torch.cuda.current_device()))
    return {"pages_per_split": pps, "n_splits": n, "split_keys": pps * bs}


def _decode_cases(torch):
    """Paged decode beyond the timed shape: the paged engine's own lengths
    (its first 8 prompts + 16 generated tokens), zamba2's shared attention
    heads, and lengths on split and page boundaries (the wrapper's split
    length sk and page 16) with a wrong reference one key short at the row
    one key past a split boundary."""
    from repro_torch.configs.registry import get_config
    eng = [len(r) + 16 for r in _requests(get_config("qwen2.5-1.5b"))[:8]]
    sk = _decode_splits(torch, 128, 16, 8, 2)["split_keys"]
    return [
        dict(label="engine_lengths", H=12, KV=2, hd=128, lengths=eng,
             timed=True),
        dict(label="zamba2_heads", H=32, KV=32, hd=64, lengths=None,
             timed=True),
        dict(label="split_boundaries", H=12, KV=2, hd=128,
             lengths=[2048, sk + 1, sk, sk - 1, 2 * sk + 1, 16, 17, 1],
             timed=False,
             short_rows={"one_key_short_past_a_split": 1}),
        dict(label="group_12", H=12, KV=1, hd=128, lengths=None, timed=True),
        dict(label="group_48", H=48, KV=1, hd=128, lengths=None, timed=True),
    ]


def _decode_case(torch, timer, g, *, label, H, KV, hd, lengths, timed,
                 short_rows=None):
    """Paged decode in bf16 at 8 slots, bs 16, mb 128 (lengths None: ragged
    up to 2048) against its plain version in float32, with wrong
    references one key and one page short at the longest row (and one key
    short at each row of ``short_rows``) that must fail; timed beside its
    bound, its plain version and SDPA over gathered K/V."""
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn.ref import paged_decode_attention_ref
    S, bs, mb, n_blocks = 8, 16, 128, 4096
    pool_k, pool_v, tables, lens = _pool(
        torch, g, n_blocks=n_blocks, bs=bs, KV=KV, hd=hd, S=S, mb=mb,
        max_len=2048, dtype=torch.bfloat16, lengths=lengths)
    q = torch.randn(S, H, hd, generator=g, device="cuda").to(torch.bfloat16)
    out = dops.paged_decode_attention_op(q, pool_k, pool_v, tables, lens)
    q32, k32, v32 = q.float(), pool_k.float(), pool_v.float()

    def dref(ls):
        return paged_decode_attention_ref(q32, k32, v32, tables, ls)

    longest = int(torch.argmax(lens))
    wrong = {}
    for name, (row, cut) in dict(
            {"one_key_short": (longest, 1), "one_page_short": (longest, bs)},
            **{k: (r, 1) for k, r in (short_rows or {}).items()}).items():
        ls = lens.clone()
        ls[row] -= cut
        wrong[name] = dref(ls)
    n_keys = int(lens.sum())
    rec = {"phase": "kernel", "name": "paged_decode_attention",
           "case": label, "dtype": "bfloat16",
           "shape": {"S": S, "H": H, "KV": KV, "hd": hd, "bs": bs, "mb": mb,
                     "keys": n_keys},
           "lengths": lens.tolist(),
           "splits": _decode_splits(torch, mb, bs, S, KV)}
    _hold(torch, rec, out, dref(lens), TOL["bfloat16"], wrong)
    if timed:
        nbytes = (2 * 2 * q.numel() + 2 * n_keys * KV * hd * 2
                  + tables.numel() * 4 + lens.numel() * 4)
        rec.update(_times(torch, timer, "bfloat16", nbytes,
                          4 * H * hd * n_keys,
                          lambda: dops.paged_decode_attention_op(
                              q, pool_k, pool_v, tables, lens),
                          lambda: paged_decode_attention_ref(
                              q, pool_k, pool_v, tables, lens),
                          _sdpa_dense(torch, q, pool_k, pool_v, tables,
                                      lens)))
    return rec


def _prefill_cases(torch, n_sm=None):
    """Paged prefill beyond the timed shape (8 slots, bs 16, mb 128): the
    last chunk of a 1024-token prompt (one segment of 256 rows at 768 ..
    1023), the paged engine's first packed chunk (its first 8 prompts,
    shortest remaining first, from position 0), zamba2's shared attention
    heads, groups of 12 and 48 (command-r-plus's and granite-34b's), and
    rows ending on split and page boundaries with a wrong reference one
    key short at the row one key past a split boundary. Runs are (slot,
    first position, rows); the timed shape's runs are 8 x 31 rows at the
    ends of ragged lengths up to 2048. ``n_sm``: the SM count the split
    boundaries are placed for (the card's by default)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.prefill_attn import kernel as pk
    lens = [len(r) for r in _requests(get_config("qwen2.5-1.5b"))[:8]]
    first, used = [], 0
    for slot in sorted(range(8), key=lambda s: (lens[s], s)):
        take = min(lens[slot], 256 - used)
        if take <= 0:
            break
        first.append((slot, 0, take))
        used += take
    rng = np.random.default_rng(5)
    ragged = [(s, int(e) - 31, 31) for s, e in
              enumerate(rng.integers(32, 2049, size=8))]
    if n_sm is None:
        n_sm = _prefill_splits(torch, 256, 12, 2, 128, 16)["n_sm"]
    pps, _ = pk.split_plan(256, 6, 2, 128, 16, n_sm)
    sk = pps * 16
    bounds = [(0, 2048 - 31, 31), (1, sk - 30, 31), (2, sk - 31, 31),
              (3, sk - 32, 31), (4, 2 * sk - 30, 31), (5, 0, 16), (6, 0, 17),
              (7, 0, 1)]
    return [
        dict(label="last_chunk_of_1024", H=12, KV=2, hd=128,
             runs=[(0, 768, 256)], pad=0, timed=True),
        dict(label="engine_first_chunk", H=12, KV=2, hd=128, runs=first,
             pad=0, timed=True),
        dict(label="zamba2_heads", H=32, KV=32, hd=64, runs=ragged, pad=8,
             timed=True),
        dict(label="group_12", H=12, KV=1, hd=128, runs=ragged, pad=8,
             timed=True),
        dict(label="group_48", H=48, KV=1, hd=128, runs=ragged, pad=8,
             timed=True),
        # row 31 + 30 is slot 1's last, at position sk: one key past split
        # 0 (256 rows, so the wrapper's plan is the one sk was taken from)
        dict(label="split_boundaries", H=12, KV=2, hd=128, runs=bounds,
             pad=256 - 5 * 31 - 34, timed=False,
             short_rows={"one_key_short_past_a_split": 61}),
    ]


def _prefill_case(torch, timer, g, *, label, H, KV, hd, runs, pad, timed,
                  short_rows=None):
    """Paged prefill in bf16 over a packed chunk of ``runs`` (slot, first
    position, rows) and ``pad`` padding rows, 8 slots, bs 16, mb 128,
    against its plain version in float32, with wrong references one key
    and one page short at the longest row (and one key short at each row of
    ``short_rows``) that must fail; padding rows must be 0; timed beside
    its bound, its plain version and SDPA over gathered K/V."""
    from repro_torch.kernels.prefill_attn import ops as pops
    from repro_torch.kernels.prefill_attn.ref import (
        paged_prefill_attention_ref,
    )
    S, bs, mb, n_blocks = 8, 16, 128, 4096
    need = [1] * S
    seg, pos = [], []
    for slot, start, n in runs:
        seg += [slot] * n
        pos += list(range(start, start + n))
        need[slot] = max(need[slot], start + n)
    seg += [-1] * pad
    pos += [0] * pad
    pool_k, pool_v, tables, _ = _pool(
        torch, g, n_blocks=n_blocks, bs=bs, KV=KV, hd=hd, S=S, mb=mb,
        max_len=2048, dtype=torch.bfloat16, lengths=need)
    seg = torch.tensor(seg, dtype=torch.int32, device="cuda")
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    C = seg.shape[0]
    q = torch.randn(C, H, hd, generator=g, device="cuda").to(torch.bfloat16)
    out = pops.paged_prefill_attention_op(q, pool_k, pool_v, tables, seg,
                                          pos)
    q32, k32, v32 = q.float(), pool_k.float(), pool_v.float()

    def pref(p):
        return paged_prefill_attention_ref(q32, k32, v32, tables, seg, p)

    longest = int(torch.argmax(torch.where(seg < 0, -1, pos)))
    wrong = {}
    for name, (row, cut) in dict(
            {"one_key_short": (longest, 1), "one_page_short": (longest, bs)},
            **{k: (r, 1) for k, r in (short_rows or {}).items()}).items():
        p = pos.clone()
        p[row] -= cut
        wrong[name] = pref(p)
    pad_rows = seg < 0
    row_keys = torch.where(pad_rows, 0, pos + 1)
    seg_keys = sum(int(row_keys[seg == s].max())
                   for s in range(S) if bool((seg == s).any()))
    rec = {"phase": "kernel", "name": "paged_prefill_attention",
           "case": label, "dtype": "bfloat16",
           "shape": {"C": C, "H": H, "KV": KV, "hd": hd, "bs": bs, "mb": mb,
                     "pad_rows": pad, "row_keys": int(row_keys.sum())},
           "runs": runs, "splits": _prefill_splits(torch, C, H, KV, mb, bs)}
    _hold(torch, rec, out, pref(pos), TOL["bfloat16"], wrong)
    if bool(out[pad_rows].any()):
        raise AssertionError(f"paged_prefill_attention: padding rows not "
                             f"zero: {rec}")
    if timed:
        nbytes = (2 * 2 * q.numel() + 2 * seg_keys * KV * hd * 2
                  + tables.numel() * 4 + 2 * C * 4)
        row_tables = tables[seg.clamp_min(0).long()]
        rec.update(_times(torch, timer, "bfloat16", nbytes,
                          4 * H * hd * int(row_keys.sum()),
                          lambda: pops.paged_prefill_attention_op(
                              q, pool_k, pool_v, tables, seg, pos),
                          lambda: paged_prefill_attention_ref(
                              q, pool_k, pool_v, tables, seg, pos),
                          _sdpa_dense(torch, q, pool_k, pool_v, row_tables,
                                      row_keys), plain_iters=5))
    return rec


def _prefill_splits(torch, C, H, KV, mb, bs):
    """The paged prefill wrapper's split plan for these sizes (bf16)."""
    from repro_torch.kernels.decode_attn import paged_kernel
    from repro_torch.kernels.prefill_attn import kernel as pk
    n_sm = paged_kernel.sm_count(torch.cuda.current_device())
    pps, n = pk.split_plan(C, H // KV, KV, mb, bs, n_sm)
    return {"pages_per_split": pps, "n_splits": n, "split_keys": pps * bs,
            "n_sm": n_sm}


# flash attention and dense decode at the rollout engine's shapes: 16
# sequences of 1024 positions (the prefill), a cache of 1024 + 32 (decode)
FLASH_SHAPE = dict(B=16, S=1024, H=12, KV=2, hd=128)
DECODE_L = 1056


def _flash_pairs(S, window):
    """(query, key) pairs a causal (windowed) pass attends."""
    if window is None:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def _masked_diagonal_ref(torch, q, k, v):
    """Flash attention that masks the causal diagonal: one key short."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     q.float().reshape(B, KV, H // KV, S, hd), k.float()) \
        * hd ** -0.5
    i = torch.arange(S, device=q.device)
    s = torch.where(i[:, None] > i[None, :], s, -1e30)
    o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, -1), v.float())
    return o.reshape(B, H, S, hd)


def phase_dense_kernels(torch):
    """Flash attention and dense decode (the rollout engine's kernels) on
    bf16 inputs against their plain versions in float32 on the same
    values, each with a wrong reference the tolerance must fail, timed
    beside its bound, its plain version and a library yardstick; dense
    decode also at split and tile boundaries (each record gives the
    wrapper's split plan)."""
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref

    F = torch.nn.functional
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(4)
    results = {}
    tol = TOL["bfloat16"]
    B, H, KV, hd = (FLASH_SHAPE[k] for k in ("B", "H", "KV", "hd"))
    for S, window in ((FLASH_SHAPE["S"], None), (FLASH_SHAPE["S"], 256),
                      (1000, None)):
        # the model's [B,S,heads,hd] activations, viewed as [B,heads,S,hd]
        q, k, v = (torch.randn(B, S, n, hd, generator=g, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2)
                   for n in (H, KV, KV))
        out = fops.flash_attention(q, k, v, window=window)
        q32, k32, v32 = q.float(), k.float(), v.float()
        ref = flash_attention_ref(q32, k32, v32, window=window)
        wrong = {"diagonal_masked": _masked_diagonal_ref(torch, q32, k32,
                                                         v32)}
        del q32, k32, v32
        rec = {"phase": "kernel", "name": "flash_attention",
               "dtype": "bfloat16", "shape": dict(FLASH_SHAPE, S=S,
                                                  window=window)}
        _hold(torch, rec, out, ref, tol, wrong)
        del ref, wrong
        if out.stride() != q.stride():
            raise AssertionError(f"flash output strides {out.stride()}")
        if S == FLASH_SHAPE["S"]:
            # timed at the rollout's S, causal and windowed; SDPA has no
            # window, so it is the yardstick of the causal case only
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            flops = 4 * B * H * hd * _flash_pairs(S, window)
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            rec.update(_times(
                torch, timer, "bfloat16", nbytes, flops,
                lambda: fops.flash_attention(q, k, v, window=window),
                lambda: flash_attention_ref(q, k, v, window=window),
                None if window else lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=True, enable_gqa=True),
                iters=10, plain_iters=3))
            rec["tflop_s"] = flops / (rec["ms"] * 1e-3) / 1e12
            if window is None:
                results["flash_attention"] = rec
        emit(rec)
        del q, k, v, out
    # dense decode over the rollout's cache length, lengths 1 .. L
    rec = _dense_decode_case(torch, timer, g, B=B, H=H, KV=KV, L=DECODE_L)
    results["decode_attention"] = rec
    emit(rec)
    for case in _dense_boundary_cases(torch):
        emit(_dense_decode_case(torch, None, g, **case))
    for G in (12, 48):
        emit(_flash_group_case(torch, timer, g, G))
        emit(_dense_decode_case(torch, timer, g, B=B, H=G, KV=1, L=DECODE_L,
                                label=f"group_{G}"))
    return results


def _flash_group_case(torch, timer, g, G):
    """Flash attention (B 4, S 1024) at a group of G query heads over one
    KV head (command-r-plus's 12, granite-34b's 48), hd 128, bf16, against
    its plain version with the wrong reference of the main shape, timed
    beside bound, plain version and SDPA."""
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    F = torch.nn.functional
    tol = TOL["bfloat16"]
    B, S, hd = 4, FLASH_SHAPE["S"], FLASH_SHAPE["hd"]
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for n in (G, 1, 1))
    out = fops.flash_attention(q, k, v)
    q32, k32, v32 = q.float(), k.float(), v.float()
    rec = {"phase": "kernel", "name": "flash_attention", "case": f"group_{G}",
           "dtype": "bfloat16",
           "shape": {"B": B, "S": S, "H": G, "KV": 1, "hd": hd}}
    _hold(torch, rec, out, flash_attention_ref(q32, k32, v32), tol,
          {"diagonal_masked": _masked_diagonal_ref(torch, q32, k32, v32)})
    del q32, k32, v32
    flops = 4 * B * G * hd * _flash_pairs(S, None)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    rec.update(_times(
        torch, timer, "bfloat16", 2 * (2 * q.numel() + k.numel() + v.numel()),
        flops, lambda: fops.flash_attention(q, k, v),
        lambda: flash_attention_ref(q, k, v),
        lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                               enable_gqa=True),
        iters=10, plain_iters=3))
    rec["tflop_s"] = flops / (rec["ms"] * 1e-3) / 1e12
    return rec


def _dense_splits(torch, B, KV, L, n_sm=None):
    """The dense decode wrapper's split plan for these sizes (bf16)."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn import paged_kernel
    if n_sm is None:
        n_sm = paged_kernel.sm_count(torch.cuda.current_device())
    sk, n = dk.split_plan(B, KV, L, n_sm)
    return {"split_keys": sk, "n_splits": n, "n_sm": n_sm}


def _dense_boundary_cases(torch, n_sm=None):
    """Dense decode at the rollout's heads (B 16, H 12, KV 2) with lengths
    on the wrapper's split boundaries (split length sk), on 16-key tile
    boundaries and one key past them, at L 1056 and at L 1000 (not a
    multiple of the tile: the last tile is cut by the cache's end), with a
    wrong reference one key short at the row one key past a split
    boundary. ``n_sm``: the SM count the boundaries are placed for (the
    card's by default)."""
    cases = []
    for L in (DECODE_L, 1000):
        sk = _dense_splits(torch, 16, 2, L, n_sm)["split_keys"]
        last = (L - 1) // sk * sk  # the first key of the last split
        lengths = [L, sk + 1, sk, sk - 1, 2 * sk + 1, 16, 17, 1, L - 1,
                   last + 1, last, 15, 33, 2 * sk, 3 * sk - 1, L // 2]
        cases.append(dict(B=16, H=12, KV=2, L=L, lengths=lengths,
                          label=f"split_boundaries_L{L}",
                          short_rows={"one_key_short_past_a_split": 1}))
    return cases


def _dense_decode_case(torch, timer, g, *, B, H, KV, L, lengths=None,
                       label=None, short_rows=None):
    """Dense decode in bf16 (hd 128; lengths None: random in 1 .. L with
    rows 0 and 1 at L and 1) against its plain version in float32 on the
    same values within 1e-4 + 1e-2 |ref|, which wrong references must
    fail: lengths - 1 at every row, one key short at the longest row, and
    one key short at each row of ``short_rows``. Timed (``timer`` not
    None) beside its bound, its plain version and SDPA over the cache."""
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    F = torch.nn.functional
    hd = FLASH_SHAPE["hd"]
    kc, vc = (torch.randn(B, L, KV, hd, generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    if lengths is None:
        lengths = torch.randint(1, L + 1, (B,), generator=g,
                                device="cuda").to(torch.int32)
        lengths[0], lengths[1] = L, 1
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(torch.bfloat16)
    out = dops.decode_attention_op(q, kc, vc, lengths)
    launched = dops.DENSE_PLAN  # the split plan the wrapper launched
    q32, k32, v32 = q.float(), kc.float(), vc.float()

    def dref(ls):
        return decode_attention_ref(q32, k32, v32, ls)

    wrong = {"lengths_minus_one": dref(lengths - 1)}
    for name, row in dict({"one_key_short": int(torch.argmax(lengths))},
                          **(short_rows or {})).items():
        ls = lengths.clone()
        ls[row] -= 1
        wrong[name] = dref(ls)
    n_keys = int(lengths.sum())
    rec = {"phase": "kernel", "name": "decode_attention", "dtype": "bfloat16",
           "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "L": L,
                     "keys": n_keys},
           "splits": {"split_keys": launched[0], "n_splits": launched[1]}}
    want = _dense_splits(torch, B, KV, L)
    if (want["split_keys"], want["n_splits"]) != launched:
        # the boundary cases place their lengths on this plan
        raise AssertionError(f"dense decode launched {launched}, "
                             f"planned {want}")
    rec["splits"]["n_sm"] = want["n_sm"]
    if label:
        rec["case"] = label
        rec["lengths"] = lengths.tolist()
    _hold(torch, rec, out, dref(lengths), TOL["bfloat16"], wrong)
    if timer is not None:
        kt = kc.transpose(1, 2).contiguous()
        vt = vc.transpose(1, 2).contiguous()
        mask = (torch.arange(L, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        rec.update(_times(
            torch, timer, "bfloat16",
            2 * (2 * q.numel() + 2 * n_keys * KV * hd) + 4 * B,
            4 * H * hd * n_keys,
            lambda: dops.decode_attention_op(q, kc, vc, lengths),
            lambda: decode_attention_ref(q, kc, vc, lengths),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            iters=50))
    return rec


def _hold(torch, rec, out, ref, tol, wrong_refs):
    """Hold a kernel's ``out`` against its plain version's ``ref``
    (|out - ref| <= atol + rtol * |ref| everywhere), and show the check has
    teeth: against each of ``wrong_refs`` (label -> the plain version of a
    wrong function, e.g. one key short at a row's limit) it must fail."""
    def worst(r):
        err = (out.float() - r).abs()
        return err.max().item(), (
            err / (tol["atol"] + tol["rtol"] * r.abs())).max().item()

    err, ratio = worst(ref)
    rec.update({"max_abs_err": err, "worst_err_over_tol": ratio, "tol": tol,
                "mean_abs_ref": ref.abs().mean().item(),
                "wrong_kernel_err_over_tol": {
                    k: worst(r)[1] for k, r in wrong_refs.items()}})
    if ratio > 1.0 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{rec['name']}: kernel vs plain: {rec}")
    loose = [k for k, r in rec["wrong_kernel_err_over_tol"].items()
             if not r > 1.0]  # NaN too: a wrong reference must fail
    if loose:
        raise AssertionError(f"{rec['name']}: the tolerance passes a kernel "
                             f"{loose}: {rec}")


def _times(torch, timer, dname, nbytes, flops, kernel, plain, library, *,
           iters=20, plain_iters=20):
    """Kernel, plain-version and library times (CUDA events, L2 flushed)
    beside the bound: the larger of the bytes over the memory rate and the
    operations over the peak rate of ``dname``. ``library`` may be None
    (no single PyTorch call computes the function)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    return {"ms": timer.ms(kernel, iters=iters),
            "plain_ms": timer.ms(plain, iters=plain_iters),
            "library_ms": None if library is None else timer.ms(library,
                                                                iters=iters),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# ------------------------------------------------------------------- engine
def _requests(cfg, n=16, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(4, cfg.vocab_size, size=int(rng.integers(64, 1025)))
            .astype(np.int32) for _ in range(n)]


ENGINE_KW = dict(max_seqs=8, block_size=16, n_blocks=4096,
                 max_blocks_per_seq=128, prefill_chunk=256,
                 decode_horizon=8, greedy=True)
MAX_NEW = 32


def _serve(torch, cfg, params, prompts, tracer=None):
    from repro_torch.obs.tracing import install_tracer
    from repro_torch.rollout.continuous import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(cfg, device="cuda", **ENGINE_KW)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    install_tracer(tracer)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(params)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        install_tracer(None)
    return eng, done, elapsed


def _sync_tracer(torch):
    """A SpanTracer whose spans synchronise the device on entry and exit,
    so each span's duration is the device-complete time of its work."""
    from repro_torch.obs.tracing import SpanTracer

    class SyncSpan:
        def __init__(self, inner):
            self.inner = inner

        def __enter__(self):
            torch.cuda.synchronize()
            self.inner.__enter__()
            return self

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            return self.inner.__exit__(*exc)

        def set(self, **attrs):
            self.inner.set(**attrs)

    class SyncTracer(SpanTracer):
        def span(self, name, **attrs):
            return SyncSpan(super().span(name, **attrs))

    return SyncTracer("chip_smoke")


def _reference_checks(torch, M, cfg, params, reqs, gap_tol, logp_tol):
    """Teacher-force each request's prompt + generated tokens through the
    whole-sequence forward_logits; every recorded greedy token must be
    within ``gap_tol`` of the reference's best log-prob at its step and its
    recorded logp within ``logp_tol`` of the reference's. The set as a
    whole must clear the MIN_/MAX_ floors, which a degenerate output fails.
    Returns a summary and the worst request."""
    import numpy as np
    checks = []
    for r in reqs:
        P, n = len(r.prompt), len(r.generated)
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1])])
        toks = torch.as_tensor(seq[None].astype(np.int64), device="cuda")
        logits = M.forward_logits(params, cfg, toks)[0, P - 1: P - 1 + n]
        lp = torch.log_softmax(logits, dim=-1)
        gen = torch.as_tensor(r.generated, device="cuda")
        ref_lp = lp.gather(-1, gen[:, None])[:, 0]
        gap = (lp.max(dim=-1).values - ref_lp).max().item()
        dlogp = (ref_lp.cpu() - torch.tensor(r.gen_logp)).abs().max().item()
        checks.append({"rid": r.rid, "prompt": P, "generated": n,
                       "argmax_agree": int((lp.argmax(dim=-1) == gen).sum()),
                       "distinct_tokens": len(set(r.generated)),
                       "logp_sum": float(np.sum(r.gen_logp)),
                       "max_gap_to_best_logp": gap,
                       "max_abs_logp_err": dlogp})
        if gap > gap_tol or dlogp > logp_tol:
            raise AssertionError(f"engine vs forward_logits: {checks[-1]}")
    n_tok = sum(c["generated"] for c in checks)
    summary = {
        "requests": len(checks), "tokens": n_tok,
        "argmax_agree_share": sum(c["argmax_agree"] for c in checks) / n_tok,
        "distinct_per_request": sum(c["distinct_tokens"] for c in checks)
        / len(checks),
        "mean_logp": sum(c["logp_sum"] for c in checks) / n_tok,
        "max_gap_to_best_logp": max(c["max_gap_to_best_logp"]
                                    for c in checks),
        "max_abs_logp_err": max(c["max_abs_logp_err"] for c in checks),
        "worst": max(checks, key=lambda c: c["max_abs_logp_err"]),
        "tol": {"gap": gap_tol, "logp": logp_tol,
                "min_argmax_agree_share": MIN_ARGMAX_AGREE,
                "min_distinct_per_request": MIN_DISTINCT_PER_REQUEST,
                "max_mean_logp": MAX_MEAN_LOGP}}
    if (summary["argmax_agree_share"] < MIN_ARGMAX_AGREE
            or summary["distinct_per_request"] < MIN_DISTINCT_PER_REQUEST
            or summary["mean_logp"] > MAX_MEAN_LOGP):
        raise AssertionError(f"degenerate engine output: {summary}")
    return summary


def _scale_blocks(torch, params, factor, only=None):
    """Scale the layer weights (not the norms) in place; with ``only``,
    just the blocks' parts it names (e.g. ``("ffn",)``)."""
    from repro_torch.models.params import walk
    for path, t in walk(params["blocks"]):
        if path[0] not in ("ln1", "ln2") and (only is None
                                              or path[0] in only):
            t.mul_(factor)


def _check_served(eng, done, prompts):
    import numpy as np
    if len(done) != len(prompts):
        raise AssertionError(f"{len(done)} of {len(prompts)} finished")
    for r in done:
        if not (len(r.generated) == MAX_NEW or r.generated[-1] == 2):
            raise AssertionError(f"request {r.rid} incomplete")
        if not np.all(np.isfinite(r.gen_logp)):
            raise AssertionError(f"request {r.rid}: non-finite logp")
    if eng.allocator.n_free != ENGINE_KW["n_blocks"] - 1:
        raise AssertionError(f"pool not drained: {eng.allocator.n_free}")


def phase_engine(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.prefill_attn import ops as pops
    from repro_torch.models import model as M
    from repro_torch.obs.tracing import phase_breakdown

    cfg = get_config("qwen2.5-1.5b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.bfloat16)
    _scale_blocks(torch, params, SCALE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _requests(cfg)
    # warm-up: library handles and kernel modules load outside the timing
    _serve(torch, cfg, params, prompts[:2])

    dops.LAUNCHES = 0
    pops.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    eng, done, elapsed = _serve(torch, cfg, params, prompts)
    launches = {"paged_decode_attention": dops.LAUNCHES,
                "paged_prefill_attention": pops.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    _check_served(eng, done, prompts)
    # whole-sequence reference for every request of the run (16 requests
    # through 8 slots, so every slot is reused)
    checks = _reference_checks(torch, M, cfg, params, done, ENGINE_GAP_TOL,
                               ENGINE_LOGP_TOL)

    n_gen = sum(len(r.generated) for r in done)
    n_prompt = sum(len(r.prompt) for r in done)
    emit({"phase": "engine", "model": cfg.name, "layers": cfg.num_layers,
          "dtype": "bfloat16", "layer_weight_scale": SCALE,
          "engine": ENGINE_KW, "max_new": MAX_NEW,
          "requests": len(done), "prompt_tokens": n_prompt,
          "generated_tokens": n_gen, "elapsed_s": elapsed,
          "tokens_per_s": n_gen / elapsed,
          "prefill_chunks": eng.prefill_launches,
          "decode_launches": eng.decode_launches,
          "host_syncs": eng.host_syncs, "launches": launches,
          "init_params_s": init_s, "peak_mem_gb": peak_gb,
          "reference_checks": checks})
    del eng

    # the same requests in float32 (engine, kernels and reference), where
    # only summation order differs from the reference
    params.to(torch.float32)  # exact both ways for bf16 values
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    eng32, done32, _ = _serve(torch, cfg32, params, prompts)
    _check_served(eng32, done32, prompts)
    del eng32
    emit({"phase": "engine_float32",
          "reference_checks": _reference_checks(
              torch, M, cfg32, params, done32, F32_TOL, F32_TOL)})
    params.to(torch.bfloat16)

    # traced run of the same requests: device-complete time per phase
    tracer = _sync_tracer(torch)
    _, done3, elapsed2 = _serve(torch, cfg, params, prompts, tracer=tracer)
    br = phase_breakdown(tracer.events())
    pre, dec = br.get("prefill", {}), br.get("decode", {})
    same = all(a.generated == b.generated for a, b in zip(
        sorted(done, key=lambda r: r.rid), sorted(done3, key=lambda r: r.rid)))
    emit({"phase": "engine_traced", "elapsed_s": elapsed2,
          "prefill_s": pre.get("total_s"), "prefill_chunks": pre.get("count"),
          "prefill_tokens_per_s": n_prompt / pre["total_s"],
          "decode_s": dec.get("total_s"), "decode_horizons": dec.get("count"),
          "decode_tokens_per_s": n_gen / dec["total_s"],
          "same_tokens_as_untraced": same})
    if not same:
        raise AssertionError("traced run generated other tokens")
    phase_profile(torch, cfg, params, prompts[:8])
    return launches


def _device_profile(torch, run, cross_check=False):
    """torch.profiler over ``run()`` (which returns its wall seconds):
    device time by kernel name and the device's idle share of the wall
    time, the twelve largest names and every kernel of the port's own (a
    ``__global__`` function of ``kernels/csrc``). Only events that ran on
    the device count (the CPU ops that launched them carry the same time
    again), and busy time is the union of their intervals. The device
    events are read from the profiler's raw results: building
    ``prof.events()`` (every CPU op's FunctionEvent and the op tree) takes
    ~0.25 ms an event on the card's host, tens of seconds for a step.
    A program span's device-side range (a ``record_function`` while the
    profiler records) is no operation and does not count.
    ``cross_check`` builds it all the same and fails unless its device
    events give the same names, counts and sums (``cross_check`` in the
    result: the events compared and the seconds the check took)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        elapsed = run()
    # integer ns since the epoch: in float64 microseconds they would
    # round to 0.25 us
    spans, by_ns = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA \
                or getattr(ev, "is_hidden_event", lambda: False)() \
                or ev.is_user_annotation():
            continue
        t0, t1 = ev.start_ns(), ev.end_ns()
        spans.append((t0, t1))
        ns, n = by_ns.get(ev.name(), (0, 0))
        by_ns[ev.name()] = (ns + (t1 - t0), n + 1)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    by_name = {k: (ns / 1e3, n) for k, (ns, n) in by_ns.items()}
    checked = None
    if cross_check:
        t_check = time.perf_counter()
        old = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA \
                    and not getattr(ev, "is_user_annotation", False):
                us, n = old.get(ev.name, (0.0, 0))
                old[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
        differ = sorted(k for k in set(old) | set(by_name)
                        if k not in old or k not in by_name
                        or old[k][1] != by_name[k][1]
                        or abs(old[k][0] - by_name[k][0])
                        > 1e-6 * max(1.0, old[k][0]))
        checked = {"events": len(spans), "names": len(by_name),
                   "seconds": time.perf_counter() - t_check}
        if differ:
            raise AssertionError(
                f"raw device events and prof.events() differ on "
                f"{len(differ)} names: " + "; ".join(
                    f"{k[:60]}: {old.get(k)} vs {by_name.get(k)}"
                    for k in differ[:5]))
    spans.sort()
    busy_ns, end = 0, spans[0][0]
    for t0, t1 in spans:
        if t1 > end:
            busy_ns += t1 - max(t0, end)
            end = t1
    busy_us = busy_ns / 1e3
    rows = sorted(((us, k, n) for k, (us, n) in by_name.items()),
                  reverse=True)
    return {"wall_s": elapsed, "device_busy_s": busy_us / 1e6,
            "device_kernel_sum_s": sum(us for us, _, _ in rows) / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / elapsed,
            "top_device_kernels": [
                {"name": k[:90], "device_ms": us / 1e3, "calls": n,
                 "share_of_busy": us / busy_us}
                for us, k, n in rows[:12]],
            "port_kernels": [
                {"name": k[:90], "device_ms": us / 1e3, "calls": n}
                for us, k, n in rows if _is_port_kernel(k)],
            "cross_check": checked}


@functools.lru_cache(maxsize=None)
def _port_kernel_names():
    """The ``__global__`` functions of the port's CUDA sources."""
    from repro_torch.kernels import _build
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    return frozenset(m for path in _build.sources().values()
                     for m in pat.findall(path.read_text()))


def _is_port_kernel(name):
    """Whether a profiled kernel name is one of the port's kernels (they
    all live in their sources' anonymous namespaces)."""
    return any(re.search(rf"\(anonymous namespace\)::(\w+::)?{k}[<(]", name)
               for k in _port_kernel_names())


def phase_profile(torch, cfg, params, prompts):
    """The device profile of a short run of the same engine."""
    done = []

    def run():
        _, d, elapsed = _serve(torch, cfg, params, prompts)
        done.extend(d)
        return elapsed
    prof = _device_profile(torch, run)
    emit(dict({"phase": "engine_profile", "requests": len(done)}, **prof))


# ---------------------------------------------------------- training kernels
def _all_counts():
    """Every kernel's launch counter, by kernel name."""
    from repro_torch.kernels.a3po_loss import ops as aops
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.logprob import ops as lops
    from repro_torch.kernels.prefill_attn import ops as pops
    from repro_torch.kernels.ssd import ops as sops
    return {"paged_decode_attention": dops.LAUNCHES,
            "paged_prefill_attention": pops.LAUNCHES,
            "a3po_loss": aops.LAUNCHES["forward"],
            "a3po_loss_bwd": aops.LAUNCHES["backward"],
            "token_logprob_entropy": lops.LAUNCHES["forward"],
            "token_logprob_entropy_wgmma": lops.LAUNCHES["forward_wgmma"],
            "token_logprob_entropy_bwd": lops.LAUNCHES["backward"],
            "token_logprob_entropy_bwd_wgmma": lops.LAUNCHES[
                "backward_wgmma"],
            "flash_attention": fops.LAUNCHES,
            "decode_attention": dops.DENSE_LAUNCHES,
            "ssd_decode_step": sops.LAUNCHES["ssd_decode_step"],
            "ssd_intra_chunk": sops.LAUNCHES["ssd_intra_chunk"]}


def _reset_counts():
    from repro_torch.kernels.a3po_loss import ops as aops
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.logprob import ops as lops
    from repro_torch.kernels.prefill_attn import ops as pops
    from repro_torch.kernels.ssd import ops as sops
    dops.LAUNCHES = 0
    dops.DENSE_LAUNCHES = 0
    pops.LAUNCHES = 0
    fops.LAUNCHES = 0
    for d in (aops.LAUNCHES, lops.LAUNCHES, sops.LAUNCHES):
        for k in d:
            d[k] = 0


def _a3po_inputs(torch, g, T):
    """Tokens where the clip is active on both sides, the iw cap is active
    and the mask is partial."""
    def u():
        return torch.rand(T, generator=g, device="cuda")
    lp, bl = -u() * 3, -u() * 3
    al = torch.where(u() < 0.2, 0.0, u())
    adv = torch.randn(T, generator=g, device="cuda")
    mask = (u() > 0.3).float()
    return lp, bl, al, adv, mask


def _rel_check(torch, name, outs, refs, exact=()):
    """|out - ref| <= A3PO_RTOL |ref| everywhere (exactly equal where ref is
    0), and the outputs named in ``exact`` bit for bit."""
    worst = 0.0
    for k, (o, r) in enumerate(zip(outs, refs)):
        err = (o - r).abs()
        if not bool((err <= A3PO_RTOL * r.abs()).all()):
            raise AssertionError(f"{name}: output {k} off by "
                                 f"{err.max().item()}")
        worst = max(worst, err.max().item())
        if k in exact and not torch.equal(o, r):
            raise AssertionError(f"{name}: output {k} not exact")
    return worst


def _a3po_case(torch, g, T, case):
    """The reduced op's operands [logp, behav, alpha, adv, mask, entropy]
    at T for one of ``A3PO_CASES``, and its keywords."""
    kl_coef, entropy_coef, iw_cap, shift = A3PO_CASES[case]
    lp, bl, al, adv, mask = _a3po_inputs(torch, g, T)
    bl = torch.where(mask > 0, bl, bl + shift)
    ent = torch.rand(T, generator=g, device="cuda") * 5
    return [lp, bl, al, adv, mask, ent], dict(
        clip_eps=0.2, iw_cap=iw_cap, kl_coef=kl_coef,
        entropy_coef=entropy_coef)


def _bits(torch, t):
    return t.contiguous().reshape(-1).view(torch.int32)


def _hold_a3po_reduced(torch, args, kw, wrong=()):
    """Hold the reduced forward and backward kernels against their plain
    versions on ``args``: c bit for bit, the loss and metric vector within
    ``A3PO_SUM_RTOL`` of their sums' size (exact where that is 0), two
    launches bit-equal, the backward within ``A3PO_RTOL``; and each named
    wrong reference (``last_block_dropped``: the tokens of the last
    block's last pass left out; ``iw_max_over_masked_out``: the iw maximum
    over every token; ``divides_by_t``: the means over T, not the mask's
    sum) must fail the tolerance. Returns the record."""
    from repro_torch.kernels.a3po_loss import kernel as akernel
    from repro_torch.kernels.a3po_loss import ops as aops
    from repro_torch.kernels.a3po_loss.ref import (
        REDUCED_KEYS,
        a3po_loss_ref,
        a3po_reduced_bwd_ref,
        a3po_reduced_ref,
        a3po_reduced_scale,
    )
    loss, metrics, coef = aops._reduced_forward_kernel(*args, **kw)
    out = torch.cat([loss[None], metrics])

    def ref_of(a):
        r_loss, r_metrics, r_coef = a3po_reduced_ref(*a, **kw)
        return torch.cat([r_loss[None], r_metrics]), r_coef

    ref, r_coef = ref_of(args)
    scale = torch.cat([t.reshape(-1) for t in a3po_reduced_scale(*args,
                                                                 **kw)])

    def over(r):
        """worst |out - r| over A3PO_SUM_RTOL x scale (NaN on both sides
        agrees; any error where the scale is 0 is inf)."""
        err = (out - r).abs()
        err = torch.where(torch.isnan(out) & torch.isnan(r), 0.0, err)
        ratio = torch.where(err == 0, 0.0, err / (A3PO_SUM_RTOL * scale))
        return ratio.max().item()

    T = args[0].numel()
    worst = over(ref)
    keys = ("loss",) + REDUCED_KEYS
    fin = torch.isfinite(ref) & torch.isfinite(out)
    rec = {"T": T, "entropy": args[5] is not None, **kw,
           "blocks": akernel.reduced_blocks(
               T, torch.cuda.get_device_properties(0).multi_processor_count),
           "max_abs_err": (out - ref)[fin].abs().max().item(),
           "worst_err_over_tol": worst,
           "values": dict(zip(keys, out.tolist())),
           "tol": {"sum_rtol": A3PO_SUM_RTOL,
                   "exact": ["coef", "iw_max", "iw_min", "clipped_tokens"]}}
    if not worst <= 1.0 or not torch.equal(coef, r_coef):
        raise AssertionError(f"a3po reduced forward vs plain: {rec} "
                             f"{dict(zip(keys, (out - ref).tolist()))}")
    wrongs = {}
    for name in wrong:
        if name == "last_block_dropped":
            block, pas = akernel.reduced_walk(T, rec["blocks"])
            last = block == rec["blocks"] - 1
            last &= pas == pas[last].max()
            a = list(args)
            a[4] = torch.where(last.to(a[4].device), 0.0, a[4])
            wrongs[name] = ref_of(a)[0]
        elif name == "iw_max_over_masked_out":
            r = ref.clone()
            r[1 + REDUCED_KEYS.index("iw_max")] = a3po_loss_ref(
                *args[:5], clip_eps=kw["clip_eps"],
                iw_cap=kw["iw_cap"])[2].max()
            wrongs[name] = r
        elif name == "divides_by_t":
            r = ref.clone()
            fac = ref[1 + REDUCED_KEYS.index("denom")] / T
            for k in ("loss", "iw_mean", "ratio_mean", "clipped_frac", "kl",
                      "entropy"):
                r[keys.index(k)] *= fac
            wrongs[name] = r
    rec["wrong_kernel_err_over_tol"] = {k: over(r) for k, r in wrongs.items()}
    loose = [k for k, v in rec["wrong_kernel_err_over_tol"].items()
             if not v > 1.0]
    if loose:
        raise AssertionError(f"a3po reduced: the tolerance passes a kernel "
                             f"{loose}: {rec}")
    again = aops._reduced_forward_kernel(*args, **kw)
    rec["bit_equal_twice"] = all(
        torch.equal(_bits(torch, a), _bits(torch, b)) for a, b in zip(
            (loss, metrics, coef), again))
    if not rec["bit_equal_twice"]:
        raise AssertionError(f"a3po reduced: two launches differ: {rec}")
    g = torch.randn((), device="cuda") * 2
    bkw = dict(kl_coef=kw["kl_coef"], entropy_coef=kw["entropy_coef"],
               with_entropy=args[5] is not None)
    g_logp, g_ent = aops._reduced_backward_kernel(g.reshape(1), metrics,
                                                  coef, args[4], **bkw)
    r_logp, r_ent = a3po_reduced_bwd_ref(
        g, ref[1 + REDUCED_KEYS.index("denom")], r_coef, args[4], **bkw)
    outs, refs = [g_logp], [r_logp]
    if r_ent is not None:
        outs.append(g_ent)
        refs.append(r_ent)
    rec["bwd_max_abs_err"] = _rel_check(torch, "a3po_loss_bwd", outs, refs)
    rec["bwd_bit_exact"] = all(torch.equal(o, r) for o, r in zip(outs,
                                                                 refs))
    return rec, (loss, metrics, coef, g)


def _parent_a3po_loss(torch, logp, behav_logp, alpha, adv, mask, cfg,
                      entropy):
    """The A-3PO loss as the parent commit ran it: the per-token kernel
    (``a3po_objective``), then each masked reduction and the regularizers
    as eager ops. Timed and profiled beside the reduced op, never on the
    path."""
    from repro_torch.core import objective
    from repro_torch.kernels.a3po_loss import ops as aops
    logp = logp.float()
    behav_logp = behav_logp.float()
    if alpha.dim() == logp.dim() - 1:
        alpha = alpha[..., None]
    alpha = torch.broadcast_to(alpha, logp.shape).float().detach()
    loss_tok, clip_tok, iw, ratio = aops.a3po_objective(
        logp, behav_logp, alpha, adv, mask, clip_eps=cfg.clip_eps,
        iw_cap=cfg.behav_weight_cap)
    denom = torch.clamp_min(mask.sum(), 1.0)
    metrics = {
        "iw_max": objective._masked_max(iw, mask),
        "iw_min": objective._masked_min(iw, mask),
        "iw_mean": objective.masked_mean(iw, mask),
        "ratio_mean": objective.masked_mean(ratio, mask),
        "clipped_tokens": clip_tok.sum(),
        "clipped_frac": clip_tok.sum() / denom,
    }
    if entropy is not None:
        metrics["entropy"] = objective.masked_mean(entropy, mask)
    anchor = alpha * behav_logp + (1.0 - alpha) * logp
    return objective.apply_regularizers(loss_tok.sum() / denom, metrics,
                                        logp, anchor, mask, cfg, entropy)


def _a3po_reduced_kernels(torch, timer, g):
    """The reduced A-3PO kernels: held at every T of ``A3PO_TS`` in every
    case of ``A3PO_CASES`` with the wrong references that must fail, and
    timed in the path's case at each T beside their bounds, their plain
    versions and, as "before", the parent's path on the same inputs (the
    per-token kernel, then eager reductions; its backward through
    autograd) against the new op's (``fused_a3po_loss`` forward, then
    autograd's backward); beside an empty kernel's launch (the floor), one
    PyTorch reduction over the forward's bytes (``stream_ms``) and the
    grids a cluster or another plan would take. Returns the kernels
    line's two records (T 2300)."""
    from repro_torch.configs.base import RLConfig
    from repro_torch.core import objective
    from repro_torch.kernels.a3po_loss import kernel as akernel
    from repro_torch.kernels.a3po_loss import ops as aops
    from repro_torch.kernels.a3po_loss.ref import (
        a3po_reduced_bwd_ref,
        a3po_reduced_ref,
    )
    stream = torch.cuda.current_stream().cuda_stream
    floor = timer.ms(lambda: akernel.empty_launch_fn()(stream), iters=50)
    emit({"phase": "kernel", "name": "launch_floor", "ms": floor,
          "what": "an empty kernel <<<1, 32>>> under Timer"})
    results = {}
    wrong = {"path": ("last_block_dropped", "divides_by_t"),
             "regularized": ("last_block_dropped", "divides_by_t"),
             "uncapped": ("iw_max_over_masked_out", "last_block_dropped",
                          "divides_by_t")}
    for T in A3PO_TS:
        for case in A3PO_CASES:
            args, kw = _a3po_case(torch, g, T, case)
            rec, (loss, metrics, coef, gs) = _hold_a3po_reduced(
                torch, args, kw, wrong[case])
            rec = dict({"phase": "kernel", "name": "a3po_loss_reduced",
                        "case": case}, **rec)
            if case != "path":
                emit(rec)
                continue
            ent = args[5] is not None
            bkw = dict(kl_coef=0.0, entropy_coef=0.0, with_entropy=ent)
            fwd = _times(
                torch, timer, "float32", (24 + 4 * ent) * T + 4 * 10,
                A3PO_FWD_OPS * T,
                lambda: aops._reduced_forward_kernel(*args, **kw),
                lambda: a3po_reduced_ref(*args, **kw), None)
            bwd = _times(
                torch, timer, "float32", 8 * T + 4 * 2, A3PO_BWD_OPS * T,
                lambda: aops._reduced_backward_kernel(
                    gs.reshape(1), metrics, coef, args[4], **bkw),
                lambda: a3po_reduced_bwd_ref(gs, metrics[aops.DENOM], coef,
                                             args[4], **bkw), None)
            # the objective end to end, the parent's path and the new op's
            cfg = RLConfig()
            paths = {}
            for label, fn in (("parent", functools.partial(
                    _parent_a3po_loss, torch)), ("reduced", lambda *a: (
                        objective.fused_a3po_loss(*a)))):
                x = args[0].clone().requires_grad_(True)
                loss_p, _ = fn(x, *args[1:5], cfg, args[5])
                paths[label] = {
                    "fwd_ms": timer.ms(lambda: fn(x, *args[1:5], cfg,
                                                  args[5])),
                    "bwd_ms": timer.ms(lambda: torch.autograd.grad(
                        loss_p, x, retain_graph=True))}
            # one PyTorch reduction that streams the forward's bytes (a
            # yardstick of the card's streaming rate under this timer)
            buf = torch.empty(fwd["bytes"] // 4, device="cuda")
            fwd["stream_ms"] = timer.ms(lambda: buf.sum())
            del buf
            rec.update(fwd=fwd, bwd=bwd, paths=paths, launch_floor_ms=floor)
            if T in (TRAIN_T, 2 ** 20):
                rec["plan_alternatives_ms"] = {
                    b: timer.ms(lambda: aops._reduced_forward_kernel(
                        *args, **kw, blocks=b))
                    for b in ((1, 2, 4) if T == TRAIN_T
                              else (8, 132, 256, 528))}
            emit(rec)
            if T == TRAIN_T:
                shape = {"T": T, "entropy": ent}
                for name, t, err in (("a3po_loss", fwd, rec["max_abs_err"]),
                                     ("a3po_loss_bwd", bwd,
                                      rec["bwd_max_abs_err"])):
                    side = "fwd" if name == "a3po_loss" else "bwd"
                    results[name] = dict(
                        {k: v for k, v in t.items() if k != "stream_ms"},
                        max_abs_err=err, shape=shape,
                        launch_floor_ms=floor,
                        parent_path_ms=paths["parent"][side + "_ms"],
                        path_ms=paths["reduced"][side + "_ms"])
    return results


def phase_training_kernels(torch):
    from repro_torch.kernels.a3po_loss import ops as aops
    from repro_torch.kernels.a3po_loss.ref import (
        a3po_loss_bwd_ref,
        a3po_loss_ref,
    )
    from repro_torch.kernels.logprob import ops as lops
    from repro_torch.kernels.logprob.ref import (
        token_logprob_entropy_bwd_ref,
        token_logprob_entropy_ref,
    )

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    results = _a3po_reduced_kernels(torch, timer, g)
    # ---- the per-token kernels of the Pallas kernel's own function,
    # forward and backward (off the training path; at T 2300 timed beside
    # the reduced kernels, the parent's path ran them)
    for T in (TRAIN_T, 1001):
        args = _a3po_inputs(torch, g, T)
        adv, mask = args[3], args[4]
        outs = aops.a3po_loss_fused(*args)
        refs = a3po_loss_ref(*args, clip_eps=0.2, iw_cap=5.0)
        _, clip, iw, ratio = refs
        cover = {"clip_high": int(((clip > 0) & (adv > 0)).sum()),
                 "clip_low": int(((clip > 0) & (adv < 0)).sum()),
                 "iw_capped": int((iw == 5.0).sum()),
                 "masked_out": int((mask == 0).sum())}
        if min(cover.values()) <= 0:
            raise AssertionError(f"a3po inputs do not cover {cover}")
        err_f = _rel_check(torch, "a3po_loss", outs, refs, exact=(1,))
        x = args[0].clone().requires_grad_(True)
        gl = torch.randn(T, generator=g, device="cuda")
        aops.a3po_objective(x, *args[1:])[0].backward(gl)
        ref_g = a3po_loss_bwd_ref(gl, clip, iw, ratio, adv, mask)
        err_b = _rel_check(torch, "a3po_loss_bwd", [x.grad], [ref_g])
        rec = {"phase": "kernel", "name": "a3po_loss_per_token", "T": T,
               "cover": cover, "max_abs_err": err_f,
               "bwd_max_abs_err": err_b, "tol": {"rtol": A3PO_RTOL},
               "clip_tok_exact": True}
        if T == TRAIN_T:
            rec["fwd"] = _times(
                torch, timer, "float32", 9 * 4 * T, 0,
                lambda: aops.a3po_loss_fused(*args),
                lambda: a3po_loss_ref(*args, clip_eps=0.2, iw_cap=5.0),
                None)
            rec["bwd"] = _times(
                torch, timer, "float32", 7 * 4 * T, 0,
                lambda: aops._backward_kernel(gl, clip, iw, ratio, adv,
                                              mask),
                lambda: a3po_loss_bwd_ref(gl, clip, iw, ratio, adv, mask),
                None)
        emit(rec)

    # ---- token logprob + entropy forward, at the step's shapes (bf16) and
    # at an odd vocabulary in float32
    d, V = 1536, 151936
    for dname, T, Vc in (("bfloat16", TRAIN_T, V), ("float32", 300, 1000)):
        dtype = getattr(torch, dname)
        h = torch.randn(T, d, generator=g, device="cuda").to(dtype)
        emb = (torch.randn(Vc, d, generator=g, device="cuda")
               * d ** -0.5).to(dtype)
        w = emb.T  # the tied head: a transposed view, read in place
        t = torch.randint(0, Vc, (T,), generator=g, device="cuda")
        with torch.no_grad():
            lp, en = lops.token_logprob_entropy(h, w, t)
            h32, w32 = h.float(), w.float()
            lp_r, en_r = token_logprob_entropy_ref(h32, w32, t)
            # a reference one vocab tile short (the last, partial one at
            # V = 1000) must fail the tolerance
            keep = (Vc - 1) // 128 * 128
            lp_w, en_w = token_logprob_entropy_ref(h32, w32[:, :keep],
                                                   t.clamp(max=keep - 1))
        rec = {"phase": "kernel", "name": "token_logprob_entropy",
               "dtype": dname, "shape": {"T": T, "d": d, "V": Vc},
               "forward_kernel": "wgmma" if lops.takes_wgmma(h, w)
               else "wmma/fma"}
        sub = {}
        for label, out, ref, wrong in (("logp", lp, lp_r, lp_w),
                                       ("entropy", en, en_r, en_w)):
            sub[label] = {"name": f"token_logprob_entropy.{label}"}
            _hold(torch, sub[label], out, ref, LOGPROB_TOL,
                  {"last_vocab_tile_dropped": wrong})
        rec.update(sub)
        rec["max_abs_err"] = max(v["max_abs_err"] for v in sub.values())
        if dname == "bfloat16":
            nbytes = (T * d * 2 + d * V * 2 + T * 4 + 4 * T * 4)
            flops = 2 * T * d * V

            def plain():
                return token_logprob_entropy_ref(h.float(), w.float(), t)
            with torch.no_grad():
                rec.update(_times(
                    torch, timer, dname, nbytes, flops,
                    lambda: lops.token_logprob_entropy(h, w, t), plain,
                    lambda: torch.mm(h, w, out_dtype=torch.float32),
                    iters=10, plain_iters=3))
            results["token_logprob_entropy"] = rec
            main = (h, emb, t)
        emit(rec)

    # ---- backward at the step's shapes (T 2300: chunks of 1024, 1024 and
    # 252): dh, dw of the kernel path against the plain float32 backward on
    # the same h, w, logz, mu and cotangents, with a wrong reference (the
    # entropy's cotangent dropped) that must fail. Then through autograd at
    # T 512 (one chunk) against autograd of the plain version; the
    # cotangent kernel's dl against its plain version; dh, dw from dl's
    # bf16 high parts alone, recorded beside
    h, emb, t = main
    w = emb.T
    t32 = t.to(torch.int32)
    rtol = LOGPROB_BWD_RTOL["bfloat16"]
    rec = {"phase": "kernel", "name": "token_logprob_entropy_bwd",
           "dtype": "bfloat16", "shape": {"T": TRAIN_T, "d": d, "V": V},
           "backward_kernel": "wgmma" if lops.takes_wgmma(h, w)
           else "wmma/fma"}
    with torch.no_grad():
        _, _, logz, mu = lops._forward_kernel(h, w, t32)
        gl, ge = torch.randn(2, TRAIN_T, generator=g, device="cuda")
        c0 = dict(lops.LAUNCHES)
        dh, dw = lops._backward_kernel(h, w, t32, logz, mu, gl, ge, True,
                                       True)
        rec["chunks"] = {k: lops.LAUNCHES[k] - c0[k]
                         for k in ("backward", "backward_wgmma")}
        if rec["chunks"]["backward_wgmma"] != -(-TRAIN_T // lops.CHUNK):
            raise AssertionError(f"logprob backward chunks: {rec}")
        h32, w32 = h.float(), w.float()
        ref = token_logprob_entropy_bwd_ref(h32, w32, t32, logz, mu, gl, ge)
        bad = token_logprob_entropy_bwd_ref(h32, w32, t32, logz, mu, gl,
                                            None)
        del h32, w32
    for label, out, r, wr in (("dh", dh, ref[0], bad[0]),
                              ("dw", dw, ref[1], bad[1])):
        sub = {"name": f"token_logprob_entropy_bwd.{label}"}
        _hold(torch, sub, out, r,
              {"rtol": rtol, "atol": 1e-5 * r.abs().max().item()},
              {"entropy_cotangent_dropped": wr})
        rec[label] = sub
    rec["max_abs_err"] = max(rec[k]["max_abs_err"] for k in ("dh", "dw"))
    del dh, dw, ref, bad
    n = 512
    gn, gen = torch.randn(2, n, generator=g, device="cuda")
    hk = h[:n].clone().requires_grad_(True)
    ek = emb.clone().requires_grad_(True)
    lpk, enk = lops.token_logprob_entropy(hk, ek.T, t[:n])
    ((lpk * gn).sum() + (enk * gen).sum()).backward()
    refs, wrong = _logprob_grads(torch, h[:n].float(), emb.float(), t[:n],
                                 gn, gen)
    auto = {"T": n}
    for label, out in (("dh", hk.grad), ("dw", ek.grad)):
        r = refs[label]
        sub = {"name": f"token_logprob_entropy_bwd.autograd.{label}"}
        _hold(torch, sub, out, r,
              {"rtol": rtol, "atol": 1e-5 * r.abs().max().item()},
              {"entropy_cotangent_dropped": wrong[label]})
        auto[label] = sub
    rec["autograd"] = auto
    rec.update(_dl_parts_check(torch, h[:n], emb, t[:n], gn, gen, refs,
                               rtol))
    del hk, ek, lpk, enk, refs, wrong
    # timed on the same inputs. The work is three products of 2 T d V
    # flops (the kernel's logit recompute, dh, dw): the bound takes them at
    # the tensor-core rate, against the bytes of h, w, the five [T] float32
    # inputs (targets, logz, mu and the two cotangents) and the outputs dh,
    # dw
    with torch.no_grad():
        flops = 3 * 2 * TRAIN_T * d * V
        nbytes = (TRAIN_T * d * 2 + d * V * 2 + TRAIN_T * 4 * 5
                  + TRAIN_T * d * 2 + d * V * 2)

        def kernel():
            return lops._backward_kernel(h, w, t32, logz, mu, gl, ge, True,
                                         True)
        times = _times(
            torch, timer, "bfloat16", nbytes, flops, kernel,
            lambda: token_logprob_entropy_bwd_ref(h, w, t32, logz, mu, gl,
                                                  ge),
            None, iters=5, plain_iters=2)
        # device memory the call takes above its inputs, at its peak
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernel()
        torch.cuda.synchronize()
        times["peak_mem_gb_above_inputs"] = (
            torch.cuda.max_memory_allocated() - base) / 1e9
    rec.update(times)
    results["token_logprob_entropy_bwd"] = rec
    emit(rec)
    return results


def _logprob_grads(torch, h32, e32, t, gl, ge):
    """(dh, dw) of the plain token logprob + entropy in float32 (w = e32.T,
    the tied head) under cotangents (gl, ge), by autograd, and the same
    with the entropy's cotangent dropped (a backward that ignored it)."""
    from repro_torch.kernels.logprob.ref import token_logprob_entropy_ref
    out = []
    for g_ent in (ge, torch.zeros_like(ge)):
        hh = h32.clone().requires_grad_(True)
        ee = e32.clone().requires_grad_(True)
        lp, en = token_logprob_entropy_ref(hh, ee.T, t)
        ((lp * gl).sum() + (en * g_ent).sum()).backward()
        out.append({"dh": hh.grad, "dw": ee.grad})
    return out


def _dl_parts_check(torch, h, emb, t, gl, ge, refs, rtol):
    """The wgmma cotangent kernel's dl (bf16 high parts and remainders)
    against its plain version, the float32 dl of the plain logits split by
    ``split_hi_lo``, held within 1e-4 max|dl| as the value the parts carry
    (the logits differ by float32 summation order); then dh and dw from the
    high parts alone, held to the backward's tolerance but only recorded
    (the route keeps both parts)."""
    from repro_torch.kernels.logprob import ops as lops
    from repro_torch.kernels.logprob.ref import dlogits_ref, split_hi_lo
    n = h.shape[0]
    w = emb.T
    V = w.shape[1]
    t32 = t.to(torch.int32)
    with torch.no_grad():
        _, _, logz, mu = lops._forward_kernel(h, w, t32)
        dl = lops.dlogits_parts(h, w, t32, logz, mu, gl, ge, 0, n)
        hi, lo = dl[:n, :V], dl[n:, :V]
        dl32 = dlogits_ref(h.float() @ w.float(), t32, logz, mu, gl, ge)
        got = hi.double() + lo.double()
        err = (got - dl32.double()).abs()
        scale = dl32.abs().max().item()
        sub = {"max_abs_err": err.max().item(), "max_abs_dl": scale,
               "hi_equal_share": (hi == split_hi_lo(dl32)[0]).float().mean()
               .item()}
        if not bool(torch.isfinite(got).all()) \
                or sub["max_abs_err"] > 1e-4 * scale:
            raise AssertionError(f"dlogits_wgmma vs plain: {sub}")
        del dl32, got, err
        hi_only = {"dh": torch.mm(hi, emb, out_dtype=torch.float32),
                   "dw": torch.mm(h.T, hi, out_dtype=torch.float32).T}
    ratios = {}
    for k, out in hi_only.items():
        ref = refs[k]
        e = (out.to(torch.bfloat16).float() - ref).abs()
        ratios[k] = (e / (1e-5 * ref.abs().max().item()
                          + rtol * ref.abs())).max().item()
    return {"dl": sub, "hi_only_worst_err_over_tol": ratios}


# ------------------------------------------------------------------ training
def _serve_group_batch(torch, cfg, params, seed, np):
    """4 prompts x a group of 4 sampled completions through the engine ->
    (RolloutBatch, rewards, finished requests)."""
    from repro_torch.configs.base import RLConfig
    from repro_torch.rollout.continuous import ContinuousBatchingEngine
    from repro_torch.rollout.engine import rollout_batch
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(4, cfg.vocab_size, size=int(rng.integers(
        64, TRAIN_PROMPT_PAD + 1))).astype(np.int32)
        for _ in range(TRAIN_PROMPTS)]
    eng = ContinuousBatchingEngine(cfg, device="cuda", greedy=False,
                                   rl=RLConfig(temperature=1.0, top_p=1.0),
                                   **TRAIN_ENGINE_KW)
    for p in prompts:
        for _ in range(GROUP):
            eng.submit(p, max_new=TRAIN_MAX_NEW)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    done = sorted(eng.run(params, gen), key=lambda r: r.rid)
    if len(done) != TRAIN_PROMPTS * GROUP:
        raise AssertionError(f"{len(done)} requests finished")
    for i in range(0, len(done), GROUP):
        gens = {tuple(r.generated) for r in done[i: i + GROUP]}
        if len(gens) < GROUP:
            raise AssertionError("two sampled group members are identical")
    rb = rollout_batch(done, TRAIN_PROMPT_PAD, TRAIN_MAX_NEW, version=0)
    # A random model scores 0 on any verifier, which would make every
    # advantage 0 and the update vacuous: rewards are seeded Bernoulli(0.5)
    # draws, one per sequence.
    rewards = rng.binomial(1, 0.5, size=len(done)).astype(np.float32)
    return rb, rewards, done


def _check_metrics(np, m, keys):
    bad = {k: m[k] for k in keys if not np.isfinite(m[k])}
    if bad or m["nonfinite"] != 0 or not m["grad_norm"] > 0:
        raise AssertionError(f"training metrics: {m}")


def _changed(torch, old, new):
    """Elements changed, over all leaves."""
    from repro_torch.training.optimizer import flatten
    a, b = flatten(old), flatten(new)
    return sum(int((a[k] != b[k]).sum()) for k in a), \
        sum(a[k].numel() for k in a)


def phase_training(torch):
    import numpy as np
    from repro_torch.configs.base import RLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.training import (
        Trainer,
        TrainState,
        adam_init,
        assemble_train_batch,
    )
    from repro_torch.training.trainer import METRIC_KEYS

    cfg = get_config("qwen2.5-1.5b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                           device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)
    with torch.no_grad():
        _scale_blocks(torch, params, SCALE)
    t0 = time.perf_counter()
    rb_a, rew_a, done_a = _serve_group_batch(torch, cfg, params, 10, np)
    rb_b, rew_b, _ = _serve_group_batch(torch, cfg, params, 11, np)
    serve_s = time.perf_counter() - t0
    batch_a = assemble_train_batch([rb_a], rew_a, device="cuda")
    batch_b = assemble_train_batch([rb_b], rew_b, device="cuda")
    rl = RLConfig(group_size=GROUP, num_minibatches=4)
    trainer = Trainer(cfg, rl, "a3po")
    state = TrainState(params, adam_init(params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    torch.cuda.empty_cache()

    def timed_step(tr, st, batch):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, m = tr.step(st, batch)
        torch.cuda.synchronize()
        return new, m, {"seconds": time.perf_counter() - t0,
                        "prox_time_s": m["prox_time_s"],
                        "tokens": m["tokens"],
                        "peak_mem_gb": torch.cuda.max_memory_allocated()
                        / 1e9}

    steps = []
    saved = None
    _reset_counts()
    for i, (batch, d) in enumerate(((batch_a, 0), (batch_b, 1),
                                    (batch_a, 2))):
        if i == 1:  # the state before step 2, for the recompute step
            saved = TrainState(state.params, copy.deepcopy(state.opt),
                               state.version.clone())
        new, m, rec = timed_step(trainer, state, batch)
        _check_metrics(np, m, METRIC_KEYS)
        changed, total = _changed(torch, state.params, new.params)
        rec.update(step=i + 1, algo="a3po", staleness=d,
                   params_changed=changed, params_total=total,
                   host_syncs=trainer.last_host_syncs,
                   metrics={k: m[k] for k in METRIC_KEYS})
        emit(dict(phase="training_step", **rec))
        if changed == 0 or trainer.last_host_syncs != 1 \
                or m["staleness_mean"] != d:
            raise AssertionError(f"training step {i + 1}: {rec}")
        if d == 0 and not (m["ratio_mean"] == 1.0
                           and m["clipped_frac"] == 0.0
                           and IW_MEAN_BAND[0] <= m["iw_mean"]
                           <= IW_MEAN_BAND[1]):
            raise AssertionError(f"staleness 0 invariants: {m}")
        if d == 1 and m["iw_mean"] != 1.0:
            raise AssertionError(f"staleness 1: iw_mean {m['iw_mean']}")
        steps.append(rec)
        state = new
    launches = dict(_all_counts())
    train_kernels = ("a3po_loss", "a3po_loss_bwd", "token_logprob_entropy",
                     "token_logprob_entropy_bwd")
    if min(launches[k] for k in train_kernels) <= 0:
        raise AssertionError(f"a training kernel was not launched: "
                             f"{launches}")
    # the bf16 step's logprob forwards and backwards all took the TMA +
    # wgmma kernels
    if launches["token_logprob_entropy_wgmma"] \
            != launches["token_logprob_entropy"] \
            or launches["token_logprob_entropy_bwd_wgmma"] \
            != launches["token_logprob_entropy_bwd"]:
        raise AssertionError(f"a bf16 logprob pass missed the wgmma "
                             f"kernels: {launches}")
    del state, new

    # step 2 again from copies of the state before it, a3po and recompute
    # in turns (a3po, recompute, recompute, a3po): the same state, batch and
    # device, so the two differ only in the algorithm
    trainers = {"a3po": trainer, "recompute": Trainer(cfg, rl, "recompute")}
    turns = {"a3po": [], "recompute": []}
    for algo in ("a3po", "recompute", "recompute", "a3po"):
        st = TrainState(saved.params, copy.deepcopy(saved.opt),
                        saved.version.clone())
        _, m, rec = timed_step(trainers[algo], st, batch_b)
        _check_metrics(np, m, METRIC_KEYS)
        syncs = trainers[algo].last_host_syncs
        if syncs != (2 if algo == "recompute" else 1):
            raise AssertionError(f"{algo} host syncs {syncs}")
        rec.update(step=2, algo=algo, staleness=1, host_syncs=syncs,
                   turn=len(turns["a3po"]) + len(turns["recompute"]) + 1,
                   metrics={k: m[k] for k in METRIC_KEYS})
        emit(dict(phase="training_step", **rec))
        turns[algo].append(rec["seconds"])
        del st, _

    def profiled_step():
        st = TrainState(saved.params, copy.deepcopy(saved.opt),
                        saved.version.clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(st, batch_b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    prof = _device_profile(torch, profiled_step)
    emit(dict({"phase": "training_profile", "algo": "a3po",
               "a3po_loss_device_kernels": _a3po_loss_device_kernels(torch)},
              **prof))
    a3po_s = sum(turns["a3po"]) / 2
    recompute_s = sum(turns["recompute"]) / 2
    emit({"phase": "training", "model": cfg.name, "layers": cfg.num_layers,
          "dtype": "bfloat16", "layer_weight_scale": SCALE,
          "serve_two_batches_s": serve_s, "batch": list(batch_a.tokens.shape),
          "launches_three_a3po_steps": launches,
          "step2_turns_s": turns, "a3po_step2_mean_s": a3po_s,
          "recompute_step2_mean_s": recompute_s,
          "a3po_over_recompute": a3po_s / recompute_s})
    del saved
    torch.cuda.empty_cache()
    return launches


def _a3po_loss_device_kernels(torch):
    """The device kernels (and copies, fills) that one ``A3PO.loss`` and
    its backward launch at one minibatch of the training step (B 4 x T
    575, per-token version stamps, an entropy that carries a gradient),
    from ``torch.profiler``, beside the parent's path on the same inputs
    (the alpha schedule, the per-token kernel, eager reductions, autograd's
    backward). The reduced path must launch each reduced kernel once and
    at most 16 in all. A profiler session after the first in a process
    can miss the first device events it should see (8 of them in one run
    on an NVIDIA H100, all 16 markers in another), so each session first
    launches 16 empty kernels and counts only what starts after the last
    marker it saw; a session that saw no marker is taken again (at most
    three sessions), since what it saw after them cannot be told apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import RLConfig
    from repro_torch.core.algorithms import LossInputs, get_algorithm
    from repro_torch.kernels.a3po_loss import kernel as akernel
    markers = 16
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (4, TRAIN_T // 4)

    def u():
        return torch.rand(shape, generator=g, device="cuda")
    lp, ent = -u() * 3, u() * 5
    batch = LossInputs(
        advantages=torch.randn(shape, generator=g, device="cuda"),
        mask=(u() > 0.3).float(), behav_logp=-u() * 3,
        versions=torch.randint(0, 3, shape, generator=g, device="cuda",
                               dtype=torch.int32),
        current_version=torch.tensor(3, dtype=torch.int32, device="cuda"))
    rl, algo = RLConfig(), get_algorithm("a3po")

    def reduced(x, e):
        algo.loss(x, batch._replace(entropy=e), rl)[0].backward()

    def parent(x, e):
        alpha = algo.alpha(rl, versions=batch.versions,
                           current_version=batch.current_version)
        _parent_a3po_loss(torch, x, batch.behav_logp, alpha,
                          batch.advantages, batch.mask, rl, e)[0].backward()

    def session(fn):
        """One profiled call of ``fn`` behind the markers: (device events
        in start order, the indices of the markers among them)."""
        x = lp.clone().requires_grad_(True)
        e = ent.clone().requires_grad_(True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(markers):
                akernel.empty_launch_fn()(stream)
            torch.cuda.synchronize()
            fn(x, e)
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        return evs, [i for i, ev in enumerate(evs)
                     if "empty_kernel" in ev.name]

    out = {}
    for label, fn in (("reduced", reduced), ("parent", parent)):
        # a warm-up call, then the count
        fn(lp.clone().requires_grad_(True), ent.clone().requires_grad_(True))
        for sessions in range(1, 4):
            evs, seen = session(fn)
            if seen:
                break
        if not seen:
            raise AssertionError(f"the profiler saw no marker of {markers} "
                                 f"in {sessions} sessions")
        evs = evs[seen[-1] + 1:]
        out[label] = {"sessions": sessions,
                      "markers_seen": len(seen), "kernels": len(evs),
                      "device_us": sum(ev.time_range.end
                                       - ev.time_range.start for ev in evs),
                      "names": sorted(ev.name[:60] for ev in evs)}
    r = out["reduced"]
    n_fwd = sum("a3po_reduced_kernel" in k for k in r["names"])
    n_bwd = sum("a3po_reduced_bwd_kernel" in k for k in r["names"])
    if r["kernels"] > 16 or n_fwd != 1 or n_bwd != 1:
        raise AssertionError(f"A3PO.loss + backward launches: {out}")
    return out


# ------------------------------------------------------------- rollout, loop
ROLLOUT_PROMPT_PAD = 1024  # PR 11's 16 requests, right-padded


def phase_rollout(torch):
    """The dense RolloutEngine at Qwen2.5-1.5B, full width and depth, bf16,
    layer weights x8: PR 11's 16 requests (prompts 64-1024, right-padded to
    1024), 32 greedy new tokens. Each generated token and behaviour logp is
    held against the whole-sequence forward_logits (PR 11's tolerances);
    the flash kernel runs once per layer for the prefill and the dense
    decode kernel once per layer per token."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.rollout.engine import RolloutEngine

    cfg = get_config("qwen2.5-1.5b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.bfloat16)
    _scale_blocks(torch, params, SCALE)
    reqs = _requests(cfg)
    prompts = np.zeros((len(reqs), ROLLOUT_PROMPT_PAD), np.int32)
    lengths = np.array([len(r) for r in reqs], np.int32)
    for i, r in enumerate(reqs):
        prompts[i, : len(r)] = r
    engine = RolloutEngine(cfg, max_new_tokens=MAX_NEW)
    # warm-up: library handles and kernel modules load outside the timing
    engine.generate(params, prompts[:2], lengths[:2], greedy=True)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rb = engine.generate(params, prompts, lengths, greedy=True)
    elapsed = time.perf_counter() - t0
    launches = {k: v for k, v in _all_counts().items()
                if k in ("flash_attention", "decode_attention")}
    want = {"flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * MAX_NEW}
    if launches != want:
        raise AssertionError(f"rollout launches {launches}, want {want}")
    if not np.all(np.isfinite(rb.gen_logp)):
        raise AssertionError("rollout: non-finite behaviour logp")
    done = []
    for i, r in enumerate(reqs):
        n = int(rb.gen_mask[i].sum())
        gen = rb.tokens[i, len(r): len(r) + n]
        if n != MAX_NEW and gen[-1] != 2:
            raise AssertionError(f"rollout row {i}: mask {rb.gen_mask[i]}")
        done.append(SimpleNamespace(rid=i, prompt=r, generated=gen.tolist(),
                                    gen_logp=rb.gen_logp[i, :n].tolist()))
    checks = _reference_checks(torch, M, cfg, params, done, ENGINE_GAP_TOL,
                               ENGINE_LOGP_TOL)
    n_gen = int(rb.gen_mask.sum())
    emit({"phase": "rollout", "model": cfg.name, "layers": cfg.num_layers,
          "dtype": "bfloat16", "layer_weight_scale": SCALE,
          "batch": list(prompts.shape), "max_new": MAX_NEW,
          "prompt_tokens": int(lengths.sum()), "generated_tokens": n_gen,
          "elapsed_s": elapsed, "tokens_per_s": n_gen / elapsed,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "reference_checks": checks})

    # where the time goes: device-synchronised prefill / decode spans, and
    # a device profile of one more call
    from repro_torch.obs.tracing import install_tracer, phase_breakdown
    tracer = _sync_tracer(torch)
    install_tracer(tracer)
    try:
        t0 = time.perf_counter()
        rb2 = engine.generate(params, prompts, lengths, greedy=True)
        traced_s = time.perf_counter() - t0
    finally:
        install_tracer(None)
    br = phase_breakdown(tracer.events())
    if not np.array_equal(rb2.tokens, rb.tokens):
        raise AssertionError("traced rollout generated other tokens")

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(params, prompts, lengths, greedy=True)
        return time.perf_counter() - t0
    prof = _device_profile(torch, run)
    emit(dict({"phase": "rollout_profile", "traced_elapsed_s": traced_s,
               "prefill_s": br["prefill"]["total_s"],
               "prefill_tokens_per_s": int(lengths.sum())
               / br["prefill"]["total_s"],
               "decode_s": br["decode"]["total_s"],
               "decode_steps": br["decode"]["count"],
               "decode_ms_per_step": 1e3 * br["decode"]["total_s"]
               / br["decode"]["count"]}, **prof))
    del params
    torch.cuda.empty_cache()
    return launches


def _coin_task_class():
    """ArithmeticTask whose rewards are seeded Bernoulli(0.5) draws: a
    random model scores 0 on the verifier, which makes every advantage 0
    and the update empty. The coins come from the task's own RNG, the one
    a checkpoint captures (``task_rng_state``), so a resumed run draws
    what the uninterrupted one drew."""
    import numpy as np
    from repro_torch.data.tasks import ArithmeticTask

    class CoinTask(ArithmeticTask):
        def rewards(self, completions, answers):
            return self.rng.binomial(1, 0.5, len(answers)).astype(
                np.float32)
    return CoinTask


def _check_records(np, recs, label):
    keys = ("reward", "loss", "entropy", "iw_max", "iw_min",
            "clipped_tokens", "staleness_mean", "prox_time_s",
            "rollout_time_s", "train_time_s", "train_tokens", "host_syncs")
    bad = [(r["step"], k) for r in recs for k in keys
           if not np.isfinite(r[k])]
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {bad}")


@contextlib.contextmanager
def _capture_ops(torch, sites):
    """Record what each op in ``sites`` ({name: (module, attribute)}) was
    last given (its tensor arguments and keyword arguments as detached
    copies, strides kept), by wrapping it under
    the name its caller looks it up by; every call goes through
    unchanged."""
    seen = {}
    saved = {k: getattr(m, a) for k, (m, a) in sites.items()}

    def wrap(name, fn):
        def run(*args, **kw):
            seen[name] = ([a.detach().clone() if torch.is_tensor(a) else a
                           for a in args],
                          {k: v.detach().clone() if torch.is_tensor(v) else v
                           for k, v in kw.items()})
            return fn(*args, **kw)
        return run

    for name, (mod, attr) in sites.items():
        setattr(mod, attr, wrap(name, saved[name]))
    try:
        yield seen
    finally:
        for name, (mod, attr) in sites.items():
            setattr(mod, attr, saved[name])


@contextlib.contextmanager
def _capture_path(torch, extra=None):
    """Record, from a run of the main path, what its four kernel ops (and
    the ops of the ``extra`` sites, e.g. ``_ssd_sites()``) were last given
    (``_capture_ops``) and every rollout. Yields {op name: (args, kwargs)}
    with ``"rollouts"``: [(params, version, RolloutBatch)] and ``"trees"``:
    {version: a copy of its parameters when a rollout first used them}."""
    from repro_torch.rollout.engine import RolloutEngine
    from repro_torch.training.optimizer import flatten
    plain = RolloutEngine.generate
    with _capture_ops(torch, {**_dense_sites(train=True),
                              **(extra or {})}) as seen:
        seen.update(rollouts=[], trees={})

        def generate(self, params, *args, **kw):
            version = kw.get("version", 0)
            if version not in seen["trees"]:
                seen["trees"][version] = {
                    k: t.detach().clone() for k, t in flatten(params).items()}
            rb = plain(self, params, *args, **kw)
            seen["rollouts"].append((params, version, rb))
            return rb

        RolloutEngine.generate = generate
        try:
            yield seen
        finally:
            RolloutEngine.generate = plain


def _logprob_top_tile_dropped(torch, h, w, t, tile=128):
    """The plain token logp and entropy with, in each row, the 128-entry
    vocab tile that holds the row's largest logit left out: a kernel that
    skipped the tile that matters most to that row (half the vocabulary
    where that is less than a tile)."""
    logits = h @ w
    tile = min(tile, logits.shape[1] // 2)
    first = logits.argmax(dim=-1) // tile * tile
    cols = torch.arange(logits.shape[1], device=logits.device)[None]
    drop = (cols >= first[:, None]) & (cols < first[:, None] + tile)
    logz = torch.logsumexp(logits.masked_fill(drop, -torch.inf), dim=-1)
    p = torch.exp(logits - logz[:, None]).masked_fill(drop, 0.0)
    logp = logits.gather(-1, t.long()[:, None])[:, 0] - logz
    return logp, logz - (p * logits).sum(-1)


def _dense_top_key_dropped(torch, q, kc, vc, lengths):
    """The plain dense decode (float32) with, in each row of more than one
    key, the key that scores highest over the row's heads left out. At the
    init stds a row of ~3000 keys attends so flatly that a reference one
    key short at its end stays within the tolerance; leaving out the key
    that matters most does not."""
    from repro_torch.kernels.decode_attn.ref import decode_attention
    B, H, hd = q.shape
    L, KV = kc.shape[1], kc.shape[2]
    k, v = kc.float(), vc.float()
    keys = torch.arange(L, device=q.device)[None, :]
    valid = keys < lengths[:, None]
    score = torch.einsum("bkgd,blkd->bkgl", q.float().reshape(B, KV, -1, hd),
                         k).amax((1, 2))
    top = score.masked_fill(~valid, -torch.inf).argmax(-1)
    drop = (keys == top[:, None]) & (lengths[:, None] > 1)
    return decode_attention(q.float(), k, v, valid & ~drop)


def _hold_path_kernels(torch, seen, decode_wrong="lengths_minus_one",
                       a3po_wrong=("last_block_dropped", "divides_by_t")):
    """Each kernel op the path called, held against its plain version on
    the inputs of its last call there (bf16 attention and logprob inputs
    against float32 plain versions, the A-3PO loss in float32), with the
    wrong references of the kernel phases (dense decode's, one label or a
    tuple of them: ``"lengths_minus_one"``, ``"top_key_dropped"``
    (``_dense_top_key_dropped``) or ``"half_the_keys"`` (each row's first
    half of its keys only); the A-3PO loss's: ``a3po_wrong``). Returns the
    records."""
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.kernels.logprob import ops as lops
    from repro_torch.kernels.logprob.ref import token_logprob_entropy_ref

    tol = TOL["bfloat16"]
    recs = {}
    if "flash_attention" in seen:
        (q, k, v), kw = seen["flash_attention"]
        with torch.no_grad():
            out = fops.flash_attention(q, k, v, **kw)
            q32, k32, v32 = q.float(), k.float(), v.float()
            rec = {"name": "flash_attention", "shape": list(q.shape),
                   "kv_shape": list(k.shape), "strides": list(q.stride()),
                   **kw}
            _hold(torch, rec, out, flash_attention_ref(q32, k32, v32, **kw),
                  tol, {"diagonal_masked": _masked_diagonal_ref(
                      torch, q32, k32, v32)})
        recs["flash_attention"] = rec
    if "decode_attention" in seen:
        (q, kc, vc, lengths), _ = seen["decode_attention"]
        with torch.no_grad():
            out = dops.decode_attention_op(q, kc, vc, lengths)
            q32, k32, v32 = q.float(), kc.float(), vc.float()
            rec = {"name": "decode_attention", "shape": list(q.shape),
                   "cache": list(kc.shape),
                   "lengths": [int(lengths.min()), int(lengths.max())]}
            wrong = {
                "lengths_minus_one": lambda: decode_attention_ref(
                    q32, k32, v32, lengths - 1),
                "top_key_dropped": lambda: _dense_top_key_dropped(
                    torch, q, kc, vc, lengths),
                "half_the_keys": lambda: decode_attention_ref(
                    q32, k32, v32, (lengths + 1) // 2)}
            labels = ((decode_wrong,) if isinstance(decode_wrong, str)
                      else decode_wrong)
            _hold(torch, rec, out, decode_attention_ref(q32, k32, v32,
                                                        lengths), tol,
                  {k: wrong[k]() for k in labels})
        recs["decode_attention"] = rec
    if "token_logprob_entropy" in seen:
        (h, w, t), _ = seen["token_logprob_entropy"]
        h, t = h.reshape(-1, h.shape[-1]), t.reshape(-1)
        V = w.shape[1]
        rec = {"name": "token_logprob_entropy", "dtype": str(h.dtype),
               "shape": {"T": h.shape[0], "d": h.shape[1], "V": V}}
        # forward, with a wrong reference one vocab tile short: here the
        # tile that holds each row's largest logit, since the path's rows
        # put all but ~e^-15 of their mass on a few tokens and any other
        # tile moves logz by less than the tolerance
        with torch.no_grad():
            lp, en = lops.token_logprob_entropy(h, w, t)
            h32, w32 = h.float(), w.float()
            lp_r, en_r = token_logprob_entropy_ref(h32, w32, t)
            lp_w, en_w = _logprob_top_tile_dropped(torch, h32, w32, t)
        for label, out, ref, wrong in (("logp", lp, lp_r, lp_w),
                                       ("entropy", en, en_r, en_w)):
            rec[label] = {"name": f"token_logprob_entropy.{label}"}
            _hold(torch, rec[label], out, ref, LOGPROB_TOL,
                  {"top_vocab_tile_dropped": wrong})
        del h32, w32, lp_r, en_r, lp_w, en_w
        # backward: dh, dw against autograd of the plain version
        g = torch.Generator(device=h.device).manual_seed(9)
        gl, ge = torch.randn(2, h.shape[0], generator=g, device=h.device)
        hk, wk = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        lp, en = lops.token_logprob_entropy(hk, wk, t)
        ((lp * gl).sum() + (en * ge).sum()).backward()
        h32 = h.float().requires_grad_(True)
        w32 = w.float().requires_grad_(True)
        lp_r, en_r = token_logprob_entropy_ref(h32, w32, t)
        ((lp_r * gl).sum() + (en_r * ge).sum()).backward()
        rtol = LOGPROB_BWD_RTOL["bfloat16" if h.dtype == torch.bfloat16
                                else "float32"]
        for label, out, ref in (("dh", hk.grad, h32.grad),
                                ("dw", wk.grad, w32.grad)):
            rec[label] = {"name": f"token_logprob_entropy_bwd.{label}"}
            _hold(torch, rec[label], out, ref,
                  {"rtol": rtol, "atol": 1e-5 * ref.abs().max().item()}, {})
        del hk, wk, h32, w32
        recs["token_logprob_entropy"] = rec
    if "a3po_loss" in seen:
        args, kw = seen["a3po_loss"]
        args = [None if a is None else a.reshape(-1).contiguous()
                for a in args]
        kw = {k: v for k, v in kw.items() if k != "use_kernel"}
        rec, _ = _hold_a3po_reduced(torch, args, kw, a3po_wrong)
        rec["name"] = "a3po_loss"
        rec["cover"] = {"clipped": rec["values"]["clipped_tokens"],
                        "adv_nonzero": int((args[3] != 0).sum()),
                        "masked_in": rec["values"]["denom"]}
        recs["a3po_loss"] = rec
    return recs


def _check_behaviour(torch, M, cfg, rollouts, final_params, snaps,
                     staleness):
    """The launcher's rollouts: step s generated with the version
    max(0, s - staleness) tree, each such tree still holds the values it
    had when it was first used (no in-place update reached an older
    version), the final parameters moved, and every recorded behaviour
    logp agrees with the whole-sequence forward_logits of the tree that
    generated it at the sampled token (temperature 1, top-p 1)."""
    import numpy as np
    from repro_torch.training.optimizer import flatten
    versions = [v for _, v, _ in rollouts]
    want = [max(0, s - staleness) for s in range(len(rollouts))]
    kept = {v: all(torch.equal(t, snaps[v][k])
                   for k, t in flatten(p).items())
            for p, v, _ in rollouts}
    final = flatten(final_params)
    moved = {v: sum(int((final[k] != snaps[v][k]).sum()) for k in final)
             for v in snaps}
    worst = 0.0
    n_tok = 0
    logp_sum = 0.0
    for p, v, rb in rollouts:
        toks = torch.as_tensor(rb.tokens.astype(np.int64),
                               device=final_params["embedding"]["embed"].device)
        with torch.no_grad():
            lp = torch.log_softmax(M.forward_logits(p, cfg, toks[:, :-1]),
                                   dim=-1)
        for b, P in enumerate(np.asarray(rb.prompt_lengths)):
            n = int(rb.gen_mask[b].sum())
            ref = lp[b, P - 1: P - 1 + n].gather(
                -1, toks[b, P: P + n, None])[:, 0].cpu().numpy()
            worst = max(worst, float(np.abs(ref - rb.gen_logp[b, :n]).max(
                initial=0.0)))
            n_tok += n
            logp_sum += float(rb.gen_logp[b, :n].sum())
    out = {"behaviour_versions": versions, "trees_kept": kept,
           "params_moved_from": moved, "behaviour_logp_max_abs_err": worst,
           "tokens_checked": n_tok, "mean_behaviour_logp": logp_sum
           / max(n_tok, 1), "logp_tol": ENGINE_LOGP_TOL,
           "max_mean_logp": MAX_MEAN_LOGP}
    # a model that puts probability 1 on one token (logp 0) would pass
    # the logp comparison whatever the engine recorded
    if versions != want or not all(kept.values()) \
            or min(moved.values()) == 0 or worst > ENGINE_LOGP_TOL \
            or n_tok == 0 or out["mean_behaviour_logp"] > MAX_MEAN_LOGP:
        raise AssertionError(f"launcher behaviour: {out}, want versions "
                             f"{want}")
    return out


def phase_async_rl(torch, tmp):
    """The async RL loop at Qwen2.5-1.5B, full width and depth, bf16: the
    launcher (`python -m repro_torch.launch.train --arch qwen2.5-1.5b
    --steps 4 --staleness 2`) for a3po and recompute, from its own seeded
    initial state with the layer weights x8 and the task's rewards
    replaced by seeded Bernoulli draws so that the update is not empty,
    holding each kernel of the path against its plain version on
    the inputs the path gave it, and the behaviour policies and logps;
    simulate_async with x8 layer weights, checking that the parameters
    move and that the step-0 tree keeps its values; the threaded
    AsyncOrchestrator."""
    import numpy as np
    from repro_torch.async_rl.orchestrator import (
        AsyncOrchestrator,
        simulate_async,
    )
    from repro_torch.configs.base import RLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.obs.runlog import read_jsonl
    from repro_torch.training import TrainState, adam_init
    from repro_torch.training.optimizer import flatten

    launches = {}
    staleness = 2
    cfg = get_config("qwen2.5-1.5b")
    for algo in ("a3po", "recompute"):
        path = str(tmp / f"train_{algo}.jsonl")
        result = {}
        # at init stds the model puts probability 1 on one token, so every
        # behaviour logp is 0 and the gradients all but vanish: the layer
        # weights go x8, the rewards become seeded Bernoulli draws, and the
        # final state is kept for the checks
        with _scaled_launcher(torch, train, cfg, result), \
                _capture_path(torch) as seen:
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train.main(["--arch", "qwen2.5-1.5b", "--steps", "4",
                        "--staleness", str(staleness), "--algo", algo,
                        "--log-jsonl", path, "--quiet"])
            elapsed = time.perf_counter() - t0
            counts = _all_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
        recs = read_jsonl(path)
        _check_records(np, recs, algo)
        syncs = 2.0 if algo == "recompute" else 1.0
        rec = {"phase": "async_rl_launcher", "algo": algo,
               "rewards": "seeded Bernoulli(0.5)",
               "layer_weight_scale": SCALE,
               "steps": len(recs), "elapsed_s": elapsed,
               "steps_per_s": len(recs) / elapsed,
               "staleness": [r["staleness_mean"] for r in recs],
               "host_syncs": [r["host_syncs"] for r in recs],
               "prox_time_s": [r["prox_time_s"] for r in recs],
               "reward": [r["reward"] for r in recs],
               "loss": [r["loss"] for r in recs],
               "rollout_s": [r["rollout_time_s"] for r in recs],
               "train_s": [r["train_time_s"] for r in recs],
               "peak_mem_gb": peak, "launches": counts}
        emit(rec)
        prox_ok = all((p > 1e-3) == (algo == "recompute")
                      for p in rec["prox_time_s"])
        path_kernels = ["flash_attention", "decode_attention",
                        "token_logprob_entropy", "token_logprob_entropy_bwd"]
        if algo == "a3po":
            path_kernels += ["a3po_loss", "a3po_loss_bwd"]
        if (rec["staleness"] != [0.0, 1.0, 2.0, 2.0]
                or rec["host_syncs"] != [syncs] * 4 or not prox_ok
                or any(counts[k] <= 0 for k in path_kernels)
                or any(k not in seen for k in path_kernels
                       if not k.endswith("_bwd"))):
            raise AssertionError(f"launcher run: {rec}")
        launches[algo] = counts
        # after the counts were read: the path's rollouts and the inputs
        # it gave its kernels, held against their plain versions
        rollouts, trees = seen.pop("rollouts"), seen.pop("trees")
        behaviour = _check_behaviour(torch, M, cfg, rollouts,
                                     result["state"].params, trees,
                                     staleness)
        emit({"phase": "async_rl_launcher_checks", "algo": algo,
              **behaviour, "kernels": _hold_path_kernels(torch, seen)})
        del seen, rollouts, trees, result
        torch.cuda.empty_cache()

    # simulate_async with seeded rewards: the update is not empty, and no
    # in-place update reaches the step-0 tree the loop keeps as behaviour
    rl = RLConfig(group_size=4, num_minibatches=2, learning_rate=2e-4,
                  max_staleness=3)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(5),
                           device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)
    with torch.no_grad():
        _scale_blocks(torch, params, SCALE)
    state = TrainState(params, adam_init(params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    before = {k: v.detach().clone() for k, v in flatten(params).items()}
    task = _coin_task_class()(max_operand=9, n_terms=2, prompt_len=8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, recs = simulate_async(cfg, rl, task, "a3po", 4, n_prompts=8,
                                 max_new_tokens=6, staleness=2,
                                 init_state=state)
    elapsed = time.perf_counter() - t0
    step0_same = all(torch.equal(v, before[k])
                     for k, v in flatten(params).items())
    final = flatten(state.params)
    changed = sum(int((final[k] != before[k]).sum()) for k in final)
    recs = [dataclasses.asdict(r) for r in recs]
    _check_records(np, recs, "simulate_async")
    rec = {"phase": "async_rl_simulate", "algo": "a3po", "staleness": 2,
           "layer_weight_scale": SCALE, "steps": len(recs),
           "elapsed_s": elapsed, "steps_per_s": len(recs) / elapsed,
           "staleness_mean": [r["staleness_mean"] for r in recs],
           "reward": [r["reward"] for r in recs],
           "loss": [r["loss"] for r in recs],
           "rollout_s": [r["rollout_time_s"] for r in recs],
           "train_s": [r["train_time_s"] for r in recs],
           "step0_tree_unchanged": step0_same,
           "params_changed": changed,
           "params_total": sum(v.numel() for v in final.values()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    if not step0_same or changed == 0 \
            or rec["staleness_mean"] != [0.0, 1.0, 2.0, 2.0]:
        raise AssertionError(f"simulate_async: {rec}")
    del state, params, before, final
    torch.cuda.empty_cache()

    # the threaded orchestrator: a rollout thread and the trainer share
    # the card
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(6),
                           device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)
    with torch.no_grad():
        _scale_blocks(torch, params, SCALE)
    state = TrainState(params, adam_init(params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    orch = AsyncOrchestrator(cfg, rl, _coin_task_class()(
        max_operand=9, n_terms=2, prompt_len=8), "a3po", n_prompts=8,
        max_new_tokens=6, queue_capacity=2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, recs = orch.run(state, 3)
    elapsed = time.perf_counter() - t0
    recs = [dataclasses.asdict(r) for r in recs]
    _check_records(np, recs, "orchestrator")
    rec = {"phase": "async_rl_orchestrator", "algo": "a3po",
           "max_staleness": rl.max_staleness, "steps": len(recs),
           "elapsed_s": elapsed, "steps_per_s": len(recs) / elapsed,
           "staleness_mean": [r["staleness_mean"] for r in recs],
           "rollout_s": [r["rollout_time_s"] for r in recs],
           "train_s": [r["train_time_s"] for r in recs],
           "queue_dropped": orch.queue.dropped,
           "version": int(state.version),
           "worker_crashes": len(orch.worker.crashes),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    if [r["step"] for r in recs] != [0, 1, 2] or rec["version"] != 3 \
            or rec["worker_crashes"] or orch.worker.alive \
            or not all(0 <= d <= rl.max_staleness
                       for d in rec["staleness_mean"]):
        raise AssertionError(f"orchestrator: {rec}")
    del state, params, orch
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- control plane
# the serving control plane at Qwen2.5-1.5B: a warm wave of 4 distinct
# prompts (none a multiple of the 16-token page), then a group wave of
# those 4 prompts x a group of 4 that hits the radix cache at P - 1 tokens
CP_PROMPT_LENS = (200, 511, 777, 1000)
CP_MAX_NEW = 32
CP_PREFILL_BUDGET = 2
# the reference's cached-vs-uncached tolerance in float32
# (tests/test_serving_control_plane.py: logits within 2e-4)
CP_F32_LOGP_TOL = 2e-4
CP_F32_LAYERS = 4


def _cp_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(11)
    return [rng.integers(4, cfg.vocab_size, size=n).astype(np.int32)
            for n in CP_PROMPT_LENS]


def _cp_wave(cp, prompts, group, on_step=None):
    """Submit each prompt ``group`` times (prompt-major) and step the
    control plane until every request finished; returns them by rid."""
    rids = {cp.submit(p, max_new=CP_MAX_NEW) for p in prompts
            for _ in range(group)}
    done, steps = [], 0
    while len(done) < len(rids):
        done += cp.step()
        steps += 1
        if on_step is not None:
            on_step(steps)
        if steps > 10_000:
            raise AssertionError("control plane did not finish the wave")
    if {r.rid for r in done} != rids:
        raise AssertionError("control plane finished other requests")
    return sorted(done, key=lambda r: r.rid), steps


def _cp_counters(cp):
    m, eng = cp.metrics, cp.engine
    return {"prefill_chunks": m.prefill_chunks,
            "prefill_time_s": m.prefill_time_s,
            "prefill_tokens_computed": m.prefill_tokens_computed,
            "prefill_chunk_tokens": eng.prefill_chunk_tokens,
            "prefix_hit_tokens": m.prefix_hit_tokens,
            "decode_launches": m.decode_launches,
            "decode_time_s": m.decode_time_s,
            "cow_forks": eng.allocator.forks}


def _cp_serve(torch, cfg, params, prompts, *, cache):
    """A warm wave, then the group wave with a pure-stamp publish (the same
    tree as version 1) after its second step, through a fresh control plane
    over the paged engine. Returns the plane, both waves and the group
    wave's record (host-clock seconds and counter deltas)."""
    from repro_torch.async_rl.weights import WeightStore
    from repro_torch.rollout.continuous import ContinuousBatchingEngine
    from repro_torch.serving import (
        AdmissionScheduler,
        SchedulerConfig,
        ServingControlPlane,
    )
    eng = ContinuousBatchingEngine(cfg, device="cuda", **ENGINE_KW)
    store = WeightStore(params, 0)
    cp = ServingControlPlane(
        eng, store, AdmissionScheduler(SchedulerConfig(d_max=100)),
        use_prefix_cache=cache, prefill_budget=CP_PREFILL_BUDGET)
    warm, _ = _cp_wave(cp, prompts, 1)

    def publish(step):
        if step == 2:
            store.publish(params, 1)

    before = _cp_counters(cp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    group, steps = _cp_wave(cp, prompts, GROUP, publish)
    torch.cuda.synchronize()
    rec = {"elapsed_s": time.perf_counter() - t0, "steps": steps,
           **{k: v - before[k] for k, v in _cp_counters(cp).items()}}
    return cp, warm, group, rec


def _paged_sites():
    from repro_torch.rollout import continuous
    return {"paged_decode_attention": (continuous,
                                       "paged_decode_attention_op"),
            "paged_prefill_attention": (continuous,
                                        "paged_prefill_attention_op")}


def _paged_top_key_dropped(torch, q, pool_k, pool_v, tables, lengths):
    """The plain paged decode (float32) with, in each row of more than one
    key, the key that scores highest over the row's heads left out: a
    kernel that skipped the key that matters most. The path's rows attend
    sharply (weights x8), so a key or a page short at a row's end can move
    nothing there."""
    from repro_torch.kernels.decode_attn.ref import decode_attention
    S, mb = tables.shape
    bs, KV, hd = pool_k.shape[1:]
    safe = tables.clamp_min(0).long()
    k = pool_k[safe].reshape(S, mb * bs, KV, hd).float()
    v = pool_v[safe].reshape(S, mb * bs, KV, hd).float()
    keys = torch.arange(mb * bs, device=q.device)[None, :]
    valid = keys < lengths[:, None]
    score = torch.einsum("skgd,slkd->skgl",
                         q.float().reshape(S, KV, -1, hd), k).amax((1, 2))
    top = score.masked_fill(~valid, -torch.inf).argmax(-1)
    drop = (keys == top[:, None]) & (lengths[:, None] > 1)
    return decode_attention(q.float(), k, v, valid & ~drop)


def _hold_paged_kernels(torch, seen):
    """The two paged kernels held against their plain versions on the
    inputs of their last call in a run (bf16 pools against float32 plain
    versions), with a wrong reference that leaves out each row's
    highest-scoring key (``_paged_top_key_dropped``). Returns the
    records."""
    from repro_torch.kernels.decode_attn.ops import paged_decode_attention_op
    from repro_torch.kernels.decode_attn.ref import paged_decode_attention_ref
    from repro_torch.kernels.prefill_attn.ops import (
        paged_prefill_attention_op,
    )
    from repro_torch.kernels.prefill_attn.ref import (
        paged_prefill_attention_ref,
    )
    recs = {}
    with torch.no_grad():
        if "paged_decode_attention" in seen:
            (q, pk, pv, tables, lens), _ = seen["paged_decode_attention"]
            bs = pk.shape[1]
            tol = TOL["bfloat16" if pk.dtype == torch.bfloat16
                      else "float32"]
            out = paged_decode_attention_op(q, pk, pv, tables, lens)
            q32, k32, v32 = q.float(), pk.float(), pv.float()
            wrong = {"top_key_dropped": _paged_top_key_dropped(
                torch, q, pk, pv, tables, lens)}
            rec = {"name": "paged_decode_attention", "dtype": str(pk.dtype),
                   "shape": {"S": q.shape[0], "H": q.shape[1],
                             "KV": pk.shape[2], "hd": q.shape[2], "bs": bs,
                             "mb": tables.shape[1],
                             "n_blocks": pk.shape[0]},
                   "lengths": [int(lens.min()), int(lens.max())]}
            _hold(torch, rec, out, paged_decode_attention_ref(
                q32, k32, v32, tables, lens), tol, wrong)
            recs["paged_decode_attention"] = rec
        if "paged_prefill_attention" in seen:
            (q, pk, pv, tables, seg, pos), _ = seen["paged_prefill_attention"]
            bs = pk.shape[1]
            tol = TOL["bfloat16" if pk.dtype == torch.bfloat16
                      else "float32"]
            out = paged_prefill_attention_op(q, pk, pv, tables, seg, pos)
            q32, k32, v32 = q.float(), pk.float(), pv.float()
            dropped = _paged_top_key_dropped(
                torch, q, pk, pv, tables[seg.clamp_min(0).long()], pos + 1)
            wrong = {"top_key_dropped": torch.where(
                (seg >= 0)[:, None, None], dropped, torch.zeros_like(
                    dropped))}
            rec = {"name": "paged_prefill_attention", "dtype": str(pk.dtype),
                   "shape": {"C": q.shape[0], "H": q.shape[1],
                             "KV": pk.shape[2], "hd": q.shape[2], "bs": bs,
                             "mb": tables.shape[1],
                             "n_blocks": pk.shape[0]},
                   "positions": sorted({int(x) for x in pos.tolist()})[-8:]}
            _hold(torch, rec, out, paged_prefill_attention_ref(
                q32, k32, v32, tables, seg, pos), tol, wrong)
            recs["paged_prefill_attention"] = rec
    return recs


def _check_stamps(reqs, label):
    """Every request's version stamps are monotone, one per token."""
    for r in reqs:
        v = r.token_versions
        if len(v) != len(r.generated) or v != sorted(v):
            raise AssertionError(f"{label}: request {r.rid} stamps {v}")


def phase_control_plane(torch, tmp):
    """(a) Qwen2.5-1.5B (28 layers, bf16, layer weights x8) served through
    the serving control plane: a warm wave of 4 distinct prompts, then the
    group wave of 4 prompts x a group of 4 that hits the radix cache at
    P - 1 tokens and forks each shared partial tail page, with a
    pure-stamp publish mid-wave; tokens and logps held against
    forward_logits; the group wave's time, prefill chunks and prefill
    seconds with and without the cache; the paged kernels held on their
    last call over shared pages; the pool drained once the cache is
    cleared; in float32 at 4 layers, the cached wave equal to the
    uncached. (b) `--engine async` through the launcher (the threaded
    orchestrator over the control plane; block 8, 32 slots), from a
    seeded initial state with the layer weights x8 and seeded Bernoulli
    rewards, its four kernels held on the inputs of their last call."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.core import objective
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.obs.runlog import read_jsonl
    from repro_torch.serving import ServingMetrics
    from repro_torch.training import trainer

    t_phase = time.perf_counter()
    cfg = get_config("qwen2.5-1.5b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.bfloat16)
    _scale_blocks(torch, params, SCALE)
    prompts = _cp_prompts(cfg)
    P = {len(p) for p in prompts}
    n_group = len(prompts) * GROUP

    # warm-up of this plane's shapes outside the timed runs
    _cp_serve(torch, cfg, params, prompts[:1], cache=True)
    _reset_counts()
    cp, warm, group, cached = _cp_serve(torch, cfg, params, prompts,
                                        cache=True)
    counts = rec_a_counts = _all_counts()
    serve_path = ("paged_decode_attention", "paged_prefill_attention")
    hits = [r.prefix_hit_tokens for r in group]
    versions = sorted({v for r in group for v in r.token_versions})
    _check_stamps(warm + group, "control plane")
    checks = _reference_checks(torch, M, cfg, params, warm + group,
                               ENGINE_GAP_TOL, ENGINE_LOGP_TOL)
    rec = {"phase": "control_plane", "model": cfg.name,
           "layers": cfg.num_layers, "dtype": "bfloat16",
           "layer_weight_scale": SCALE, "engine": ENGINE_KW,
           "prefill_budget": CP_PREFILL_BUDGET, "prompt_lens": sorted(P),
           "group": GROUP, "max_new": CP_MAX_NEW,
           "group_requests": n_group, "prefix_hits": hits,
           "versions": versions, "interrupts": cp.metrics.interrupts,
           "group_wave_cached": cached, "launches": counts,
           "serving": cp.metrics.snapshot(), "reference_checks": checks}
    if (any(h != len(r.prompt) - 1 for h, r in zip(hits, group))
            or cached["cow_forks"] != n_group
            or cached["prefill_chunk_tokens"] != n_group
            or cached["prefill_tokens_computed"] != n_group
            or versions != [0, 1] or cp.metrics.interrupts != 1
            or any(counts[k] <= 0 for k in serve_path)):
        raise AssertionError(f"control plane: {rec}")

    # each prompt once more, its two paged kernels captured on their last
    # call (one-token rows over pages the warm wave wrote and the cache
    # shares, the tail page forked first)
    with _capture_ops(torch, _paged_sites()) as seen:
        _cp_wave(cp, prompts, 1)
    rec["kernels"] = _hold_paged_kernels(torch, seen)
    del seen
    eng = cp.engine
    eng.prefix_cache.clear()
    rec["free_after_clear"] = eng.allocator.n_free
    if eng.allocator.n_free != ENGINE_KW["n_blocks"] - 1 \
            or len(eng.free_slots()) != ENGINE_KW["max_seqs"]:
        raise AssertionError(f"control plane: pool not drained: {rec}")
    del cp, eng

    # the same traffic without the cache: every prompt token prefilled
    cp, _, _, uncached = _cp_serve(torch, cfg, params, prompts, cache=False)
    rec["group_wave_uncached"] = uncached
    emit(rec)
    if uncached["prefill_chunk_tokens"] != GROUP * sum(CP_PROMPT_LENS):
        raise AssertionError(f"control plane, uncached: {uncached}")
    del cp, params
    torch.cuda.empty_cache()

    # float32 at 4 layers: the cached wave gives the uncached one's greedy
    # tokens, logps within 2e-4 (the reference's test)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=CP_F32_LAYERS)
    params32 = M.init_params(cfg32,
                             torch.Generator(device="cuda").manual_seed(1),
                             device="cuda", dtype=torch.float32)
    _scale_blocks(torch, params32, SCALE)
    runs = [_cp_serve(torch, cfg32, params32, prompts, cache=c)
            for c in (True, False)]
    worst, same = 0.0, True
    for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
        same &= a.generated == b.generated
        if a.generated == b.generated:
            worst = max(worst, float(np.abs(np.subtract(
                a.gen_logp, b.gen_logp)).max()))
    f32 = {"phase": "control_plane_float32", "layers": CP_F32_LAYERS,
           "same_tokens": same, "max_abs_logp_diff": worst,
           "logp_tol": CP_F32_LOGP_TOL,
           "prefix_hits": [r.prefix_hit_tokens for r in runs[0][2]],
           "group_wave_cached": runs[0][3],
           "group_wave_uncached": runs[1][3]}
    emit(f32)
    if not same or worst > CP_F32_LOGP_TOL:
        raise AssertionError(f"control plane float32: {f32}")
    del runs, params32
    torch.cuda.empty_cache()

    # (b) the launcher's --engine async, a3po, from a seeded initial state
    # with the layer weights x8 and seeded Bernoulli rewards
    kept = {}
    log = str(tmp / "train_async.jsonl")
    sites = dict(_paged_sites(),
                 token_logprob_entropy=(trainer, "token_logprob_entropy"),
                 a3po_loss=(objective, "a3po_objective_reduced"))
    with _scaled_orchestrator(torch, train, kept), \
            _capture_ops(torch, sites) as seen:
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train.main(["--arch", "qwen2.5-1.5b", "--steps", "4",
                    "--staleness", "2", "--engine", "async",
                    "--log-jsonl", log, "--quiet"])
        elapsed = time.perf_counter() - t0
        counts = _all_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
    recs = read_jsonl(log)
    _check_records(np, recs, "engine async")
    orch = kept["orch"]
    eng = orch.control_plane.engine
    busy = len(eng.free_slots()) != eng.max_seqs
    eng.prefix_cache.clear()
    keys = set(ServingMetrics(register=False).snapshot())
    gate = orch.rl.max_staleness
    rec = {"phase": "async_rl_control_plane", "algo": "a3po",
           "rewards": "seeded Bernoulli(0.5)", "layer_weight_scale": SCALE,
           "engine": {"max_seqs": eng.max_seqs,
                      "block_size": eng.state.block_size,
                      "n_blocks": eng.allocator.n_blocks + 1,
                      "decode_horizon": eng.decode_horizon},
           "steps": len(recs), "elapsed_s": elapsed,
           "steps_per_s": len(recs) / elapsed,
           "staleness": [r["staleness_mean"] for r in recs],
           "max_staleness": gate,
           "host_syncs": [r["host_syncs"] for r in recs],
           "reward": [r["reward"] for r in recs],
           "loss": [r["loss"] for r in recs],
           "rollout_s": [r["rollout_time_s"] for r in recs],
           "train_s": [r["train_time_s"] for r in recs],
           "serving_last": recs[-1].get("serving") if recs else None,
           "slots_busy_after": busy,
           "free_after_clear": eng.allocator.n_free,
           "peak_mem_gb": peak, "launches": counts}
    emit(rec)
    path = ("paged_decode_attention", "paged_prefill_attention",
            "token_logprob_entropy", "token_logprob_entropy_bwd",
            "a3po_loss", "a3po_loss_bwd")
    if (len(recs) != 4
            or any(set(r.get("serving") or {}) != keys for r in recs)
            or not all(0 <= r["staleness_mean"] <= gate for r in recs)
            or any(r["host_syncs"] != 1.0 for r in recs)
            or any(counts[k] <= 0 for k in path) or busy
            or eng.allocator.n_free != eng.allocator.n_blocks
            or orch.worker.alive):
        raise AssertionError(f"engine async: {rec}")
    held = _hold_paged_kernels(torch, seen)
    held.update(_hold_path_kernels(torch, seen))
    emit({"phase": "async_rl_control_plane_checks", "kernels": held,
          "phase_s": time.perf_counter() - t_phase})
    del seen, kept, orch, eng
    torch.cuda.empty_cache()
    return {"control_plane": {k: rec_a_counts[k] for k in serve_path},
            "engine_async": {k: counts[k] for k in path}}


# ------------------------------------------------------------- resilience
# (a) crash and bit-exact resume at Qwen2.5-1.5B's full width, depth cut to
# 4 layers: a checkpoint holds the params (float32 on disk), Adam m and v
# and the staleness history (two trees at staleness 1), ~8.4 GB a save at
# 4 layers (0.42 B params, the 233 M-parameter embedding included) and
# ~31 GB at 28. Checkpoint every 2 steps of 4; the crash at step 3.
RES_LAYERS = 4
RES_STEPS = 4
RES_CKPT_EVERY = 2
RES_CRASH_AT = 3
# (c) the four serving-side and loop faults of `--engine async`; the
# kv_exhaust hold takes the whole free pool (it grabs what is free, at
# most its magnitude) for 3 serving steps
ASYNC_FAULTS = ("rollout_crash@1", "publish_fail@1", "kv_exhaust@2x3:512",
                "nan_logits@3")
# (d) the load harness CLI (the reference's defaults: 4 slots, block 8,
# chunks of 16, horizon 4) and the fault its replay takes
LOADGEN_ARGS = ("--arch", "qwen2.5-1.5b", "--quick", "--seed", "0",
                "--policy", "slo", "--quiet")
LOADGEN_FAULT = "kv_exhaust@3x4:4096"


def _launch(train, argv):
    train.main(["--arch", "qwen2.5-1.5b", "--quiet"] + list(argv))


def _state_diff(torch, a, b):
    """What differs between two TrainStates, bit for bit: the leaves of the
    params and of Adam's m and v by path, and t and the version."""
    from repro_torch.training.optimizer import flatten
    diff = []
    for label, x, y in (("params", a.params, b.params),
                        ("m", a.opt["m"], b.opt["m"]),
                        ("v", a.opt["v"], b.opt["v"])):
        fx, fy = flatten(x), flatten(y)
        diff += [f"{label}/{k}" for k in fx
                 if not torch.equal(fx[k].detach(), fy[k].detach())]
    if int(a.opt["t"]) != int(b.opt["t"]):
        diff.append("t")
    if int(a.version) != int(b.version):
        diff.append("version")
    return diff


@contextlib.contextmanager
def _timed_checkpoints(torch):
    """Time every CheckpointManager save (from a synchronised device to
    the committed pair, its npz size beside it) and restore (to the state
    on the device)."""
    from repro_torch.resilience.checkpoint import CheckpointManager
    saves, restores = [], []
    save, restore = CheckpointManager.save, CheckpointManager.restore

    def timed_save(self, step, state, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(self, step, state, **kw)
        saves.append({"step": step, "s": time.perf_counter() - t0,
                      "bytes": os.path.getsize(path + ".npz")})
        return path

    def timed_restore(self, base_path, device="cuda"):
        t0 = time.perf_counter()
        info = restore(self, base_path, device)
        torch.cuda.synchronize()
        restores.append({"step": info.step, "s": time.perf_counter() - t0})
        return info

    CheckpointManager.save, CheckpointManager.restore = (timed_save,
                                                         timed_restore)
    try:
        yield saves, restores
    finally:
        CheckpointManager.save, CheckpointManager.restore = save, restore


def _copy_resume(torch, info):
    """A ResumeInfo whose trees are copies on the same device."""
    from repro_torch.models.params import ParamTree
    from repro_torch.training import TrainState
    from repro_torch.training.optimizer import flatten, unflatten

    def copy(tree, params=False):
        flat = unflatten({k: v.detach().clone()
                          for k, v in flatten(tree).items()})
        return ParamTree(flat, requires_grad=True) if params else flat
    st = info.state
    return dataclasses.replace(
        info, state=TrainState(
            copy(st.params, True),
            {"m": copy(st.opt["m"]), "v": copy(st.opt["v"]),
             "t": st.opt["t"].clone()}, st.version.clone()),
        history=[(copy(p, True), v) for p, v in info.history])


@contextlib.contextmanager
def _scaled_launcher(torch, train, cfg, kept, scale=None, top_p=None):
    """The launcher's sim engine with the task's rewards as seeded
    Bernoulli draws from the task's RNG, its fresh initial state (seed 7,
    as simulate_async makes it) with the layer weights x8 (or ``scale``
    applied to its parameters), ``cfg`` for the architecture, rollouts
    sampled at ``top_p`` where it is given, and what simulate_async was
    given and returned kept in ``kept`` ("state", "resilience"; with
    ``kept["call"]`` set, a resumed run's arguments and a copy of its
    ResumeInfo as they came in replace it)."""
    from repro_torch.training import Trainer
    plain = train.ArithmeticTask, train.simulate_async, train.get_config

    def sim(cfg_, rl, task, algo, num_steps, **kw):
        resume = kw.get("resume")
        if top_p is not None:
            rl = dataclasses.replace(rl, top_p=top_p)
        if resume is None:
            dev = kw["device"]
            state = Trainer(cfg_, rl, algo).init_state(
                torch.Generator(device=dev).manual_seed(7), device=dev)
            with torch.no_grad():
                if scale is None:
                    _scale_blocks(torch, state.params, SCALE)
                else:
                    scale(state.params)
            kw["init_state"] = state
        elif "call" in kept:
            kept["call"] = (cfg_, rl, type(task), algo, num_steps,
                            dict(kw, resume=_copy_resume(torch, resume)))
        kept["resilience"] = kw.get("resilience")
        kept["state"], recs = plain[1](cfg_, rl, task, algo, num_steps, **kw)
        return kept["state"], recs

    train.ArithmeticTask, train.simulate_async, train.get_config = (
        _coin_task_class(), sim, lambda name: cfg)
    try:
        yield
    finally:
        train.ArithmeticTask, train.simulate_async, train.get_config = plain


@contextlib.contextmanager
def _scaled_orchestrator(torch, train, kept, scale=None):
    """The launcher's --engine async with the task's rewards as seeded
    Bernoulli draws and its initial state's layer weights x8 (or ``scale``
    applied to its parameters); the orchestrator and its final state kept
    in ``kept``."""
    from repro_torch.async_rl.orchestrator import AsyncOrchestrator

    class ScaledOrchestrator(AsyncOrchestrator):
        def run(self, state, num_steps, **kw):
            with torch.no_grad():
                if scale is None:
                    _scale_blocks(torch, state.params, SCALE)
                else:
                    scale(state.params)
            kept["orch"] = self
            kept["state"], recs = super().run(state, num_steps, **kw)
            return kept["state"], recs

    plain = train.ArithmeticTask, train.AsyncOrchestrator
    train.ArithmeticTask, train.AsyncOrchestrator = (_coin_task_class(),
                                                     ScaledOrchestrator)
    try:
        yield
    finally:
        train.ArithmeticTask, train.AsyncOrchestrator = plain


def _path_counts(kinds):
    counts = _all_counts()
    return {k: counts[k] for k in kinds}


TRAIN_PATH = ("flash_attention", "decode_attention", "token_logprob_entropy",
              "token_logprob_entropy_bwd", "a3po_loss", "a3po_loss_bwd")
ASYNC_PATH = ("paged_decode_attention", "paged_prefill_attention",
              "token_logprob_entropy", "token_logprob_entropy_bwd",
              "a3po_loss", "a3po_loss_bwd")
SERVE_PATH = ("paged_decode_attention", "paged_prefill_attention")


def phase_resume(torch, tmp):
    """(a) The launcher at Qwen2.5-1.5B, full width, 4 layers, a3po at
    staleness 1, layer weights x8, seeded Bernoulli rewards: run A
    uninterrupted (--steps 4 --ckpt-every 2), run B the same with
    --fault train_crash@3 (must raise InjectedFault), run C --resume auto
    on B's directory (must resume at step 2; it commits no checkpoint of
    its own). C's final params, Adam m, v and t, and version equal A's bit
    for bit, and so do the step-2 and step-3 records; the same resume with
    the rollout generator's state left behind (a copy of C's ResumeInfo)
    must not. Prints the bytes, save and restore seconds of each
    checkpoint and the free disk at the start. Returns run A's
    launches."""
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.obs.runlog import read_jsonl
    from repro_torch.resilience import InjectedFault

    t_phase = time.perf_counter()
    free0 = shutil.disk_usage(tmp).free
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b"),
                              num_layers=RES_LAYERS)
    dir_a, dir_b = tmp / "ckpt_a", tmp / "ckpt_b"
    base = ["--steps", str(RES_STEPS), "--staleness", "1",
            "--ckpt-every", str(RES_CKPT_EVERY)]
    logs = {k: str(tmp / f"resume_{k}.jsonl") for k in "abc"}
    kept = {}
    with _scaled_launcher(torch, train, cfg, kept), \
            _timed_checkpoints(torch) as (saves, restores):
        _reset_counts()
        t0 = time.perf_counter()
        _launch(train, base + ["--ckpt-dir", str(dir_a),
                               "--log-jsonl", logs["a"]])
        run_a_s = time.perf_counter() - t0
        launches = _path_counts(TRAIN_PATH)
        state_a = kept.pop("state")
        shutil.rmtree(dir_a)  # compared from memory from here on
        try:
            _launch(train, base + ["--ckpt-dir", str(dir_b), "--fault",
                                   f"train_crash@{RES_CRASH_AT}",
                                   "--log-jsonl", logs["b"]])
        except InjectedFault as e:  # the fault this run exists to raise
            crash = str(e)
        else:
            raise AssertionError("resume: train_crash did not raise")
        kept["call"] = None
        t0 = time.perf_counter()
        _launch(train, ["--steps", str(RES_STEPS), "--staleness", "1",
                        "--ckpt-dir", str(dir_b), "--resume", "auto",
                        "--log-jsonl", logs["c"]])
        run_c_s = time.perf_counter() - t0
        diff = _state_diff(torch, state_a, kept.pop("state"))
    shutil.rmtree(dir_b)
    # teeth: C's resume again, the generator as seeded
    cfg_, rl, task_cls, algo, steps, kw = kept.pop("call")
    kw["resume"].generator_state = None
    state_d, recs_d = train.simulate_async(
        cfg_, rl, task_cls(max_operand=9, n_terms=2, prompt_len=8), algo,
        steps, **dict(kw, run_logger=None))
    teeth = _state_diff(torch, state_a, state_d)
    del state_d, kw
    recs = {k: read_jsonl(p) for k, p in logs.items()}
    resumed = read_jsonl(logs["c"], kind="resume")
    keys = ("loss", "reward", "iw_max", "iw_min", "entropy")

    def rows(k, steps):
        return [[r[x] for x in keys] for r in recs[k] if r["step"] in steps]
    rec = {"phase": "resilience_resume", "model": cfg.name,
           "layers": RES_LAYERS, "dtype": "bfloat16",
           "layer_weight_scale": SCALE, "algo": "a3po", "staleness": 1,
           "rewards": "seeded Bernoulli(0.5) from the task's RNG",
           "steps": RES_STEPS, "ckpt_every": RES_CKPT_EVERY,
           "crash": crash, "free_disk_gb_at_start": free0 / 1e9,
           "saves": saves, "restores": restores,
           "bytes_per_save": [s["bytes"] for s in saves],
           "run_a_s": run_a_s, "run_c_s": run_c_s,
           "steps_by_run": dict({k: [r["step"] for r in v]
                                 for k, v in recs.items()},
                                d=[r.step for r in recs_d]),
           "resumed_at": [r["step"] for r in resumed],
           "first_steps_a_equal_b": rows("a", (0, 1)) == rows("b", (0, 1)),
           "records_equal_after_resume": rows("a", (2, 3))
           == rows("c", (2, 3)),
           "bit_equal": not diff, "differing": diff[:24],
           "n_differing": len(diff),
           "unrestored_generator_differs": bool(teeth),
           "unrestored_generator_n_differing": len(teeth),
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    if (diff or not teeth or not rec["records_equal_after_resume"]
            or rec["resumed_at"] != [2]
            or rec["steps_by_run"]["c"] != [2, 3]
            or rec["steps_by_run"]["a"] != list(range(RES_STEPS))
            or len(saves) != 3 or len(restores) != 1
            or any(v <= 0 for v in launches.values())):
        raise AssertionError(f"resume: {rec}")
    del state_a, kept
    torch.cuda.empty_cache()
    return launches


def phase_guard(torch, tmp):
    """(b) The launcher at Qwen2.5-1.5B, full width and depth, layer
    weights x8, seeded Bernoulli rewards, --fault nan_grad@1 --guard skip:
    one reward of step 1 is NaN, which poisons its group's minibatch (the
    step's other minibatch holds no NaN); the guard skips exactly that
    update, which leaves the params and the whole Adam state (m, v, t) bit
    for bit as they were before it; every param stays finite, the nan_grad
    counter counts the fault. The logprob and A-3PO kernels run on the
    non-finite inputs. Returns the run's launches."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.obs.runlog import read_jsonl
    from repro_torch.training import trainer
    from repro_torch.training.optimizer import flatten

    t_phase = time.perf_counter()
    cfg = get_config("qwen2.5-1.5b")
    log = str(tmp / "guard.jsonl")
    kept, updates = {}, []
    plain_update = trainer.adam_update

    def update(grads, opt, params, rl, **kw):
        """Each guarded minibatch update: the moments and t before it, and
        for an update the guard dropped, whether params and the Adam
        state came out bit for bit as they went in."""
        mv = {k: t.clone() for k, t in flatten(
            {"m": opt["m"], "v": opt["v"]}).items()}
        t_before = opt["t"].clone()
        out = plain_update(grads, opt, params, rl, **kw)
        applied = bool(kw["apply"])
        rec = {"applied": applied}
        if not applied:
            new, old = flatten(out[0]), flatten(params)
            now = flatten({"m": opt["m"], "v": opt["v"]})
            rec.update(
                params_same=all(torch.equal(new[k], old[k]) for k in old),
                adam_same=all(torch.equal(now[k], mv[k]) for k in now)
                and torch.equal(opt["t"], t_before))
        updates.append(rec)
        del mv
        return out

    trainer.adam_update = update
    try:
        with _scaled_launcher(torch, train, cfg, kept):
            _reset_counts()
            t0 = time.perf_counter()
            _launch(train, ["--steps", "3", "--fault", "nan_grad@1",
                            "--guard", "skip", "--log-jsonl", log])
            elapsed = time.perf_counter() - t0
            launches = _path_counts(TRAIN_PATH)
    finally:
        trainer.adam_update = plain_update
    recs = read_jsonl(log)
    guard = kept["resilience"].guard
    finite = all(bool(torch.isfinite(t).all())
                 for t in flatten(kept["state"].params).values())
    snap = recs[-1]["resilience"]
    skipped = [i for i, u in enumerate(updates) if not u["applied"]]
    rec = {"phase": "resilience_guard", "model": cfg.name,
           "layers": cfg.num_layers, "dtype": "bfloat16",
           "layer_weight_scale": SCALE, "steps": len(recs),
           "elapsed_s": elapsed, "minibatch_updates": updates,
           "skipped_update_index": skipped,
           "skipped_updates": guard.skipped_updates,
           "loss": [r["loss"] for r in recs],
           "nan_grad_injected": snap.get(
               'resilience_faults_injected_total{kind="nan_grad"}', 0.0),
           "skipped_updates_counter": snap.get(
               "resilience_skipped_updates_total", 0.0),
           "params_finite": finite, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    # 3 steps x 2 minibatches; step 1's poisoned one is update 2 or 3
    if (guard.skipped_updates != 1 or len(updates) != 6
            or len(skipped) != 1 or skipped[0] not in (2, 3)
            or not updates[skipped[0]]["params_same"]
            or not updates[skipped[0]]["adam_same"] or not finite
            or rec["nan_grad_injected"] < 1 or not np.isfinite(
                recs[-1]["loss"])
            or any(v <= 0 for v in launches.values())):
        raise AssertionError(f"guard: {rec}")
    del kept
    torch.cuda.empty_cache()
    return launches


def _time_paged(torch, seen, label):
    """Paged decode and prefill timed on the inputs of their last call in
    a run, beside their plain versions, SDPA over K/V gathered to dense,
    and the bound for the keys these inputs hold (each row's keys once,
    each segment's pages once)."""
    from repro_torch.kernels.decode_attn.ops import paged_decode_attention_op
    from repro_torch.kernels.decode_attn.ref import paged_decode_attention_ref
    from repro_torch.kernels.prefill_attn.ops import (
        paged_prefill_attention_op,
    )
    from repro_torch.kernels.prefill_attn.ref import (
        paged_prefill_attention_ref,
    )
    timer = Timer(torch)
    out = {}
    with torch.no_grad():
        if "paged_decode_attention" in seen:
            (q, pk, pv, tables, lens), _ = seen["paged_decode_attention"]
            dname = str(pk.dtype).split(".")[-1]
            S, H, hd = q.shape
            KV = pk.shape[2]
            n_keys = int(lens.clamp_min(0).sum())
            nbytes = (2 * q.numel() * q.element_size()
                      + 2 * n_keys * KV * hd * pk.element_size()
                      + tables.numel() * 4 + lens.numel() * 4)
            rec = {"phase": "kernel", "name": "paged_decode_attention",
                   "case": label, "dtype": dname,
                   "shape": {"S": S, "H": H, "KV": KV, "hd": hd,
                             "bs": pk.shape[1], "mb": tables.shape[1],
                             "keys": n_keys}}
            rec.update(_times(
                torch, timer, dname, nbytes, 4 * H * hd * n_keys,
                lambda: paged_decode_attention_op(q, pk, pv, tables, lens),
                lambda: paged_decode_attention_ref(q, pk, pv, tables, lens),
                _sdpa_dense(torch, q, pk, pv, tables, lens)))
            emit(rec)
            out["paged_decode_attention"] = rec
        if "paged_prefill_attention" in seen:
            (q, pk, pv, tables, seg, pos), _ = seen[
                "paged_prefill_attention"]
            dname = str(pk.dtype).split(".")[-1]
            C, H, hd = q.shape
            KV = pk.shape[2]
            pad = seg < 0
            row_keys = torch.where(pad, 0, pos + 1)
            seg_keys = sum(int(row_keys[seg == s].max())
                           for s in torch.unique(seg[~pad]).tolist())
            nbytes = (2 * q.numel() * q.element_size()
                      + 2 * seg_keys * KV * hd * pk.element_size()
                      + tables.numel() * 4 + 2 * C * 4)
            rec = {"phase": "kernel", "name": "paged_prefill_attention",
                   "case": label, "dtype": dname,
                   "shape": {"C": C, "H": H, "KV": KV, "hd": hd,
                             "bs": pk.shape[1], "mb": tables.shape[1],
                             "pad_rows": int(pad.sum()),
                             "row_keys": int(row_keys.sum()),
                             "segment_keys": seg_keys}}
            rec.update(_times(
                torch, timer, dname, nbytes,
                4 * H * hd * int(row_keys.sum()),
                lambda: paged_prefill_attention_op(q, pk, pv, tables, seg,
                                                   pos),
                lambda: paged_prefill_attention_ref(q, pk, pv, tables, seg,
                                                    pos),
                _sdpa_dense(torch, q, pk, pv,
                            tables[seg.clamp_min(0).long()], row_keys),
                plain_iters=5))
            emit(rec)
            out["paged_prefill_attention"] = rec
    del timer
    return out


def phase_async_faults(torch, tmp):
    """(c) `--engine async` at Qwen2.5-1.5B, full width and depth, layer
    weights x8, seeded Bernoulli rewards, under a rollout crash, a failed
    publish, KV blocks held hostage and a poisoned logits row: every step
    completes, the worker was restarted, each fault fired, no trained
    batch carries a non-finite behaviour logp, the hold ended, both paged
    kernels (and both training kernels) ran, and the port's
    obs.validate accepts the run log; the paged kernels held against
    their plain versions and timed on the inputs of their last call.
    Returns the run's launches and the kernels' times."""
    import numpy as np
    from repro_torch.async_rl import orchestrator as orch_mod
    from repro_torch.launch import train
    from repro_torch.obs.runlog import read_jsonl
    from repro_torch.obs.validate import validate_jsonl

    t_phase = time.perf_counter()
    kept, nonfinite = {}, []

    def assemble(batches, rewards, **kw):
        nonfinite.append(sum(int((~np.isfinite(b.gen_logp)).sum())
                             for b in batches))
        return plain_assemble(batches, rewards, **kw)

    log = str(tmp / "async_faults.jsonl")
    plain_assemble = orch_mod.assemble_train_batch
    orch_mod.assemble_train_batch = assemble
    argv = ["--steps", "4", "--staleness", "2", "--engine", "async",
            "--log-jsonl", log]
    for f in ASYNC_FAULTS:
        argv += ["--fault", f]
    try:
        with _scaled_orchestrator(torch, train, kept), \
                _capture_ops(torch, _paged_sites()) as seen:
            _reset_counts()
            t0 = time.perf_counter()
            _launch(train, argv)
            elapsed = time.perf_counter() - t0
            launches = _path_counts(ASYNC_PATH)
    finally:
        orch_mod.assemble_train_batch = plain_assemble
    recs = read_jsonl(log)
    orch = kept["orch"]
    cp = orch.control_plane
    snap = recs[-1]["resilience"] if recs else {}
    injected = {f.split("@")[0]: snap.get(
        f'resilience_faults_injected_total{{kind="{f.split("@")[0]}"}}', 0.0)
        for f in ASYNC_FAULTS}
    errors = validate_jsonl(log, min_steps=4)
    rec = {"phase": "resilience_async", "model": orch.cfg.name,
           "layers": orch.cfg.num_layers, "dtype": "bfloat16",
           "faults": list(ASYNC_FAULTS), "steps": [r["step"] for r in recs],
           "elapsed_s": elapsed, "injected": injected,
           "worker_restarts": snap.get("resilience_worker_restarts_total"),
           "publish_retries": snap.get("resilience_publish_retries_total"),
           "worker_crashes": [c.exc_type for c in orch.worker.crashes],
           "nonfinite_behaviour_logps": nonfinite,
           "kv_holds_after": len(cp._kv_holds),
           "oom_sheds": cp.metrics.oom_sheds,
           "nan_drops": cp.metrics.nan_drops,
           "staleness": [r["staleness_mean"] for r in recs],
           "validate_errors": errors, "launches": launches}
    emit(rec)
    if (rec["steps"] != [0, 1, 2, 3] or not rec["worker_restarts"]
            or any(v < 1 for v in injected.values()) or sum(nonfinite)
            or not nonfinite or cp._kv_holds or errors
            or orch.worker.alive
            or any(v <= 0 for v in launches.values())):
        raise AssertionError(f"async under faults: {rec}")
    held = _hold_paged_kernels(torch, seen)
    timed = _time_paged(torch, seen, "engine_async_faults")
    emit({"phase": "resilience_async_checks", "kernels": held,
          "phase_s": time.perf_counter() - t_phase})
    del seen, kept, orch, cp
    torch.cuda.empty_cache()
    return launches, timed


def phase_loadgen(torch, tmp, smi):
    """(d) `python -m repro_torch.loadgen --arch qwen2.5-1.5b --quick`
    (float32, full width and depth, seeded weights, the paged engine
    through the serving control plane on a virtual clock) twice with one
    seed: the lifecycle JSONL files byte-identical and valid under the
    port's validate_loadgen_jsonl; the paged kernels held and timed on the
    inputs of their last call. One replay with --fault kv_exhaust@…. Then
    fit_cost_model on the card at the replay's geometry, its coefficients
    printed beside the card's name and power limit. Returns the first
    replay's launches and the kernels' times."""
    import filecmp
    import json as _json
    from repro_torch.configs.registry import get_config
    from repro_torch.loadgen.__main__ import main as loadgen_main
    from repro_torch.loadgen.costfit import describe, fit_cost_model
    from repro_torch.models import model as M
    from repro_torch.obs.validate import validate_loadgen_jsonl

    t_phase = time.perf_counter()
    paths = [tmp / f"loadgen_{i}.jsonl" for i in range(3)]
    walls, launches = [], None
    for i, path in enumerate(paths):
        argv = list(LOADGEN_ARGS) + ["--jsonl", str(path)]
        if i == 2:
            argv += ["--fault", LOADGEN_FAULT]
        with _capture_ops(torch, _paged_sites()) as seen:
            _reset_counts()
            t0 = time.perf_counter()
            if loadgen_main(argv) != 0:
                raise AssertionError(f"loadgen {argv} failed")
            walls.append(time.perf_counter() - t0)
            counts = _path_counts(SERVE_PATH)
        if i == 0:
            launches, first = counts, seen
    summaries = [[_json.loads(ln) for ln in p.read_text().splitlines()
                  if '"load_summary"' in ln][0] for p in paths]
    rec = {"phase": "loadgen", "args": list(LOADGEN_ARGS),
           "wall_s": walls, "launches": launches,
           "identical_jsonl": filecmp.cmp(paths[0], paths[1], shallow=False),
           "validate_errors": [validate_loadgen_jsonl(str(p), min_requests=5)
                               for p in paths],
           "summary": {k: summaries[0][k] for k in (
               "requests", "completed", "dropped", "steps",
               "virtual_time_s")},
           "fault": LOADGEN_FAULT,
           "fault_summary": {k: summaries[2][k] for k in (
               "requests", "completed", "dropped", "steps",
               "virtual_time_s")}}
    emit(rec)
    if (not rec["identical_jsonl"] or any(rec["validate_errors"])
            or any(v <= 0 for v in launches.values())
            or summaries[2]["completed"] + summaries[2]["dropped"]
            != summaries[2]["requests"]):
        raise AssertionError(f"loadgen: {rec}")
    held = _hold_paged_kernels(torch, first)
    timed = _time_paged(torch, first, "loadgen_replay")
    emit({"phase": "loadgen_checks", "kernels": held})
    del first

    cfg = dataclasses.replace(get_config("qwen2.5-1.5b"), dtype="float32")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    cost = fit_cost_model(cfg, params, max_seqs=4, decode_horizon=4,
                          prefill_chunk=16, block_size=8, device="cuda")
    fit = {"phase": "loadgen_cost_fit", "model": cfg.name,
           "dtype": "float32", "card": smi,
           "geometry": {"max_seqs": 4, "decode_horizon": 4,
                        "prefill_chunk": 16, "block_size": 8},
           "cost": dataclasses.asdict(cost), "describe": describe(cost),
           "fit_s": time.perf_counter() - t0,
           "phase_s": time.perf_counter() - t_phase}
    emit(fit)
    if min(dataclasses.astuple(cost)) <= 0:
        raise AssertionError(f"cost fit: {fit}")
    del params
    torch.cuda.empty_cache()
    return launches, timed


@contextlib.contextmanager
def _plain_training_ops():
    """Both training ops on their plain versions (``use_kernel=False``), as
    a check: the training path itself never passes it."""
    from repro_torch.core import objective
    from repro_torch.training import trainer
    saved = objective.a3po_objective_reduced, trainer.token_logprob_entropy
    objective.a3po_objective_reduced = functools.partial(saved[0],
                                                         use_kernel=False)
    trainer.token_logprob_entropy = functools.partial(saved[1],
                                                      use_kernel=False)
    try:
        yield
    finally:
        objective.a3po_objective_reduced, \
            trainer.token_logprob_entropy = saved


def phase_training_f32(torch):
    import numpy as np
    from repro_torch.configs.base import RLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.training import (
        Trainer,
        TrainState,
        adam_init,
        assemble_train_batch,
        score_tokens,
    )
    from repro_torch.training.optimizer import flatten
    from repro_torch.training.trainer import METRIC_KEYS

    cfg = dataclasses.replace(get_config("qwen2.5-1.5b"), dtype="float32",
                              num_layers=F32_LAYERS)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                           device="cuda", dtype=torch.float32,
                           requires_grad=True)
    with torch.no_grad():
        _scale_blocks(torch, params, SCALE)
    rb, rewards, _ = _serve_group_batch(torch, cfg, params, 12, np)
    batch = assemble_train_batch([rb], rewards, device="cuda")
    # at staleness 0 the trainer scores what the engine sampled
    logp = score_tokens(params, cfg, batch.tokens)[0]
    mask = batch.response_mask > 0
    logp_err = (logp - batch.behav_logp)[mask].abs().max().item()
    if logp_err > F32_LOGP_TOL:
        raise AssertionError(f"trainer vs engine logp: {logp_err}")
    rl = RLConfig(group_size=GROUP, num_minibatches=4, learning_rate=1e-3,
                  adam_eps=1e-4)
    state = TrainState(params, adam_init(params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    clone = copy.deepcopy(state)
    _reset_counts()
    s_k, m_k = Trainer(cfg, rl, "a3po").step(state, batch)
    kernel_launches = dict(_all_counts())
    with _plain_training_ops():
        s_p, m_p = Trainer(cfg, rl, "a3po").step(clone, batch)
    if _all_counts() != kernel_launches or \
            kernel_launches["a3po_loss"] == 0 or \
            kernel_launches["token_logprob_entropy"] == 0 or \
            kernel_launches["token_logprob_entropy_bwd"] == 0 or \
            kernel_launches["token_logprob_entropy_bwd_wgmma"] != 0:
        raise AssertionError(f"kernel / plain step launches: "
                             f"{kernel_launches} then {_all_counts()}")
    _check_metrics(np, m_k, METRIC_KEYS)
    metric_err = {}
    for k in METRIC_KEYS:
        metric_err[k] = abs(m_k[k] - m_p[k])
        if metric_err[k] > STEP_METRIC_TOL["atol"] \
                + STEP_METRIC_TOL["rtol"] * abs(m_p[k]):
            raise AssertionError(f"float32 step metric {k}: {m_k[k]} vs "
                                 f"{m_p[k]}")
    pk, pp, p0 = flatten(s_k.params), flatten(s_p.params), flatten(params)
    worst, moved = 0.0, 0.0
    for k in pk:
        err = (pk[k] - pp[k]).abs()
        tol = STEP_PARAM_TOL["atol"] + STEP_PARAM_TOL["rtol"] * pp[k].abs()
        worst = max(worst, (err / tol).max().item())
        moved = max(moved, (pp[k] - p0[k]).abs().max().item())
    if worst > 1.0:
        raise AssertionError(f"float32 step params: worst err/tol {worst}")
    emit({"phase": "training_float32", "layers": F32_LAYERS,
          "trainer_vs_engine_logp_max_abs_err": logp_err,
          "logp_tol": F32_LOGP_TOL, "metrics_kernel": m_k,
          "metric_abs_err": metric_err, "metric_tol": STEP_METRIC_TOL,
          "param_worst_err_over_tol": worst, "param_tol": STEP_PARAM_TOL,
          "param_max_update": moved, "launches_kernel_step":
          kernel_launches})


# ------------------------------------------------------------ SSM / hybrid
# The two SSD kernels at the serving shapes of both families: decode at 8
# slots, hd 64, (nh, ds) = (32, 128) for mamba2-370m and (64, 64) for
# zamba2-1.2b; the intra-chunk block (model, rows, length S, chunk, nh, ds)
# at 8 rows x chunk 256 and 8 x 64, at the shapes the paged engine
# launches: one prefilling slot's row, a full chunk of 256 (most of its
# launches) or a ragged tail (232: the last chunk of a 1000-token prompt),
# and at the dense generate's prefill: 16 rows padded to 1024, 4 chunks of
# 256. The kernels line carries the 1 x 256 mamba2 shape.
SSD_DECODE_SHAPES = (("mamba2-370m", 32, 128), ("zamba2-1.2b", 64, 64))
SSD_INTRA_SHAPES = (("mamba2-370m", 8, 256, 256, 32, 128),
                    ("mamba2-370m", 8, 64, 64, 32, 128),
                    ("zamba2-1.2b", 8, 256, 256, 64, 64),
                    ("mamba2-370m", 1, 256, 256, 32, 128),
                    ("mamba2-370m", 1, 232, 232, 32, 128),
                    ("zamba2-1.2b", 1, 256, 256, 64, 64),
                    ("zamba2-1.2b", 1, 232, 232, 64, 64),
                    ("mamba2-370m", 16, 1024, 256, 32, 128),
                    ("zamba2-1.2b", 16, 1024, 256, 64, 64))
SSD_INTRA_LINE = ("mamba2-370m", 1, 256, 256)
SSD_SLOTS, SSD_HD = 8, 64
# softplus'd dt of the test operands: log-uniform in [1e-3, 0.5]
LOG_DT_LO, LOG_DT_HI = math.log(1e-3), math.log(0.5)
# Intra-chunk kernel vs its plain version in float32 on the same values:
# float32 sums of up to 256 terms in another order, and the in-chunk
# cumsum in another order (its rounding moves a decay exp(cum_i - cum_j)
# by ~1e-5 relative at |cum| ~ 100): |out - ref| <= 1e-4 |ref| + 1e-4
# max|ref|. A reference without the diagonal j = i, or with an exclusive
# cumsum, moves the outputs by ~10% of their size and must fail it; so
# must one with M and xdt rounded to bf16 (2^-9 per term: the bf16 mma
# kernel's hi parts without its lo products). The kernel's cum is held
# against torch.cumsum within the same tolerance.
SSD_INTRA_RTOL = 1e-4
# At the reference's init stds both random models repeat their last token
# at logp ~0 (the tied embedding dominates), and at x2 and x4 they still
# do (mean logp -0.06 / -3.6 for mamba2, -0.32 / -2.0 for zamba2, one
# distinct token per request; NVIDIA H100). With every SSM block's in_proj
# and out_proj scaled x8 (not a_log or dt_bias), the layers decide the
# tokens (mean logp -6.2 / -5.2), as phase 4's x8 does for Qwen.
SSM_SCALE = {"mamba2-370m": 8.0, "zamba2-1.2b": 8.0}


def _ssd_decode_inputs(torch, g, nh, ds):
    """Decode operands as the serving path gives them: bf16 x, b, c and
    a_log (A uniform in [1, 16]), float32 state and softplus'd dt
    (log-uniform in [1e-3, 0.5])."""
    B, hd = SSD_SLOTS, SSD_HD

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    state = rnd(B, nh, hd, ds)
    x, b, c = (t.to(torch.bfloat16) for t in (rnd(B, nh, hd), rnd(B, ds),
                                              rnd(B, ds)))
    u = torch.rand(B, nh, generator=g, device="cuda")
    dt = torch.exp(u * (LOG_DT_HI - LOG_DT_LO) + LOG_DT_LO)
    a_log = torch.log(1.0 + 15.0 * torch.rand(
        nh, generator=g, device="cuda")).to(torch.bfloat16)
    return state, x, dt, a_log, b, c


def _ssd_intra_inputs(torch, g, B, S, nh, ds):
    """Intra-chunk operands as ssd_scan gives them: xdt = x * dt and la =
    -dt * A in float32 (x bf16 values, dt log-uniform in [1e-3, 0.5], A in
    [1, 16]), b / c bf16 slices of one conv output (strided rows)."""
    hd = SSD_HD
    x = torch.randn(B, S, nh, hd, generator=g, device="cuda").to(
        torch.bfloat16).float()
    u = torch.rand(B, S, nh, generator=g, device="cuda")
    dt = torch.exp(u * (LOG_DT_HI - LOG_DT_LO) + LOG_DT_LO)
    A = 1.0 + 15.0 * torch.rand(nh, generator=g, device="cuda")
    xbc = torch.randn(B, S, 2 * ds + 8, generator=g,
                      device="cuda").to(torch.bfloat16)
    return (x * dt[..., None]).contiguous(), -dt * A, xbc[..., :ds], \
        xbc[..., ds:2 * ds]


def _exclusive_la(torch, la, L):
    """la whose in-chunk inclusive cumsum is the exclusive cumsum of la."""
    B, S, nh = la.shape
    c = la.reshape(B, S // L, L, nh)
    return torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]],
                     dim=2).reshape(B, S, nh)


def _ssd_intra_hi_only(torch, xdt, la, b32, c32, L):
    """The plain intra-chunk block with the mma kernel's float32 operands
    rounded to bf16 and no remainder products: M and xdt for y, w * xdt
    for s_local (B is exact in bf16). The tolerance must fail it, or the
    kernel's lo products are not needed."""
    B, S, nh, hd = xdt.shape
    ds = b32.shape[-1]
    nc = S // L

    def hi(t):
        return t.to(torch.bfloat16).float()
    x = xdt.reshape(B, nc, L, nh, hd)
    cum = torch.cumsum(la.reshape(B, nc, L, nh), dim=2)
    bc = b32.reshape(B, nc, L, ds)
    cb = torch.einsum("bnis,bnjs->bnij", c32.reshape(B, nc, L, ds), bc)
    i = torch.arange(L, device=xdt.device)
    causal = (i[:, None] >= i[None, :])[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    m = cb[..., None] * torch.exp(torch.where(causal, seg, float("-inf")))
    y = torch.einsum("bnijh,bnjhd->bnihd", hi(m), hi(x))
    w = torch.exp(cum[:, :, -1:, :] - cum)
    s_local = torch.einsum("bnjhd,bnjs->bnhds", hi(w[..., None] * x), bc)
    return y.reshape(B, S, nh, hd), s_local


def _hold_ssd_decode(torch, state, x, dt, a_log, b, c):
    """The decode step on these operands held against its plain version in
    float32 (y at x's dtype's tolerance, the float32 state at float32's),
    with the decay left out as the wrong reference. Returns (y, new state,
    {"y": record, "state": record})."""
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_decode_step_ref
    y, new = sops.ssd_decode_step(state, x, dt, a_log, b, c)
    args32 = (state, x.float(), dt, a_log.float(), b.float(), c.float())
    y_ref, new_ref = ssd_decode_step_ref(*args32)
    y_w, new_w = ssd_decode_step_ref(
        *args32[:3], torch.full_like(args32[3], float("-inf")), *args32[4:])
    sub = {"y": {"name": "ssd_decode_step.y"},
           "state": {"name": "ssd_decode_step.state"}}
    _hold(torch, sub["y"], y, y_ref,
          TOL["bfloat16" if x.dtype == torch.bfloat16 else "float32"],
          {"decay_left_out": y_w})
    _hold(torch, sub["state"], new, new_ref, TOL["float32"],
          {"decay_left_out": new_w})
    return y, new, sub


def _ssd_decode_times(torch, timer, pool, state, x, dt, a_log, b, c):
    """The decode step timed in place on ``pool`` (a copy of ``state``)
    with every row updated, so the full state read and written, beside its
    plain version; no single PyTorch call computes it."""
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_decode_step_ref
    n = state.numel()
    return _times(
        torch, timer, "float32",
        2 * 4 * n + x.element_size() * (2 * x.numel() + 2 * b.numel())
        + 4 * dt.numel() + a_log.element_size() * a_log.numel(),
        5 * n,  # update: mul + fma; y: fma
        lambda: sops.ssd_decode_step(pool, x, dt, a_log, b, c, out=pool),
        lambda: ssd_decode_step_ref(state, x, dt, a_log, b, c), None,
        iters=50)


def _hold_ssd_intra(torch, xdt, la, b, c, L, cdec_wrong="exclusive_cumsum"):
    """The intra-chunk op on these operands (the scan's call: three outputs
    and the in-chunk cumsum) held against its plain version in float32
    within SSD_INTRA_RTOL, with wrong references: an exclusive cumsum, y
    without its diagonal, y and s_local from the bf16 hi parts alone
    (``_ssd_intra_hi_only``), and for cdec ``cdec_wrong``:
    the exclusive cumsum, or ``"first_decay_dropped"`` (a chunk that ends
    on pad steps, of zero log decay, has the same cdec under either
    cumsum). Returns the records by output."""
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
    B, S, nh, _ = xdt.shape
    nc = S // L
    outs = sops.ssd_intra_chunk_cum(xdt, la, b, c, L)
    b32, c32 = b.float(), c.float()
    ex_la = _exclusive_la(torch, la, L)
    cums = [torch.cumsum(t.reshape(B, nc, L, nh), dim=2).reshape(B, S, nh)
            for t in (la, ex_la)]
    refs = (*ssd_intra_chunk_ref(xdt, la, b32, c32, L), cums[0])
    excl = (*ssd_intra_chunk_ref(xdt, ex_la, b32, c32, L), cums[1])
    diag = (c32 * b32).sum(-1)[..., None, None] * xdt
    hi = _ssd_intra_hi_only(torch, xdt, la, b32, c32, L)
    sub = {}
    for i, label in enumerate(("y_intra", "s_local", "cdec", "cum")):
        wrong = {"exclusive_cumsum": excl[i]}
        if label == "y_intra":
            wrong["diagonal_dropped"] = refs[0] - diag
        if i < 2:
            wrong["hi_only"] = hi[i]
        if label == "cdec" and cdec_wrong == "first_decay_dropped":
            first = la.reshape(B, nc, L, nh)[:, :, 0]
            wrong = {cdec_wrong: refs[2] * torch.exp(-first)}
        tol = {"rtol": SSD_INTRA_RTOL,
               "atol": SSD_INTRA_RTOL * refs[i].abs().max().item()}
        sub[label] = {"name": f"ssd_intra_chunk.{label}"}
        _hold(torch, sub[label], outs[i], refs[i], tol, wrong)
    return sub


def _ssd_intra_times(torch, timer, xdt, la, b, c, L, iters, plain_iters):
    """The intra-chunk op timed as the scan calls it (the three outputs and
    cum) beside its plain version; no single PyTorch call computes it."""
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
    B, S, nh, hd = xdt.shape
    ds = b.shape[-1]
    nc = S // L
    pairs = L * (L + 1) // 2
    # xdt and la read, y and cum written; b / c read; s_local and cdec
    # written per chunk. C_i . B_j once per (batch, chunk); y and s_local
    # per head; float32 operands, so the tensor cores' TF32 rate bounds the
    # operations
    return _times(
        torch, timer, "tf32",
        4 * (2 * xdt.numel() + 2 * la.numel())
        + b.element_size() * (b.numel() + c.numel())
        + 4 * B * nc * (nh * hd * ds + nh),
        2 * B * nc * (pairs * ds + nh * pairs * hd + nh * L * hd * ds),
        lambda: sops.ssd_intra_chunk_cum(xdt, la, b, c, L),
        lambda: ssd_intra_chunk_ref(xdt, la, b, c, L), None,
        iters=iters, plain_iters=plain_iters)


def phase_ssd_kernels(torch):
    """Both SSD kernels on bf16 inputs (xdt and state float32, as the path
    gives them) against their plain versions in float32 on the same
    values, with wrong references the tolerance must fail by a wide
    margin, timed beside the bound and the plain version."""
    from repro_torch.kernels.ssd import ops as sops

    t_phase = time.perf_counter()
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(7)
    results = {}
    for model, nh, ds in SSD_DECODE_SHAPES:
        state, x, dt, a_log, b, c = _ssd_decode_inputs(torch, g, nh, ds)
        _, new, sub = _hold_ssd_decode(torch, state, x, dt, a_log, b, c)
        rec = {"phase": "kernel", "name": "ssd_decode_step", "model": model,
               "dtype": "bfloat16", "shape": {"B": SSD_SLOTS, "nh": nh,
                                              "hd": SSD_HD, "ds": ds},
               "library": "none (no single call)",
               "plan": dict(sops.PLANS["ssd_decode_step"])}
        # in place under the engine's emit mask: masked rows untouched
        pool = state.clone()
        update = torch.arange(SSD_SLOTS, device="cuda") % 4 != 3
        sops.ssd_decode_step(pool, x, dt, a_log, b, c, out=pool,
                             update=update)
        if not (torch.equal(pool[~update], state[~update])
                and torch.equal(pool[update], new[update])):
            raise AssertionError(f"ssd_decode_step in place: {rec}")
        rec.update(checks=sub, max_abs_err=max(
            s["max_abs_err"] for s in sub.values()))
        rec.update(_ssd_decode_times(torch, timer, pool, state, x, dt, a_log,
                                     b, c))
        # a yardstick of what such traffic costs: an elementwise PyTorch
        # pass that reads and writes the same state in place
        rec["stream_ms"] = timer.ms(lambda: pool.mul_(1.0), iters=50)
        if model == "mamba2-370m":
            results["ssd_decode_step"] = rec
        emit(rec)
    for model, B, S, L, nh, ds in SSD_INTRA_SHAPES:
        xdt, la, b, c = _ssd_intra_inputs(torch, g, B, S, nh, ds)
        sub = _hold_ssd_intra(torch, xdt, la, b, c, L)
        rec = {"phase": "kernel", "name": "ssd_intra_chunk", "model": model,
               "dtype": "bfloat16 b/c, float32 xdt/la",
               "shape": {"B": B, "S": S, "chunk": L, "nh": nh, "hd": SSD_HD,
                         "ds": ds}, "library": "none (no single call)",
               "plan": dict(sops.PLANS["ssd_intra_chunk"]), "checks": sub,
               # the kernels line's error: the three outputs the parent
               # wrote too (cum's, at |cum| up to ~10^2, is in its own check)
               "max_abs_err": max(sub[k]["max_abs_err"]
                                  for k in ("y_intra", "s_local", "cdec"))}
        rec.update(_ssd_intra_times(torch, timer, xdt, la, b, c, L, 20, 5))
        if (model, B, S, L) == SSD_INTRA_LINE:
            results["ssd_intra_chunk"] = rec
        emit(rec)
    emit({"phase": "ssd_kernels_done",
          "phase_s": time.perf_counter() - t_phase})
    return results


def _scale_ssm(params, factor):
    """Scale every SSM block's in_proj and out_proj in place."""
    if factor == 1.0:
        return
    tree = params["blocks"] if "blocks" in params else params["ssm_blocks"]
    for name in ("in_proj", "out_proj"):
        tree["ssm"][name].mul_(factor)


def _rollout_ragged(torch, M, cfg, params, reqs):
    """One dense RolloutEngine.generate of ``reqs`` right-padded to the
    longest (prompts of unequal length), every token and behaviour logp
    held against forward_logits. Returns (record, launches)."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.rollout.engine import RolloutEngine

    P = max(len(r) for r in reqs)
    prompts = np.zeros((len(reqs), P), np.int32)
    lengths = np.array([len(r) for r in reqs], np.int32)
    for i, r in enumerate(reqs):
        prompts[i, : len(r)] = r
    engine = RolloutEngine(cfg, max_new_tokens=MAX_NEW)
    _reset_counts()
    t0 = time.perf_counter()
    rb = engine.generate(params, prompts, lengths, greedy=True)
    elapsed = time.perf_counter() - t0
    launches = {k: v for k, v in _all_counts().items() if v}
    done = []
    for i, r in enumerate(reqs):
        n = int(rb.gen_mask[i].sum())
        gen = rb.tokens[i, len(r): len(r) + n]
        if n != MAX_NEW and gen[-1] != 2:
            raise AssertionError(f"rollout row {i}: mask {rb.gen_mask[i]}")
        done.append(SimpleNamespace(rid=i, prompt=r, generated=gen.tolist(),
                                    gen_logp=rb.gen_logp[i, :n].tolist()))
    checks = _reference_checks(torch, M, cfg, params, done, ENGINE_GAP_TOL,
                               ENGINE_LOGP_TOL)
    return {"batch": list(prompts.shape), "elapsed_s": elapsed,
            "tokens_per_s": int(rb.gen_mask.sum()) / elapsed,
            "launches": launches, "reference_checks": checks}


def phase_ssm_serving(torch, name):
    """One SSM / hybrid model at full width and depth, bf16, seeded random
    weights: the paged engine serves 16 requests through 8 slots (horizon
    8, greedy, prefill chunks of 256), every token and behaviour logp held
    against the whole-sequence forward_logits (which runs the intra-chunk
    kernel; the engine's decode runs the decode kernel); the same in
    float32; one dense RolloutEngine.generate over the ragged prompts; the
    traced prefill / decode split, the device idle share and peak memory.
    Returns the SSD kernels' launches in the served run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.obs.tracing import phase_breakdown

    t_phase = time.perf_counter()
    cfg = get_config(name)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.bfloat16)
    _scale_ssm(params, SSM_SCALE[name])
    prompts = _requests(cfg)
    _serve(torch, cfg, params, prompts[:2])  # warm-up
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    # what is already allocated (the weights, and anything earlier phases
    # still hold) counts in the peak; reported beside it
    base_gb = torch.cuda.memory_allocated() / 1e9
    eng, done, elapsed = _serve(torch, cfg, params, prompts)
    kinds = ["ssd_decode_step", "ssd_intra_chunk"]
    if cfg.arch_type == "hybrid":
        kinds += ["paged_decode_attention", "paged_prefill_attention"]
    launches = {k: _all_counts()[k] for k in kinds}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if min(launches.values()) <= 0:
        raise AssertionError(f"{name}: a kernel was not launched: "
                             f"{launches}")
    _check_served(eng, done, prompts)
    if eng.ssm_pool.n_free != ENGINE_KW["max_seqs"]:
        raise AssertionError(f"{name}: SSM slots not released: "
                             f"{eng.ssm_pool.mapped}")
    checks = _reference_checks(torch, M, cfg, params, done, ENGINE_GAP_TOL,
                               ENGINE_LOGP_TOL)
    n_gen = sum(len(r.generated) for r in done)
    n_prompt = sum(len(r.prompt) for r in done)
    emit({"phase": "ssm_serving", "model": name, "layers": cfg.num_layers,
          "block_kinds": {k: cfg.block_kinds().count(k)
                          for k in ("ssm", "attn")},
          "params_b": sum(t.numel() for t in params.parameters()) / 1e9,
          "dtype": "bfloat16", "ssm_proj_scale": SSM_SCALE[name],
          "engine": ENGINE_KW, "max_new": MAX_NEW, "requests": len(done),
          "prompt_tokens": n_prompt, "generated_tokens": n_gen,
          "elapsed_s": elapsed, "tokens_per_s": n_gen / elapsed,
          "prefill_chunks": eng.prefill_launches,
          "decode_launches": eng.decode_launches,
          "host_syncs": eng.host_syncs, "launches": launches,
          "peak_mem_gb": peak_gb, "allocated_before_gb": base_gb,
          "reference_checks": checks})
    del eng

    params.to(torch.float32)  # exact both ways for bf16 values
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    eng32, done32, _ = _serve(torch, cfg32, params, prompts)
    _check_served(eng32, done32, prompts)
    del eng32
    emit({"phase": "ssm_serving_float32", "model": name,
          "reference_checks": _reference_checks(
              torch, M, cfg32, params, done32, F32_TOL, F32_TOL)})
    params.to(torch.bfloat16)

    emit(dict({"phase": "ssm_rollout", "model": name},
              **_rollout_ragged(torch, M, cfg, params, prompts)))

    tracer = _sync_tracer(torch)
    _, done3, elapsed2 = _serve(torch, cfg, params, prompts, tracer=tracer)
    br = phase_breakdown(tracer.events())
    pre, dec = br["prefill"], br["decode"]
    same = all(a.generated == b.generated for a, b in zip(
        sorted(done, key=lambda r: r.rid), sorted(done3, key=lambda r: r.rid)))
    if not same:
        raise AssertionError(f"{name}: traced run generated other tokens")

    def run():
        _, _, t = _serve(torch, cfg, params, prompts[:8])
        return t
    prof = _device_profile(torch, run)
    emit(dict({"phase": "ssm_serving_traced", "model": name,
               "elapsed_s": elapsed2, "prefill_s": pre["total_s"],
               "prefill_chunks": pre["count"],
               "prefill_tokens_per_s": n_prompt / pre["total_s"],
               "decode_s": dec["total_s"], "decode_horizons": dec["count"],
               "decode_tokens_per_s": n_gen / dec["total_s"],
               "same_tokens_as_untraced": same,
               "profile_requests": 8,
               "phase_s": time.perf_counter() - t_phase}, **prof))
    del params
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------- MoE, MLA and the frontends
MOE_PROMPTS = 8
MOE_PROMPT_PAD = 256
MOE_MAX_NEW = 16
# The MoE stacks scale their FFN (router and experts) x8 and keep the
# attention at its init std: with qwen3-moe's attention x8 (or x2, x4)
# the sharp scores make every greedy request repeat one token (1-4
# distinct tokens in 16, measured on the H100 over the 8 prompts), with
# it at x1 and the FFN at x8, 1-13 (mean 5.75). The untied heads keep the
# logps near -8 at any of these scales.
MOE_SCALE_PARTS = ("ffn",)
# training on the MoE stacks: full width, depth cut to 2 layers, 4
# prompts x a group of 4 sampled completions. At 4 layers (qwen3-moe 3.11
# B parameters: bf16 weights 6.2 GB, gradients 6.2 GB, Adam's float32
# moments 24.9 GB, the updated weights 6.2 GB) the eager Adam's float32
# temporaries of one expert stack ([4, 128, 2048, 768], 3.2 GB each, ~7
# live) took the card past 80 GB (measured: out of memory in
# optimizer._leaf at 69.8 GB allocated). At 2 layers: 1.87 B parameters.
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_PROMPT_PAD = 256
MOE_TRAIN_MAX_NEW = 32
# MLA at one layer of deepseek-v2-lite in float32: the absorbed decode
# and the expanded whole-sequence path sum the same products in another
# order (over the 512-wide latent instead of 128-wide heads)
MLA_TOL = {"rtol": 1e-4, "atol": 1e-5}
# the frontend stacks: B 2, 64 text tokens after the prefix (2880 image
# patches for llava, 512 audio frames for musicgen)
FRONTEND_B = 2
FRONTEND_TEXT = 64
SERVE_LAUNCHER = ("--arch", "deepseek-v2-lite-16b", "--device", "cuda")
DENSE_ROLLOUT_PATH = ("flash_attention", "decode_attention")


@contextlib.contextmanager
def _drop_shares(torch):
    """Record, for every ``moe_apply`` call over more than one position (a
    prefill's), the share of its routed (token, expert) pairs that the
    capacity dispatch drops, as device scalars (read after the run)."""
    from repro_torch.models import moe
    shares = []
    plain = moe.moe_apply

    def apply(params, x, cfg):
        if x.shape[1] > 1:
            m = cfg.moe
            T = x.shape[0] * x.shape[1]
            C = moe.capacity(m, T)
            top_i = moe.route(params["router"], x.reshape(T, -1), m)[2]
            _, slot = moe.dispatch_slots(top_i, m, C)
            shares.append((slot == m.num_experts * C).float().mean())
        return plain(params, x, cfg)

    moe.moe_apply = apply
    try:
        yield shares
    finally:
        moe.moe_apply = plain


def _dense_sites(train=False):
    """``_capture_ops`` sites of the rollout's two attention kernel ops
    and, with ``train``, the training step's logprob and A-3PO ops."""
    from repro_torch.core import objective
    from repro_torch.models import attention
    from repro_torch.training import trainer
    sites = {"flash_attention": (attention, "flash_attention"),
             "decode_attention": (attention, "decode_attention_op")}
    if train:
        sites.update(
            token_logprob_entropy=(trainer, "token_logprob_entropy"),
            a3po_loss=(objective, "a3po_objective_reduced"))
    return sites


def _time_path_kernels(torch, seen, label):
    """Each kernel op a path called, timed on the inputs of its last call
    there (CUDA events, L2 flushed) beside its plain version, one PyTorch
    call that computes the same function where there is one (SDPA, the
    head's product), and the bound for those inputs. Returns {kernel name:
    record}, the records also printed."""
    from repro_torch.kernels.a3po_loss import ops as aops
    from repro_torch.kernels.a3po_loss.ref import (
        a3po_reduced_bwd_ref,
        a3po_reduced_ref,
    )
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.kernels.logprob import ops as lops
    from repro_torch.kernels.logprob.ref import (
        token_logprob_entropy_bwd_ref,
        token_logprob_entropy_ref,
    )
    F = torch.nn.functional
    timer = Timer(torch)
    out = {}

    def record(name, dname, shape, times):
        rec = dict({"phase": "kernel", "name": name, "case": label,
                    "dtype": dname, "shape": shape}, **times)
        emit(rec)
        out[name] = rec

    with torch.no_grad():
        if "flash_attention" in seen:
            (q, k, v), kw = seen["flash_attention"]
            B, H, S, hd = q.shape
            KV = k.shape[1]
            dname = str(q.dtype).split(".")[-1]
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            record("flash_attention", dname,
                   {"B": B, "S": S, "H": H, "KV": KV, "hd": hd}, _times(
                       torch, timer, dname,
                       q.element_size() * (2 * q.numel() + k.numel()
                                           + v.numel()),
                       4 * B * H * hd * _flash_pairs(S, kw.get("window")),
                       lambda: fops.flash_attention(q, k, v, **kw),
                       lambda: flash_attention_ref(q, k, v, **kw),
                       lambda: F.scaled_dot_product_attention(
                           qc, kc, vc, is_causal=True, enable_gqa=True),
                       iters=10, plain_iters=3))
            del qc, kc, vc
        if "decode_attention" in seen:
            (q, kc, vc, lengths), _ = seen["decode_attention"]
            B, H, hd = q.shape
            L, KV = kc.shape[1], kc.shape[2]
            n_keys = int(lengths.sum())
            dname = str(q.dtype).split(".")[-1]
            kt = kc.transpose(1, 2).contiguous()
            vt = vc.transpose(1, 2).contiguous()
            mask = (torch.arange(L, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            record("decode_attention", dname,
                   {"B": B, "H": H, "KV": KV, "hd": hd, "L": L,
                    "keys": n_keys}, _times(
                       torch, timer, dname,
                       q.element_size() * (2 * q.numel()
                                           + 2 * n_keys * KV * hd) + 4 * B,
                       4 * H * hd * n_keys,
                       lambda: dops.decode_attention_op(q, kc, vc, lengths),
                       lambda: decode_attention_ref(q, kc, vc, lengths),
                       lambda: F.scaled_dot_product_attention(
                           q[:, :, None], kt, vt, attn_mask=mask,
                           enable_gqa=True), iters=50))
            del kt, vt
        if "token_logprob_entropy" in seen:
            (h, w, t), _ = seen["token_logprob_entropy"]
            h, t = h.reshape(-1, h.shape[-1]), t.reshape(-1)
            T, d = h.shape
            V = w.shape[1]
            dname = str(h.dtype).split(".")[-1]
            es = h.element_size()
            shape = {"T": T, "d": d, "V": V}
            lib = (lambda: torch.mm(h, w, out_dtype=torch.float32)) \
                if h.dtype == torch.bfloat16 else (lambda: h @ w)
            record("token_logprob_entropy", dname, shape, _times(
                torch, timer, dname, T * d * es + d * V * es + T * 4
                + 4 * T * 4, 2 * T * d * V,
                lambda: lops.token_logprob_entropy(h, w, t),
                lambda: token_logprob_entropy_ref(h.float(), w.float(), t),
                lib, iters=10, plain_iters=3))
            t32 = t.to(torch.int32)
            _, _, logz, mu = lops._forward_kernel(h, w, t32)
            g = torch.Generator(device="cuda").manual_seed(12)
            gl, ge = torch.randn(2, T, generator=g, device="cuda")
            record("token_logprob_entropy_bwd", dname, shape, _times(
                torch, timer, dname, 2 * (T * d * es + d * V * es)
                + T * 4 * 5, 3 * 2 * T * d * V,
                lambda: lops._backward_kernel(h, w, t32, logz, mu, gl, ge,
                                              True, True),
                lambda: token_logprob_entropy_bwd_ref(h, w, t32, logz, mu,
                                                      gl, ge),
                None, iters=5, plain_iters=2))
        if "a3po_loss" in seen:
            args, kw = seen["a3po_loss"]
            args = [None if a is None else a.reshape(-1).contiguous()
                    for a in args]
            kw = {k: v for k, v in kw.items() if k != "use_kernel"}
            T = args[0].numel()
            ent = args[5] is not None
            _, metrics, coef = aops._reduced_forward_kernel(*args, **kw)
            gs = torch.randn((), device="cuda") * 2
            bkw = dict(kl_coef=kw["kl_coef"], entropy_coef=kw["entropy_coef"],
                       with_entropy=ent)
            shape = {"T": T, "entropy": ent}
            record("a3po_loss", "float32", shape, _times(
                torch, timer, "float32", (24 + 4 * ent) * T + 4 * 10,
                A3PO_FWD_OPS * T,
                lambda: aops._reduced_forward_kernel(*args, **kw),
                lambda: a3po_reduced_ref(*args, **kw), None))
            record("a3po_loss_bwd", "float32", shape, _times(
                torch, timer, "float32", 8 * T + 4 * 2, A3PO_BWD_OPS * T,
                lambda: aops._reduced_backward_kernel(
                    gs.reshape(1), metrics, coef, args[4], **bkw),
                lambda: a3po_reduced_bwd_ref(gs, metrics[aops.DENOM], coef,
                                             args[4], **bkw), None))
    del timer
    return out


def _ragged_prompts(cfg, n, pad, seed):
    """n seeded prompts of 64 .. pad tokens, right-padded to pad."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, pad + 1, size=n).astype(np.int32)
    lengths[0] = pad
    prompts = np.zeros((n, pad), np.int32)
    for i, L in enumerate(lengths):
        prompts[i, :L] = rng.integers(4, cfg.vocab_size, size=L)
    return prompts, lengths


def _check_generated(np, rb, label):
    """Finite behaviour logps, every row generating, and not one token
    repeated: the floors of the reference checks."""
    n = rb.gen_mask.sum(axis=1).astype(int)
    gen = [rb.tokens[b, L: L + n[b]] for b, L in enumerate(
        np.asarray(rb.prompt_lengths))]
    out = {"generated_tokens": int(n.sum()),
           "distinct_per_request": float(np.mean(
               [len(set(g.tolist())) for g in gen])),
           "mean_logp": float((rb.gen_logp * rb.gen_mask).sum()
                              / max(n.sum(), 1))}
    if not np.all(np.isfinite(rb.gen_logp)) or n.min() == 0 \
            or out["distinct_per_request"] < MIN_DISTINCT_PER_REQUEST \
            or out["mean_logp"] > MAX_MEAN_LOGP:
        raise AssertionError(f"{label}: degenerate generation {out}")
    return out


def phase_moe_serving(torch):
    """(a) qwen3-moe-30b-a3b at full width and depth in bf16 (30.5 B
    parameters, 61 GB; FFN weights x8) through the dense RolloutEngine:
    8 right-padded prompts of up to 256 tokens, 16 greedy new tokens. The
    flash kernel runs once per layer for the prefill and dense decode once
    per layer per token, each held against its plain version on its last
    call and timed there; the share of dropped routed pairs per layer at
    a prefill of the same prompts, tokens/s, peak memory, and the device's
    busy time and idle share of one more call. Returns (launches,
    times)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.rollout.engine import RolloutEngine

    cfg = get_config("qwen3-moe-30b-a3b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    _scale_blocks(torch, params, SCALE, MOE_SCALE_PARTS)
    prompts, lengths = _ragged_prompts(cfg, MOE_PROMPTS, MOE_PROMPT_PAD, 20)
    engine = RolloutEngine(cfg, max_new_tokens=MOE_MAX_NEW)
    engine.generate(params, prompts[:2], lengths[:2], greedy=True)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rb = engine.generate(params, prompts, lengths, greedy=True)
    elapsed = time.perf_counter() - t0
    launches = _path_counts(DENSE_ROLLOUT_PATH)
    want = {"flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * MOE_MAX_NEW}
    if launches != want:
        raise AssertionError(f"moe rollout launches {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    gen = _check_generated(np, rb, "qwen3-moe rollout")
    # the same call again with each kernel op's inputs recorded
    with _capture_ops(torch, _dense_sites()) as seen:
        engine.generate(params, prompts, lengths, greedy=True)
    held = _hold_path_kernels(torch, seen, "top_key_dropped")
    with _drop_shares(torch) as shares:
        M.prefill(params, cfg, torch.as_tensor(prompts, dtype=torch.long,
                                               device="cuda"),
                  lengths=torch.as_tensor(lengths, device="cuda"))
        shares = [float(s) for s in shares]
    if len(shares) != cfg.num_layers:
        raise AssertionError(f"{len(shares)} MoE prefill calls")

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(params, prompts, lengths, greedy=True)
        return time.perf_counter() - t0
    prof = _device_profile(torch, run)
    times = _time_path_kernels(torch, seen, "moe_rollout")
    emit({"phase": "moe_serving", "model": cfg.name,
          "layers": cfg.num_layers, "params": cfg.num_params(),
          "dtype": "bfloat16", "weight_scale": {"x": SCALE,
                                                "parts": MOE_SCALE_PARTS},
          "init_s": init_s, "init_peak_mem_gb": init_peak,
          "batch": list(prompts.shape), "prompt_tokens": int(lengths.sum()),
          "max_new": MOE_MAX_NEW, "capacity_factor": cfg.moe.capacity_factor,
          "elapsed_s": elapsed, "tokens_per_s": gen["generated_tokens"]
          / elapsed, "peak_mem_gb": peak, "launches": launches,
          "prefill_dropped_pair_share_by_layer": shares,
          "prefill_dropped_pair_share_mean": sum(shares) / len(shares),
          "generated": gen, "held": held,
          "device_busy_s": prof["device_busy_s"],
          "device_idle_share": prof["device_idle_share"],
          "top_device_kernels": prof["top_device_kernels"][:6]})
    del params, engine, seen
    torch.cuda.empty_cache()
    return launches, times


def _mla_absorbed_check(torch):
    """One deepseek-v2-lite MLA layer at full width in float32: the
    absorbed mla_decode of token S, against a latent cache that mla_full
    filled with tokens 0 .. S-1, equals mla_full's position S over tokens
    0 .. S (two rows, S 255 and 100)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mla
    from repro_torch.models.params import init_from_specs
    cfg = get_config("deepseek-v2-lite-16b")
    g = torch.Generator(device="cuda").manual_seed(13)
    p = init_from_specs(mla.mla_spec(cfg), g, device="cuda",
                        dtype=torch.float32)
    S = 256
    x = torch.randn(2, S, cfg.d_model, generator=g, device="cuda")
    lengths = torch.tensor([S - 1, 100], dtype=torch.int32, device="cuda")
    pos = torch.arange(S, device="cuda").expand(2, S)
    with torch.no_grad():
        full, _ = mla.mla_full(p, x, cfg, pos)
        _, (ckv, krope) = mla.mla_full(p, x[:, : S - 1], cfg, pos[:, :-1])
        cache = mla.init_mla_cache(cfg, 2, S + 8, dtype=torch.float32)
        cache["ckv"][:, : S - 1] = ckv
        cache["krope"][:, : S - 1] = krope
        rows = torch.arange(2, device="cuda")
        dec, _ = mla.mla_decode(p, x[rows, lengths.long()], cfg, cache,
                                lengths)
        ref = full[rows, lengths.long()]
    rec = {"name": "mla_decode_vs_full", "layer_params": sum(
        t.numel() for t in p.parameters()), "S": S,
        "lengths": lengths.tolist()}
    # the tolerance must fail the output of the position before
    _hold(torch, rec, dec, ref, MLA_TOL,
          {"previous_position": full[rows, lengths.long() - 1]})
    return rec


def phase_serve_launcher(torch):
    """(b) ``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --device cuda``: the full config in float32 (16.2 B parameters, 64.8
    GB, as the reference casts it) through the dense RolloutEngine, two
    waves of 8 sampled sequences x 8 new tokens: exit 0, each wave's
    tokens/s. MLA and MoE are plain PyTorch: no kernel launches here. Then
    the absorbed MLA decode against the whole-sequence path at one layer."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_LAUNCHER],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    waves = [line for line in res.stdout.splitlines()
             if line.startswith("wave ")]
    rates = [float(re.search(r"([0-9.]+) tok/s$", w).group(1))
             for w in waves]
    rec = {"phase": "serve_launcher", "argv": list(SERVE_LAUNCHER),
           "returncode": res.returncode, "wall_s": wall, "waves": waves,
           "tokens_per_s": rates}
    if res.returncode != 0 or len(rates) != 2:
        raise AssertionError(f"serve launcher: {rec}\n{res.stderr[-4000:]}")
    rec["mla"] = _mla_absorbed_check(torch)
    emit(rec)
    torch.cuda.empty_cache()


def phase_moe_training(torch, name):
    """(c) ``name`` at full width with the depth cut to 2 layers, bf16,
    FFN weights x8: 4 prompts x a group of 4 sampled completions through
    the dense RolloutEngine (version 0), then Trainer.step with A-3PO at
    staleness 1 and a recompute step after it (staleness 2), on seeded
    Bernoulli rewards: every metric finite, the parameters move, the MoE
    aux finite
    and above 0; the logprob forward and backward and the A-3PO loss
    kernels launched and held against their plain versions on their last
    call, and timed there. Returns (launches, times)."""
    import numpy as np
    from repro_torch.configs.base import RLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.rollout.engine import RolloutEngine
    from repro_torch.training import (
        Trainer,
        TrainState,
        adam_init,
        assemble_train_batch,
    )
    from repro_torch.training.trainer import METRIC_KEYS

    cfg = dataclasses.replace(get_config(name), num_layers=MOE_TRAIN_LAYERS)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                           device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)
    with torch.no_grad():
        _scale_blocks(torch, params, SCALE, MOE_SCALE_PARTS)
    rng = np.random.default_rng(14)
    prompts, lengths = _ragged_prompts(cfg, TRAIN_PROMPTS,
                                       MOE_TRAIN_PROMPT_PAD, 15)
    prompts = np.repeat(prompts, GROUP, axis=0)
    lengths = np.repeat(lengths, GROUP)
    engine = RolloutEngine(cfg, RLConfig(temperature=1.0, top_p=1.0),
                           max_new_tokens=MOE_TRAIN_MAX_NEW)
    rl = RLConfig(group_size=GROUP, num_minibatches=4)
    trainers = {a: Trainer(cfg, rl, a) for a in ("a3po", "recompute")}
    state = TrainState(params, adam_init(params),
                       torch.ones((), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with _capture_ops(torch, _dense_sites(train=True)) as seen:
        t0 = time.perf_counter()
        rb = engine.generate(params, prompts, lengths,
                             torch.Generator(device="cuda").manual_seed(16),
                             version=0)
        serve_s = time.perf_counter() - t0
        gen = _check_generated(np, rb, f"{name} rollout")
        batch = assemble_train_batch(
            [rb], rng.binomial(1, 0.5, len(lengths)).astype(np.float32),
            device="cuda")
        for algo in ("a3po", "recompute"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = trainers[algo].step(state, batch)
            torch.cuda.synchronize()
            _check_metrics(np, m, METRIC_KEYS)
            changed, total = _changed(torch, state.params, new.params)
            rec = {"algo": algo, "seconds": time.perf_counter() - t0,
                   "staleness": m["staleness_mean"],
                   "params_changed": changed, "params_total": total,
                   "host_syncs": trainers[algo].last_host_syncs,
                   "metrics": {k: m[k] for k in METRIC_KEYS}}
            # the a3po step at staleness 1 (alpha 1: iw exactly 1), the
            # recompute step after it at 2
            if changed == 0 or m["staleness_mean"] != len(steps) + 1 \
                    or (algo == "a3po" and m["iw_mean"] != 1.0):
                raise AssertionError(f"{name} {algo} step: {rec}")
            steps.append(rec)
            state = new
    launches = _path_counts(TRAIN_PATH)
    peak = torch.cuda.max_memory_allocated() / 1e9
    train_kernels = ("a3po_loss", "a3po_loss_bwd", "token_logprob_entropy",
                     "token_logprob_entropy_bwd")
    if min(launches[k] for k in train_kernels) <= 0 \
            or (cfg.mla is None) != (launches["flash_attention"] > 0):
        raise AssertionError(f"{name} training launches {launches}")
    with torch.no_grad():
        _, aux = M.forward_hidden(state.params, cfg, batch.tokens[:4, :-1])
    aux = float(aux)
    if not (math.isfinite(aux) and aux > 0):
        raise AssertionError(f"{name}: MoE aux {aux}")
    held = _hold_path_kernels(torch, seen, "top_key_dropped")
    times = _time_path_kernels(torch, seen, f"moe_train_{name}")

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainers["a3po"].step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    prof = _device_profile(torch, step)
    emit({"phase": "moe_training", "model": name, "layers": cfg.num_layers,
          "params": cfg.num_params(), "dtype": "bfloat16",
          "weight_scale": {"x": SCALE, "parts": MOE_SCALE_PARTS},
          "batch": list(batch.tokens.shape),
          "serve_s": serve_s, "generated": gen, "steps": steps,
          "moe_aux": aux, "peak_mem_gb": peak, "launches": launches,
          "held": held, "a3po_step_profile": {
              k: prof[k] for k in ("wall_s", "device_busy_s",
                                   "device_idle_share",
                                   "top_device_kernels")}})
    del params, state, new, seen, engine
    torch.cuda.empty_cache()
    return launches, times


def phase_frontend(torch, name):
    """(d) ``name`` (llava-next-mistral-7b: 2880 image-patch rows;
    musicgen-large: 512 audio-frame rows) at full size in bf16, layer
    weights x8 (at the init stds a row of ~3000 keys attends so flatly
    that no one key moves the output past the kernel tolerance, so no
    wrong reference could fail it), seeded random frontend embeddings:
    forward_logits over the
    prefix and 64 text tokens, then prefill of all but the last token
    (flash at S = prefix + 63) and one decode_step (dense decode over the
    prefix + 63 keys): the decode logits agree with forward_logits' last
    position within the engine checks' bf16 tolerances, flash and decode
    held against their plain versions on their last call and timed there.
    Returns (launches, times)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    cfg = get_config(name)
    F = cfg.frontend_tokens
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                           device="cuda", dtype=torch.bfloat16)
    _scale_blocks(torch, params, SCALE)
    g = torch.Generator(device="cuda").manual_seed(17)
    toks = torch.randint(4, cfg.vocab_size, (FRONTEND_B, FRONTEND_TEXT),
                         generator=g, device="cuda")
    embeds = torch.randn(FRONTEND_B, F, cfg.d_model, generator=g,
                         device="cuda").to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        full = M.forward_logits(params, cfg, toks, embeds=embeds)[:, -1]
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        _reset_counts()
        with _capture_ops(torch, _dense_sites()) as seen:
            t0 = time.perf_counter()
            _, cache = M.prefill(params, cfg, toks[:, :-1], embeds=embeds,
                                 max_len=F + FRONTEND_TEXT + 8)
            dec, cache = M.decode_step(params, cfg, cache, toks[:, -1])
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
        launches = _path_counts(DENSE_ROLLOUT_PATH)
    if launches != {"flash_attention": cfg.num_layers,
                    "decode_attention": cfg.num_layers}:
        raise AssertionError(f"{name} launches {launches}")
    lp_full = torch.log_softmax(full, dim=-1)
    lp_dec = torch.log_softmax(dec, dim=-1)
    best = lp_dec.argmax(dim=-1, keepdim=True)
    top = lp_full.argmax(dim=-1, keepdim=True)
    check = {
        "lengths": cache["lengths"].tolist(),
        "max_abs_logp_err_at_argmaxes": max(
            (lp_full.gather(-1, i) - lp_dec.gather(-1, i)).abs().max().item()
            for i in (best, top)),
        "max_gap_to_best_logp": (lp_full.max(dim=-1).values
                                 - lp_full.gather(-1, best)[:, 0]).max()
        .item(),
        "argmax_agree": int((best == top).sum()),
        "best_logp": lp_full.max(dim=-1).values.tolist(),
        "tol": {"logp": ENGINE_LOGP_TOL, "gap": ENGINE_GAP_TOL}}
    if check["lengths"] != [F + FRONTEND_TEXT] * FRONTEND_B \
            or check["max_abs_logp_err_at_argmaxes"] > ENGINE_LOGP_TOL \
            or check["max_gap_to_best_logp"] > ENGINE_GAP_TOL \
            or not bool(torch.isfinite(dec).all()) \
            or max(check["best_logp"]) > MAX_MEAN_LOGP:
        raise AssertionError(f"{name}: decode vs forward_logits {check}")
    held = _hold_path_kernels(torch, seen, "top_key_dropped")
    times = _time_path_kernels(torch, seen, f"frontend_{name}")

    def serve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, c = M.prefill(params, cfg, toks[:, :-1], embeds=embeds,
                         max_len=F + FRONTEND_TEXT + 8)
        M.decode_step(params, cfg, c, toks[:, -1])
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    prof = _device_profile(torch, serve)
    emit({"phase": "frontend", "model": name, "layers": cfg.num_layers,
          "params": cfg.num_params(), "dtype": "bfloat16",
          "layer_weight_scale": SCALE, "prefix_rows": F,
          "text_tokens": FRONTEND_TEXT, "batch": FRONTEND_B,
          "forward_s": forward_s, "prefill_decode_s": serve_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "decode_vs_forward": check, "held": held,
          "prefill_decode_profile": {
              k: prof[k] for k in ("wall_s", "device_busy_s",
                                   "device_idle_share",
                                   "top_device_kernels")}})
    del params, cache, seen, full, dec
    torch.cuda.empty_cache()
    return launches, times



# ------------------------------------------------- step programs, dry-run
STEPS_PROMPTS = 8
STEPS_PROMPT = 992
STEPS_NEW = 32
STEPS_MICRO = 4
STEPS_F32_LAYERS = 4
STEPS_DECODE = 16
MB_LOSS_RTOL = 1e-5          # tests/test_launch.py:101-131
MB_PARAM_TOL = {"rtol": 5e-3, "atol": 5e-5}
EP_REL_TOL = 1e-5            # float32, one rank, no pair dropped
DRYRUNS = [("dryrun", "qwen2.5-1.5b", shape, ()) for shape in (
    "train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
    ("dryrun", "qwen3-moe-30b-a3b", "train_4k", ("--ep-moe",)),
    ("train", "qwen2.5-1.5b", None, ())]
DRYRUN_TIMEOUT_S = 600


def _start_dryruns(tmp):
    """Start the host-only dry-runs of (f), each its own process with a
    fake process group, off the card, one thread each."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for kind, arch, shape, extra in DRYRUNS:
        if kind == "dryrun":
            argv = ["-m", "repro_torch.launch.dryrun", "--arch", arch,
                    "--shape", shape, *extra, "--log-jsonl",
                    str(tmp / f"dryrun_{arch}_{shape}.jsonl")]
        else:
            argv = ["-m", "repro_torch.launch.train", "--mesh", "prod",
                    "--arch", arch]
        log = open(tmp / f"{kind}_{arch}_{shape}.log", "w")
        procs.append(((kind, arch, shape, extra), log, time.perf_counter(),
                      subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                                       env=env, stdout=log,
                                       stderr=subprocess.STDOUT)))
    return procs


def _finish_dryruns(procs):
    """Wait for (f)'s processes; each must exit 0. Returns their records:
    each dry-run's per-device numbers (the H100 data-sheet roofline over
    a fake mesh), the launcher's summary lines."""
    from repro_torch.launch.dryrun import RESULTS_DIR
    out, failed = [], []
    ended = {}
    try:
        # each process's own end time: poll them all
        while len(ended) < len(procs):
            for i, (_, _, t0, p) in enumerate(procs):
                if i in ended:
                    continue
                if p.poll() is not None:
                    ended[i] = time.perf_counter() - t0
                elif time.perf_counter() - t0 > DRYRUN_TIMEOUT_S:
                    p.kill()
                    p.wait()
                    ended[i] = time.perf_counter() - t0
            time.sleep(0.5)
        for i, ((kind, arch, shape, extra), log, t0, p) in enumerate(procs):
            rc, seconds = p.returncode, ended[i]
            log.close()
            text = Path(log.name).read_text()
            # polled after the card's phases: ended within this many
            # seconds of its start (the census's own time: "step_s")
            rec = {"kind": kind, "arch": arch, "shape": shape,
                   "flags": list(extra), "rc": rc, "done_within_s": seconds}
            if rc != 0:
                rec["tail"] = text[-3000:]
                failed.append(rec)
            elif kind == "train":
                rec["lines"] = [ln for ln in text.splitlines()
                                if ln.startswith("[sharded]")]
            else:
                with open(os.path.join(RESULTS_DIR, f"{arch}_{shape}_16x16"
                                       ".json")) as f:
                    r = json.load(f)
                rec.update({
                    "argument_gb_per_device":
                        r["memory"]["argument_size_in_bytes"] / 1e9,
                    "temp_gb_per_device":
                        r["memory"]["temp_size_in_bytes"] / 1e9,
                    "flops_per_device": r["hlo_flops_per_device"],
                    "bytes_per_device": r["hlo_bytes_per_device"],
                    "collective_bytes_per_device":
                        r["collective_bytes_per_device"],
                    "collective_ops": r["collective_ops"],
                    "collective_bytes_by_axis": r[
                        "collective_bytes_by_axis"],
                    "roofline": r["roofline"],
                    "roofline_source": r["roofline_source"],
                    "useful_flops_ratio": r["useful_flops_ratio"],
                    "replicated_fallbacks": r["replicated_fallbacks"],
                    "census_ops": r["census_ops"], "step_s": r["compile_s"]})
            emit(dict({"phase": "dryrun"}, **rec))
            out.append(rec)
    finally:
        for _, log, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        raise AssertionError(f"dry-runs failed: {failed}")
    return out


def _steps_sites():
    """``_capture_ops`` sites of the step programs' four kernel ops."""
    from repro_torch.core import objective
    from repro_torch.launch import steps
    from repro_torch.models import attention
    return {"flash_attention": (attention, "flash_attention"),
            "decode_attention": (attention, "decode_attention_op"),
            "token_logprob_entropy": (steps, "token_logprob_entropy"),
            "a3po_loss": (objective, "a3po_objective_reduced")}


def _steps_batch(torch, rb, np):
    """The train step's batch dict from a rollout: tokens, behaviour
    logps, response mask, versions, and seeded advantages on the mask."""
    from repro_torch.training import assemble_train_batch
    tb = assemble_train_batch([rb], np.zeros(rb.tokens.shape[0],
                                             np.float32), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(21)
    adv = torch.randn(tb.response_mask.shape, generator=g, device="cuda")
    return {"tokens": tb.tokens, "behav_logp": tb.behav_logp,
            "advantages": adv * tb.response_mask, "mask": tb.response_mask,
            "versions": tb.versions}


def _steps_train_f32(torch, np, batch):
    """(a)'s float32 check at 4 layers, 4 microbatches against 1, as the
    reference's equivalence test: init stds (no x8), behaviour logps the
    model's own (so no ratio is clipped and the gradient is whole),
    non-negative advantages (a mean of signed advantages cancels to ~1e-2
    of its terms, and the loss's relative error grows by as much) and
    Adam's eps 1e-4, as the port's Adam parity tests (a near-zero
    gradient's sign is the summation order's)."""
    from repro_torch.configs.base import RLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.training import adam_init, score_tokens
    from repro_torch.training.optimizer import flatten
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b"),
                              num_layers=STEPS_F32_LAYERS, dtype="float32")
    out = {}
    for nm in (1, STEPS_MICRO):
        params = M.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(22), device="cuda",
                               requires_grad=True)
        behav = score_tokens(params, cfg, batch["tokens"])[0] * batch["mask"]
        step = steps.make_train_step(cfg, RLConfig(learning_rate=1e-3,
                                                   adam_eps=1e-4),
                                     "a3po", num_microbatches=nm)
        p2, _, loss, ent, gn = step(params, adam_init(params), dict(
            batch, behav_logp=behav, advantages=batch["advantages"].abs()))
        out[nm] = ({k: v.detach() for k, v in flatten(p2).items()},
                   float(loss), float(gn))
        del params, p2
    (p1, l1, g1), (p4, l4, g4) = out[1], out[STEPS_MICRO]
    worst = max(((p4[k] - v).abs() / (MB_PARAM_TOL["atol"] + MB_PARAM_TOL[
        "rtol"] * v.abs())).max().item() for k, v in p1.items())
    if not (abs(l1) > 1e-3 and g1 > 1e-3):
        raise AssertionError(f"microbatch check has no gradient: {l1} {g1}")
    rec = {"loss_nm1": l1, f"loss_nm{STEPS_MICRO}": l4,
           "loss_rel_err": abs(l4 - l1) / abs(l1), "loss_rtol": MB_LOSS_RTOL,
           "grad_norm_nm1": g1, f"grad_norm_nm{STEPS_MICRO}": g4,
           "param_worst_err_over_tol": worst, "param_tol": MB_PARAM_TOL}
    if not rec["loss_rel_err"] <= MB_LOSS_RTOL or not worst <= 1.0:
        raise AssertionError(f"microbatch accumulation: {rec}")
    return rec


def _steps_ep(torch):
    """(e) moe_apply_ep on the card's one-rank mesh against moe_apply, at
    qwen3-moe-30b-a3b's layer shapes in float32, with the reduced
    configs' capacity factor 4 (no pair overflows; checked)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import ShardingEnv, use_sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import init_from_specs
    cfg = get_config("qwen3-moe-30b-a3b")
    m = cfg.moe
    cfg = dataclasses.replace(cfg, num_layers=1, dtype="float32",
                              moe=dataclasses.replace(m, capacity_factor=4.0))
    p = init_from_specs(moe.moe_spec(cfg), torch.Generator(device="cuda")
                        .manual_seed(23), device="cuda", dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(4, 60, cfg.d_model, generator=g, device="cuda") * 0.5
    with torch.no_grad():
        y0, a0 = moe.moe_apply(p, x, cfg)
        mesh = make_local_mesh()
        env = ShardingEnv(mesh)
        env.ep_shard_map = True
        with use_sharding(env):
            y1, a1 = moe.moe_apply(p, x, cfg)
        T = x.shape[0] * x.shape[1]
        top_i = moe.route(p["router"], x.reshape(T, -1), cfg.moe)[2]
        dropped = int((moe.dispatch_slots(top_i, cfg.moe, moe.capacity(
            cfg.moe, T))[1] == m.num_experts * moe.capacity(cfg.moe, T))
            .sum())
    rec = {"mesh": repr(mesh), "device": str(y1.device),
           "shape": list(x.shape), "experts": m.num_experts,
           "top_k": m.top_k, "dropped_pairs": dropped,
           "rel_err": ((y1 - y0).abs().max() / y0.abs().max()).item(),
           "aux_err": abs(float(a1) - float(a0)), "tol": EP_REL_TOL}
    if y1.device.type != "cuda" or dropped or not rec["rel_err"] <= \
            EP_REL_TOL or not rec["aux_err"] <= 1e-6:
        raise AssertionError(f"moe_apply_ep on one rank: {rec}")
    del p, x, y0, y1
    return rec


def phase_steps(torch, tmp, procs):
    """17: the step programs at Qwen2.5-1.5B full width and the dry-run
    (see the module docstring); ``procs``: (f)'s processes, started after
    the build. Returns (launches, times) of (a)-(c)."""
    import numpy as np
    from repro_torch.configs.base import InputShape, RLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.distributed.sharding import ShardingEnv
    from repro_torch.models import model as M
    from repro_torch.models.layers import logits_from_hidden
    from repro_torch.rollout.engine import RolloutEngine
    from repro_torch.training import adam_init
    from repro_torch.training.checkpoints import (
        restore_sharded,
        save_checkpoint,
    )
    from repro_torch.training.optimizer import flatten

    t_phase = time.perf_counter()
    try:
        cfg = get_config("qwen2.5-1.5b")
        params = M.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(20), device="cuda",
                               dtype=torch.bfloat16, requires_grad=True)
        with torch.no_grad():
            _scale_blocks(torch, params, SCALE)
        g = torch.Generator(device="cuda").manual_seed(25)
        prompts = torch.randint(4, cfg.vocab_size,
                                (STEPS_PROMPTS, STEPS_PROMPT), generator=g,
                                device="cuda").cpu().numpy().astype(np.int32)
        lengths = np.full(STEPS_PROMPTS, STEPS_PROMPT, np.int32)
        engine = RolloutEngine(cfg, RLConfig(temperature=1.0, top_p=1.0),
                               max_new_tokens=STEPS_NEW)
        with torch.no_grad():
            rb = engine.generate(params, prompts, lengths,
                                 torch.Generator(device="cuda")
                                 .manual_seed(26), version=0)
        gen = _check_generated(np, rb, "steps rollout")
        batch = _steps_batch(torch, rb, np)

        # (a) the train step, A-3PO, 4 microbatches, full depth
        torch.cuda.synchronize()
        _reset_counts()
        step = steps.make_train_step(cfg, RLConfig(), "a3po",
                                     num_microbatches=STEPS_MICRO)
        with _capture_ops(torch, _steps_sites()) as seen:
            t0 = time.perf_counter()
            new, _, loss, ent, gn = step(params, adam_init(params), batch)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        launches = _path_counts(TRAIN_PATH)
        changed, total = _changed(torch, params, new)
        train = {"seconds": train_s, "loss": float(loss),
                 "entropy": float(ent), "grad_norm": float(gn),
                 "params_changed": changed, "params_total": total,
                 "batch": list(batch["tokens"].shape),
                 "microbatches": STEPS_MICRO, "launches": dict(launches)}
        if not all(math.isfinite(train[k]) for k in ("loss", "entropy",
                                                      "grad_norm")) \
                or changed == 0 or min(launches[k] for k in TRAIN_PATH[2:]) \
                <= 0:
            raise AssertionError(f"steps train: {train}")
        held = _hold_path_kernels(torch, seen)
        times = _time_path_kernels(torch, seen, "steps_train")
        train["f32_microbatches"] = _steps_train_f32(torch, np, batch)
        del seen, new
        torch.cuda.empty_cache()

        # (b) prefill, 4 microbatches against 1, the full 1024 tokens
        tokens = batch["tokens"].contiguous()
        B, S = tokens.shape
        pshape = InputShape("steps_prefill", S, B, "prefill")
        with torch.no_grad():
            l1, c1 = steps.make_prefill_step(cfg, pshape, 1)(
                params, {"tokens": tokens})
            _reset_counts()
            with _capture_ops(torch, _steps_sites()) as seen:
                l4, c4 = steps.make_prefill_step(cfg, pshape, STEPS_MICRO)(
                    params, {"tokens": tokens})
            n_flash = _path_counts(("flash_attention",))["flash_attention"]
        tol = TOL["bfloat16"]
        worst = max(((a.float() - b.float()).abs() / (tol["atol"] + tol[
            "rtol"] * b.float().abs())).max().item() for a, b in
            [(l4, l1)] + list(zip(flatten(c4).values(),
                                  flatten(c1).values())))
        prefill = {"shape": [B, S], "microbatches": STEPS_MICRO,
                   "flash_launches": n_flash, "worst_err_over_tol": worst,
                   "tol": tol}
        if not worst <= 1.0 or n_flash != cfg.num_layers * STEPS_MICRO:
            raise AssertionError(f"steps prefill: {prefill}")
        held.update(_hold_path_kernels(torch, seen))
        times.update(_time_path_kernels(torch, seen, "steps_prefill"))
        launches["flash_attention"] += n_flash
        del c1, c4, l1, l4, seen

        # (c) decode 16 greedy tokens after a prefill with room
        dshape = InputShape("steps_decode", S + STEPS_DECODE, B, "decode")
        decode_step = steps.make_decode_step(cfg, dshape)
        with torch.no_grad():
            h, cache = M.prefill(params, cfg, tokens,
                                 max_len=S + STEPS_DECODE)
            nxt = logits_from_hidden(params["embedding"], h[:, -1:],
                                     cfg)[:, 0].argmax(-1)
            out_tokens, step_logits = [], []
            _reset_counts()
            with _capture_ops(torch, _steps_sites()) as seen:
                for _ in range(STEPS_DECODE):
                    out_tokens.append(nxt)
                    logits, cache = decode_step(params, {"cache": cache,
                                                         "tokens": nxt})
                    step_logits.append(logits)
                    nxt = logits.argmax(-1)
            n_dec = _path_counts(("decode_attention",))["decode_attention"]
            seq = torch.cat([tokens, torch.stack(out_tokens, 1)], 1)
            # position S + i predicts what decode step i's logits do
            full = M.forward_logits(params, cfg, seq)[:, S:]
            lp_full = torch.log_softmax(full, -1)
            lp_dec = torch.log_softmax(torch.stack(step_logits, 1), -1)
        best = lp_dec.argmax(-1, keepdim=True)
        top = lp_full.argmax(-1, keepdim=True)
        decode = {"tokens": STEPS_DECODE, "decode_launches": n_dec,
                  "max_abs_logp_err_at_argmaxes": max(
                      (lp_full.gather(-1, i) - lp_dec.gather(-1, i)).abs()
                      .max().item() for i in (best, top)),
                  "max_gap_to_best_logp": (lp_full.max(-1).values
                                           - lp_full.gather(-1, best)[..., 0])
                  .max().item(),
                  "argmax_agree": float((best == top).float().mean()),
                  "tol": {"logp": ENGINE_LOGP_TOL, "gap": ENGINE_GAP_TOL}}
        if decode["max_abs_logp_err_at_argmaxes"] > ENGINE_LOGP_TOL \
                or decode["max_gap_to_best_logp"] > ENGINE_GAP_TOL \
                or n_dec != cfg.num_layers * STEPS_DECODE \
                or not bool(torch.isfinite(lp_dec).all()):
            raise AssertionError(f"steps decode: {decode}")
        held.update(_hold_path_kernels(torch, seen, "top_key_dropped"))
        times.update(_time_path_kernels(torch, seen, "steps_decode"))
        launches["decode_attention"] = n_dec
        del cache, full, lp_full, lp_dec, seen

        # (d) restore (a)'s parameters onto the local mesh
        path = str(tmp / "steps_params")
        t0 = time.perf_counter()
        save_checkpoint(path, params, {"arch": cfg.name})
        save_s = time.perf_counter() - t0
        mesh = make_local_mesh()
        t0 = time.perf_counter()
        restored, _ = restore_sharded(path, M.param_shardings(
            cfg, ShardingEnv(mesh)))
        torch.cuda.synchronize()
        restore = {"mesh": repr(mesh), "save_s": save_s,
                   "restore_s": time.perf_counter() - t0,
                   "bytes": os.path.getsize(path + ".npz")}
        got = flatten(restored)
        # bf16 leaves come back as the float32 they were saved as, which
        # holds them exactly: rounded back, bit for bit
        bad = [k for k, v in flatten(params).items()
               if got[k].device.type != "cuda"
               or not torch.equal(got[k].to(v.dtype).view(torch.int16),
                                  v.detach().view(torch.int16))
               or not torch.equal(got[k], v.detach().float())]
        restore["leaves"], restore["bit_equal"] = len(got), not bad
        if bad:
            raise AssertionError(f"restore_sharded: {bad} {restore}")
        del restored, got
        os.remove(path + ".npz")
        os.remove(path + ".json")

        # (e) the expert-parallel MoE on the card's one-rank mesh
        del params
        torch.cuda.empty_cache()
        ep = _steps_ep(torch)
        gpu_s = time.perf_counter() - t_phase

        # (f) the dry-runs
        dry = _finish_dryruns(procs)
    finally:
        for _, log, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    emit({"phase": "steps", "model": cfg.name, "layers": cfg.num_layers,
          "dtype": "bfloat16", "layer_weight_scale": SCALE,
          "generated": gen, "train": train, "prefill": prefill,
          "decode": decode, "restore_sharded": restore, "moe_ep": ep,
          "held": held, "launches": launches, "gpu_parts_s": gpu_s,
          "dryruns_done_within_s": {
              f"{d['kind']}:{d['arch']}:{d['shape']}": d["done_within_s"]
              for d in dry},
          "seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()
    return launches, times


# ---------------------------------------------------------------- examples
# (a) each example at its toy defaults: (example, argv, the kernels its
# path launches, the start of its summary line: the last it prints)
EXAMPLE_RUNS = (
    ("torch_quickstart", (), ("a3po_loss",), "ASymPO loss (behavior-free):"),
    ("torch_train_async_rl", ("--steps", "3", "--sft-steps", "20"),
     TRAIN_PATH, '{"algo": '),
    ("torch_train_async_rl", ("--steps", "3", "--sft-steps", "20",
                              "--threaded"), TRAIN_PATH, '{"algo": '),
    ("torch_ablate_alpha", ("--steps", "3"), TRAIN_PATH,
     "saved experiments/torch/alpha_ablation.json"),
    ("torch_serve_batch", (), DENSE_ROLLOUT_PATH, "TOTAL: "),
    ("torch_serve_paged", (), SERVE_PATH, "free pages after drain: "),
    ("torch_serve_control_plane", (), SERVE_PATH, "metrics: "),
    ("torch_loadgen_trace", (), SERVE_PATH, "same trace, same engine"),
)
# (b) train_async_rl's path at Qwen2.5-1.5B full width, in its config's
# bf16, no weight scaling, on the task's own rewards from one SFT base.
# The reference's SFT defaults (150 steps at lr 3e-3) are toy-2m's: at this
# width lr 3e-3 stalls at a loss of ~1.8 and scores ~0.06. The lr here was
# chosen with chip_sft_sweep.py so that the loss falls and the base eval
# lands strictly between 0 and 1, well inside (lr 1e-4: the loss from 37.8
# to ~0.7 and an eval of 0.39 at n 64 after 150 steps). The reference's RL
# lr 2e-4 collapses both algorithms at this width within 3 steps; the RL lr
# is the largest that `chip_sft_sweep.py --mode rl` found collapsing
# neither (2e-4 and 5e-5 collapse; 1e-5, 3e-6 and 1e-6 do not).
EX_ARCH = "qwen2.5-1.5b"
EX_TASK = dict(max_operand=9, n_terms=2, prompt_len=8, seed=0)
EX_SFT = dict(steps=150, batch=32, total_len=14, lr=1e-4)
EX_RL = dict(group_size=4, num_minibatches=2, learning_rate=1e-5)
EX_RL_STEPS = 8
EX_EVAL_EVERY = 4
EX_EVAL_N = 32
EX_STALENESS = 2
EX_PROMPTS = 8
EX_MAX_NEW = 6
# a run collapses when its last step's entropy falls below this share of
# step 0's, or its final eval (n 64) more than this below the base eval
COLLAPSE_ENTROPY_SHARE = 0.5
COLLAPSE_EVAL_DROP = 0.15


def _run_example(torch, name, argv):
    """``examples/<name>.py``'s ``main(argv)`` in this process, its
    standard output captured. Returns (output, seconds)."""
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(list(argv))
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def _example_sites(path):
    """``_capture_ops`` sites of the kernel ops of an example's path."""
    sites = dict(_dense_sites(train=True), **_paged_sites())
    return {k: v for k, v in sites.items() if k in path}


def phase_examples(torch, tmp):
    """18 (a): each of the seven examples in this process at its toy
    defaults on the card (train_async_rl also with --threaded), run from a
    scratch directory: it ends normally, its last line is its summary, the
    counts show it launched each kernel of its path, the counts set to 0
    just before it, and each of those kernels is held against its plain
    version on the inputs of its last call in that run; then
    torch_quickstart.py as a user runs it, a subprocess with
    PYTHONPATH=src, which must exit 0. Returns {path: launches}."""
    work = tmp / "examples"
    work.mkdir()
    here = os.getcwd()
    by_path, runs = {}, []
    os.chdir(work)
    try:
        for name, argv, path, summary in EXAMPLE_RUNS:
            sites = _example_sites(path)
            with _capture_ops(torch, sites) as seen:
                _reset_counts()
                out, seconds = _run_example(torch, name, argv)
                counts = _path_counts(path)
            last = out.strip().splitlines()[-1]
            label = name + ("_threaded" if "--threaded" in argv else "")
            run = {"example": name, "argv": list(argv), "seconds": seconds,
                   "summary": last, "launches": counts}
            runs.append(run)
            if not last.startswith(summary) or min(counts.values()) <= 0:
                raise AssertionError(f"example {label}: {run}\n{out}")
            if summary.startswith("{"):
                keys = set(json.loads(last))
                if keys != {"algo", "base_eval", "final_eval",
                            "mean_prox_ms"}:
                    raise AssertionError(f"example {label}: {keys}")
            # quickstart's mask holds every token: a loss divided by T is
            # the right one there, so it is no wrong reference
            run["held"] = _hold_path_kernels(
                torch, seen, "top_key_dropped",
                ("last_block_dropped",) if name == "torch_quickstart"
                else ("last_block_dropped", "divides_by_t"))
            run["held"].update(_hold_paged_kernels(torch, seen))
            if set(run["held"]) != set(sites):
                raise AssertionError(f"example {label}: held "
                                     f"{sorted(run['held'])} of "
                                     f"{sorted(sites)}")
            del seen
            by_path[f"example_{label}"] = counts
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=300)
        sub = {"returncode": res.returncode,
               "seconds": time.perf_counter() - t0,
               "last_line": (res.stdout.strip().splitlines() or [""])[-1]}
        if res.returncode != 0:
            raise AssertionError(f"torch_quickstart.py: {sub}\n"
                                 f"{res.stdout}\n{res.stderr}")
        written = sorted(str(p.relative_to(work)) for p in work.rglob("*")
                         if p.is_file())
    finally:
        os.chdir(here)
    if written != ["experiments/torch/alpha_ablation.json",
                   "experiments/torch/ckpt/toy-2m_a3po.json",
                   "experiments/torch/ckpt/toy-2m_a3po.npz"]:
        raise AssertionError(f"examples wrote {written}")
    emit({"phase": "examples", "runs": runs, "quickstart_subprocess": sub,
          "files_written": written,
          "seconds": sum(r["seconds"] for r in runs)})
    return by_path


@contextlib.contextmanager
def _sft_losses(warmup, on_step=None):
    """Record each ``sft_update`` loss of ``warmup.sft_warmup`` (device
    scalars, read after it), by wrapping the name it calls; after each
    update call ``on_step(steps so far, its (params, opt, loss))``."""
    plain = warmup.sft_update
    losses = []

    def update(*args, **kw):
        out = plain(*args, **kw)
        losses.append(out[2])
        if on_step is not None:
            on_step(len(losses), out)
        return out

    warmup.sft_update = update
    try:
        yield losses
    finally:
        warmup.sft_update = plain


def _rl_from_base(torch, cfg, base_params, name, lr):
    """18 (b)'s loop from ``base_params``: ``simulate_async`` of ``name``
    at ``lr`` and ``EX_RL``'s other settings (8 prompts x a group of 4, 6
    new tokens, staleness 2, 8 steps, ``eval_reward(n=32)`` every 4
    steps), from a fresh task of ``EX_TASK``'s seed. Returns (final
    state, step records as dicts, seconds)."""
    from repro_torch.async_rl.orchestrator import simulate_async
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.algorithms import resolve_algorithm
    from repro_torch.data.tasks import ArithmeticTask
    from repro_torch.training import TrainState, adam_init, warmup
    algo = resolve_algorithm(name)
    rl = RLConfig(algo=algo, **dict(EX_RL, learning_rate=lr))
    task = ArithmeticTask(**EX_TASK)
    state = TrainState(base_params, adam_init(base_params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, recs = simulate_async(
        cfg, rl, task, algo, EX_RL_STEPS, n_prompts=EX_PROMPTS,
        max_new_tokens=EX_MAX_NEW, staleness=EX_STALENESS, seed=0,
        init_state=state, eval_every=EX_EVAL_EVERY,
        eval_fn=lambda p: warmup.eval_reward(cfg, p, task, n=EX_EVAL_N))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return state, [dataclasses.asdict(r) for r in recs], elapsed


def _collapse(entropy, final_eval, base_eval):
    """Why a run collapsed (empty when it did not): its last step's
    entropy under ``COLLAPSE_ENTROPY_SHARE`` of step 0's, or its final
    eval more than ``COLLAPSE_EVAL_DROP`` below the base eval."""
    why = []
    if not entropy[-1] >= COLLAPSE_ENTROPY_SHARE * entropy[0]:
        why.append(f"entropy {entropy[0]} -> {entropy[-1]}")
    if not final_eval >= base_eval - COLLAPSE_EVAL_DROP:
        why.append(f"eval {base_eval} -> {final_eval}")
    return why


def phase_examples_full(torch, smi):
    """18 (b): train_async_rl's path at Qwen2.5-1.5B full width and depth,
    bf16 (the config's dtype), no weight scaling, on the arithmetic task's
    own rewards: ``sft_warmup`` (``EX_SFT``), the base eval, then from that
    one base ``_rl_from_base`` for a3po and recompute in turn. Checks:
    every SFT loss and step metric finite; the mean of the last 10 SFT
    losses under half that of the first 10; the base eval strictly
    between 0 and 1; the parameters move in each run; neither run
    collapses (``_collapse``); a3po's mean prox time below recompute's;
    each kernel of the path held against its plain version on the inputs
    of its last call there, and timed there. Returns (launches by path,
    times by path)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tasks import ArithmeticTask
    from repro_torch.training import warmup

    t_phase = time.perf_counter()
    cfg = get_config(EX_ARCH)
    torch.cuda.reset_peak_memory_stats()
    with _sft_losses(warmup) as losses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base_params, _ = warmup.sft_warmup(cfg, ArithmeticTask(**EX_TASK),
                                           device="cuda", **EX_SFT)
        torch.cuda.synchronize()
        sft_s = time.perf_counter() - t0
    curve = [float(x) for x in losses]
    sft = {"steps": len(curve), "seconds": sft_s,
           "step_s": sft_s / max(len(curve), 1), "loss": curve,
           "first10_mean": float(np.mean(curve[:10])),
           "last10_mean": float(np.mean(curve[-10:])),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    t0 = time.perf_counter()
    base = warmup.eval_reward(cfg, base_params, ArithmeticTask(**EX_TASK))
    sft["base_eval"], sft["base_eval_s"] = base, time.perf_counter() - t0
    emit(dict({"phase": "examples_sft", "model": cfg.name,
               "dtype": cfg.dtype, **EX_SFT, "nvidia_smi": smi}, **sft))
    if not all(math.isfinite(x) for x in curve) \
            or not sft["last10_mean"] < 0.5 * sft["first10_mean"] \
            or not 0.0 < base < 1.0:
        raise AssertionError(f"SFT warmup: {sft}")
    torch.cuda.empty_cache()

    by_path, at_paths, runs = {}, {}, {}
    for name in ("a3po", "recompute"):
        torch.cuda.synchronize()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with _capture_ops(torch, _dense_sites(train=True)) as seen:
            state, recs, elapsed = _rl_from_base(
                torch, cfg, base_params, name, EX_RL["learning_rate"])
        # recompute's objective is not the A-3PO loss: its path has no
        # A-3PO kernel
        counts = _path_counts(TRAIN_PATH if name == "a3po"
                              else TRAIN_PATH[:4])
        peak = torch.cuda.max_memory_allocated() / 1e9
        _check_records(np, recs, f"examples {name}")
        final = warmup.eval_reward(cfg, state.params,
                                   ArithmeticTask(**EX_TASK))
        changed, total = _changed(torch, base_params, state.params)
        step_s = [r["rollout_time_s"] + r["train_time_s"] for r in recs]
        run = {"phase": "examples_rl", "algo": name, "model": cfg.name,
               "staleness": EX_STALENESS, "steps": len(recs),
               "elapsed_s": elapsed, "rewards": "the task's own",
               "reward": [r["reward"] for r in recs],
               "loss": [r["loss"] for r in recs],
               "entropy": [r["entropy"] for r in recs],
               "staleness_mean": [r["staleness_mean"] for r in recs],
               "eval": {r["step"]: r["eval_reward"] for r in recs
                        if r["eval_reward"] is not None},
               "base_eval": base, "final_eval": final,
               "prox_ms": [r["prox_time_s"] * 1e3 for r in recs],
               "mean_prox_ms": float(np.mean(
                   [r["prox_time_s"] for r in recs])) * 1e3,
               "rollout_s": [r["rollout_time_s"] for r in recs],
               "train_s": [r["train_time_s"] for r in recs],
               "step_s": step_s, "mean_step_s": float(np.mean(step_s[1:])),
               "params_changed": changed, "params_total": total,
               "peak_mem_gb": peak, "launches": counts,
               "learning_rate": EX_RL["learning_rate"],
               "collapse": _collapse([r["entropy"] for r in recs], final,
                                     base),
               "collapse_limits": {"entropy_share": COLLAPSE_ENTROPY_SHARE,
                                   "eval_drop": COLLAPSE_EVAL_DROP},
               "nvidia_smi": smi}
        emit(run)
        if changed == 0 or len(run["eval"]) != EX_RL_STEPS // EX_EVAL_EVERY \
                or min(counts.values()) <= 0 or run["collapse"]:
            raise AssertionError(f"examples {name}: {run}")
        run["held"] = _hold_path_kernels(torch, seen, "top_key_dropped")
        emit({"phase": "examples_rl_held", "algo": name,
              "kernels": run["held"]})
        at_paths[f"examples_{name}"] = _time_path_kernels(
            torch, seen, f"examples_{name}")
        by_path[f"examples_{name}"] = counts
        runs[name] = run
        del state, seen
        torch.cuda.empty_cache()
    if not runs["a3po"]["mean_prox_ms"] < runs["recompute"]["mean_prox_ms"]:
        raise AssertionError(
            f"prox ms: a3po {runs['a3po']['mean_prox_ms']}, recompute "
            f"{runs['recompute']['mean_prox_ms']}")
    emit({"phase": "examples_full", "model": cfg.name, "nvidia_smi": smi,
          "base_eval": base,
          "final_eval": {a: r["final_eval"] for a, r in runs.items()},
          "mean_prox_ms": {a: r["mean_prox_ms"] for a, r in runs.items()},
          "mean_step_s": {a: r["mean_step_s"] for a, r in runs.items()},
          "peak_mem_gb": {a: r["peak_mem_gb"] for a, r in runs.items()},
          "seconds": time.perf_counter() - t_phase})
    del base_params
    torch.cuda.empty_cache()
    return by_path, at_paths


# ------------------------------------------------------ 19: dense prefill
# bench_prefill's mix (benchmarks/bench_prefill.py:46) at the model's scale:
# its 12 short prompts (16 tokens at toy scale) and 2 long ones (96) become
# 32-64 and 1024 tokens, its 16 new tokens, 4 slots, budget 2 and no radix
# cache stay; pages of 16 and chunks of 256 as the other Qwen phases.
DP_MIX = dict(n_short=12, n_long=2, short_len=64, long_len=1024)
DP_MAX_NEW = 16
DP_ENGINE_KW = dict(max_seqs=4, block_size=16, n_blocks=1024,
                    max_blocks_per_seq=72, prefill_chunk=256, greedy=True)
DP_PREFILL_BUDGET = 2
# the radix wave's first prompts; a member keeps all but the last DP_TAIL
# tokens of one (within the dense rule's max(2 * 16, (P - 1) // 2)), and
# (P - DP_TAIL) % 16 != 0, so its first tail token writes into a shared page
DP_WAVE_LENS = (96, 161, 230, 307)
DP_TAIL = 8
DP_F32_LAYERS = 4
DP_F32_LOGITS_TOL = 1e-4
DP_MODES = ("dense", "chunked")


def _dp_prompts(cfg, n_short, n_long, short_len, long_len, seed=0):
    """``bench_prefill._workload``: the short prompts with the long ones
    spread through the queue."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shorts = [rng.integers(4, cfg.vocab_size, size=int(rng.integers(
        short_len // 2, short_len + 1))).astype(np.int32)
        for _ in range(n_short)]
    longs = [rng.integers(4, cfg.vocab_size, size=long_len).astype(np.int32)
             for _ in range(n_long)]
    prompts = list(shorts)
    stride = max(len(prompts) // (n_long + 1), 1)
    for i, p in enumerate(longs):
        prompts.insert(stride * (i + 1), p)
    return prompts


def _dp_plane(cfg, params, mode, cache):
    from repro_torch.async_rl.weights import WeightStore
    from repro_torch.rollout.continuous import ContinuousBatchingEngine
    from repro_torch.serving import (
        AdmissionScheduler,
        SchedulerConfig,
        ServingControlPlane,
    )
    eng = ContinuousBatchingEngine(cfg, device="cuda", prefill_mode=mode,
                                   **DP_ENGINE_KW)
    return ServingControlPlane(
        eng, WeightStore(params, 0),
        AdmissionScheduler(SchedulerConfig(d_max=1_000)),
        use_prefix_cache=cache, prefill_budget=DP_PREFILL_BUDGET)


def _dp_wave(torch, cp, prompts, on_step=None):
    """Submit ``prompts`` (TTFT counts the queueing) and step the plane
    until all finished. Returns (requests by rid, record)."""
    import numpy as np
    eng = cp.engine
    before = (eng.prefill_launches, eng.prefill_chunk_tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = {cp.submit(p, max_new=DP_MAX_NEW) for p in prompts}
    done, steps = [], 0
    while len(done) < len(prompts):
        done += cp.step()
        steps += 1
        if on_step is not None:
            on_step(steps)
        if steps > 10_000:
            raise AssertionError("dense prefill: the wave did not finish")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if {r.rid for r in done} != rids:
        raise AssertionError("dense prefill: other requests finished")
    ttft = np.array([r.t_first_token - r.t_submit for r in done])
    tokens = sum(len(r.generated) for r in done)
    return sorted(done, key=lambda r: r.rid), {
        "mode": eng.prefill_mode, "seconds": seconds, "steps": steps,
        "tokens": tokens, "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
        "ttft_max_ms": float(ttft.max()) * 1e3,
        "prefill_compiles": eng.prefill_compiles,
        "prefill_shapes": sorted(map(str, eng._prefill_shapes)),
        "prefill_launches": eng.prefill_launches - before[0],
        "prefill_chunk_tokens": eng.prefill_chunk_tokens - before[1]}


def phase_dense_prefill(torch, smi):
    """19: see the module docstring. Returns (launches by path, times by
    path)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.rollout.continuous import (
        ContinuousBatchingEngine,
        Request,
    )

    t_phase = time.perf_counter()
    cfg = get_config("qwen2.5-1.5b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.bfloat16)
    _scale_blocks(torch, params, SCALE)
    prompts = _dp_prompts(cfg, **DP_MIX)
    L = cfg.num_layers
    paths = {"dense": ("flash_attention", "paged_decode_attention"),
             "chunked": ("paged_prefill_attention", "paged_decode_attention")}
    by_path, at_paths, seen, runs, first = {}, {}, {}, {}, {}
    # (a) each mode once with its kernels captured and its launches counted
    for mode in DP_MODES:
        cp = _dp_plane(cfg, params, mode, False)
        with _capture_ops(torch, dict(_dense_sites(),
                                      **_paged_sites())) as got:
            _reset_counts()
            done, rec = _dp_wave(torch, cp, prompts)
            counts = _all_counts()
        seen[mode] = got
        by_path[f"dense_prefill_{mode}"] = {k: counts[k]
                                            for k in paths[mode]}
        rec["launches"] = {k: counts[k] for k in (
            "flash_attention", "paged_decode_attention",
            "paged_prefill_attention", "decode_attention")}
        rec["reference_checks"] = _reference_checks(
            torch, M, cfg, params, done, ENGINE_GAP_TOL, ENGINE_LOGP_TOL)
        runs[mode] = {"counted": rec, "timed": []}
        first[mode] = {r.rid: list(r.generated) for r in done}
        other = "paged_prefill_attention" if mode == "dense" \
            else "flash_attention"
        if (min(counts[k] for k in paths[mode]) <= 0 or counts[other]
                or (mode == "dense" and (
                    counts["flash_attention"] != L * len(prompts)
                    or rec["prefill_launches"] or rec["prefill_compiles"]
                    != len({cp.engine._dense_bucket(len(p))
                            for p in prompts})))):
            raise AssertionError(f"dense prefill, {mode}: {rec}")
        del cp
    # (b) timed in turn
    for mode in DP_MODES + DP_MODES[::-1]:
        cp = _dp_plane(cfg, params, mode, False)
        done, rec = _dp_wave(torch, cp, prompts)
        runs[mode]["timed"].append(rec)
        if {r.rid: list(r.generated) for r in done} != first[mode]:
            raise AssertionError(f"dense prefill, {mode}: a timed run's "
                                 "tokens differ from the first run's")
        del cp
    ab = {"phase": "dense_prefill_ab", "model": cfg.name, "dtype": "bfloat16",
          "layer_weight_scale": SCALE, "mix": DP_MIX, "max_new": DP_MAX_NEW,
          "engine": DP_ENGINE_KW, "prefill_budget": DP_PREFILL_BUDGET,
          "prompt_lens": [len(p) for p in prompts],
          "runs": runs, "nvidia_smi": smi}
    emit(ab)

    # (c) the radix wave in dense mode: members' tails through
    # _prefill_suffix, each forking the page it shares with its prompt
    rng = np.random.default_rng(12)
    wave = [rng.integers(4, cfg.vocab_size, size=n).astype(np.int32)
            for n in DP_WAVE_LENS]
    members = [np.concatenate([w[:len(w) - DP_TAIL], rng.integers(
        4, cfg.vocab_size, size=DP_TAIL).astype(np.int32)])
        for w in wave for _ in range(GROUP)]
    cp = _dp_plane(cfg, params, "dense", True)
    eng = cp.engine
    _reset_counts()
    warm, _ = _dp_wave(torch, cp, wave)
    forks0 = eng.allocator.forks

    def publish(step):
        if step == 2:
            cp.store.publish(params, 1)

    group, grec = _dp_wave(torch, cp, members, publish)
    counts = _all_counts()
    by_path["dense_prefill_radix"] = {k: counts[k]
                                      for k in paths["dense"]}
    hits = [r.prefix_hit_tokens for r in group]
    versions = sorted({v for r in group for v in r.token_versions})
    _check_stamps(warm + group, "dense prefill radix wave")
    radix = {"phase": "dense_prefill_radix", "wave_lens": DP_WAVE_LENS,
             "tail": DP_TAIL, "group": GROUP, "prefix_hits": hits,
             "cow_forks": eng.allocator.forks - forks0,
             "versions": versions, "interrupts": cp.metrics.interrupts,
             "group_wave": grec, "launches": by_path["dense_prefill_radix"],
             "reference_checks": _reference_checks(
                 torch, M, cfg, params, warm + group, ENGINE_GAP_TOL,
                 ENGINE_LOGP_TOL)}
    # each member forks the page its tail starts in and, where its prompt
    # ends inside a page (which the radix cache then shares), that page at
    # its first decode step
    bs = DP_ENGINE_KW["block_size"]
    # one member more, admitted straight into the engine: the paged decode
    # kernel captured on the last one-active-slot step of its tail
    extra = np.concatenate([wave[-1][:len(wave[-1]) - DP_TAIL],
                            rng.integers(4, cfg.vocab_size, size=DP_TAIL)
                            .astype(np.int32)])
    with _capture_ops(torch, _paged_sites()) as got:
        eng.admit_request(params, 0, Request(10_000, extra, DP_MAX_NEW),
                          version=1)
    seen["suffix"] = got
    radix["extra_hit"] = eng.slots[0].prefix_hit_tokens
    eng.release_slot(0)
    eng.prefix_cache.clear()
    radix["free_after_clear"] = eng.allocator.n_free
    emit(radix)
    if (hits != [len(m) - DP_TAIL for m in members]
            or radix["extra_hit"] != len(extra) - DP_TAIL
            or radix["cow_forks"] != sum(1 + (len(m) % bs != 0)
                                         for m in members)
            or versions != [0, 1]
            or grec["prefill_launches"] or grec["prefill_chunk_tokens"]
            or min(counts[k] for k in paths["dense"]) <= 0
            or eng.allocator.n_free != DP_ENGINE_KW["n_blocks"] - 1):
        raise AssertionError(f"dense prefill radix wave: {radix}")
    del cp, eng

    # (d) float32 at 4 layers: dense and chunked agree
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=DP_F32_LAYERS)
    params32 = M.init_params(cfg32,
                             torch.Generator(device="cuda").manual_seed(1),
                             device="cuda", dtype=torch.float32)
    _scale_blocks(torch, params32, SCALE)
    tokens, logits = {}, {}
    for mode in DP_MODES:
        done, _ = _dp_wave(torch, _dp_plane(cfg32, params32, mode, False),
                           prompts)
        tokens[mode] = [list(r.generated) for r in done]
        eng = ContinuousBatchingEngine(cfg32, device="cuda",
                                       prefill_mode=mode, **DP_ENGINE_KW)
        rows = []
        for i, p in enumerate(prompts):
            slot = i % eng.max_seqs
            if eng.slots[slot] is not None:
                eng.release_slot(slot)
            eng.admit_request(params32, slot, Request(i + 1, p, DP_MAX_NEW))
            rows.append(eng._next_logits[slot].clone())
        logits[mode] = torch.stack(rows)
        del eng
    diff = (logits["dense"] - logits["chunked"]).abs().max().item()
    f32 = {"phase": "dense_prefill_float32", "layers": DP_F32_LAYERS,
           "same_tokens": tokens["dense"] == tokens["chunked"],
           "max_abs_logits_diff": diff, "logits_tol": DP_F32_LOGITS_TOL,
           "max_abs_logit": logits["dense"].abs().max().item()}
    emit(f32)
    if not f32["same_tokens"] or not diff <= DP_F32_LOGITS_TOL:
        raise AssertionError(f"dense prefill float32: {f32}")
    del params32, logits
    torch.cuda.empty_cache()

    # (e) the kernels held and timed on their last calls
    held = {mode: dict(_hold_path_kernels(torch, seen[mode]),
                       **_hold_paged_kernels(torch, seen[mode]))
            for mode in DP_MODES}
    held["suffix"] = _hold_paged_kernels(torch, seen["suffix"])
    for label, names in (("dense", paths["dense"]),
                         ("chunked", paths["chunked"]),
                         ("suffix", ("paged_decode_attention",))):
        if set(held[label]) != set(names):
            raise AssertionError(f"dense prefill {label}: held "
                                 f"{sorted(held[label])} of {names}")
    emit({"phase": "dense_prefill_held", "kernels": held})
    at_paths["dense_prefill_dense"] = _time_path_kernels(
        torch, seen["dense"], "dense_prefill_dense")
    at_paths["dense_prefill_chunked"] = _time_paged(
        torch, seen["chunked"], "dense_prefill_chunked")
    at_paths["dense_prefill_suffix"] = _time_paged(
        torch, seen["suffix"], "dense_prefill_suffix")
    del seen, params
    torch.cuda.empty_cache()
    emit({"phase": "dense_prefill", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase})
    return by_path, at_paths


# ------------------------------------------------ SSM and hybrid training
# phase 20: mamba2-370m and zamba2-1.2b trained at full width and depth,
# bf16, SSM in/out projections x8 (SSM_SCALE). The training batch: 4
# prompts of 64-480 tokens x a group of 4, 64 sampled tokens, so rows of up
# to 544 tokens: two whole chunks of 256 and a third the scan pads
SSM_TRAIN_PROMPT_PAD = 480
SSM_TRAIN_MAX_NEW = 64
# The two routes of one SSM block at one tree, bf16: the training forward
# differentiates the plain float32 scan, the kernel route runs the
# intra-chunk kernel (its float32 sums in another order); each layer
# rounds y to bf16, so the routes part by bf16 roundings carried through
# 48 (38) layers. Held like the engines' behaviour logps (phase 4's bf16
# tolerance); a reference that drops the state carried into the second
# chunk must fail it.
SSM_ROUTE_LOGP_TOL = ENGINE_LOGP_TOL
# The SSM leaves' gradients at full width, 2 layers, float32, on the card
# against the same step on the CPU: the same float32 products summed in
# another order (cuBLAS against the CPU's GEMMs, the logprob kernel against
# its plain version): |card - cpu| <= rtol (|cpu| + max|cpu|)
SSM_F32_LAYERS = 2
SSM_F32_GRAD_RTOL = 1e-3
SSM_LEAVES = ("a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "in_proj",
              "norm", "out_proj")
# the loops: mamba2 through the sim engine sampled at top-p 0.9 (the
# sampler's cutoff path), zamba2 through --engine async
SSM_LOOP = {"mamba2-370m": ("sim", 0.9), "zamba2-1.2b": ("async", 1.0)}
SSM_LOOP_STEPS = 4
SSM_LOOP_STALENESS = 2
SSM_TRAIN_PATH = ("ssd_decode_step", "ssd_intra_chunk",
                  "token_logprob_entropy", "token_logprob_entropy_bwd",
                  "a3po_loss", "a3po_loss_bwd")
# zamba2's shared attention in the rollout (B 16, ~500 keys, H 32 = KV 32,
# hd 64) attends flatly at its init std, so a dense decode one key short,
# or without its top-scoring key, may stay within the bf16 tolerance; a
# kernel that read only the first half of each row's keys must not
SSM_DECODE_WRONG = ("top_key_dropped", "half_the_keys")


def _ssd_sites():
    """``_capture_ops`` sites of the two SSD kernel ops: the intra-chunk op
    where ``ssd_scan`` looks it up, the decode step where the model's
    one-token step does."""
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import ssm
    return {"ssd_intra_chunk": (sops, "ssd_intra_chunk_cum"),
            "ssd_decode_step": (ssm, "ssd_decode_step")}


def _hold_ssd_kernels(torch, seen):
    """The two SSD kernel ops held against their plain versions in float32
    on the inputs of their last call in a run (``_hold_ssd_decode``,
    ``_hold_ssd_intra``). The path's chunks may end on pad steps, so cdec's
    wrong reference leaves out the chunk's first decay. Returns the
    records."""
    recs = {}
    with torch.no_grad():
        if "ssd_intra_chunk" in seen:
            (xdt, la, b, c, L), _ = seen["ssd_intra_chunk"]
            B, S, nh, hd = xdt.shape
            recs["ssd_intra_chunk"] = {
                "name": "ssd_intra_chunk", "dtype": str(b.dtype),
                "shape": {"B": B, "S": S, "chunk": L, "nh": nh, "hd": hd,
                          "ds": b.shape[-1]},
                **_hold_ssd_intra(torch, xdt, la, b, c, L,
                                  cdec_wrong="first_decay_dropped")}
        if "ssd_decode_step" in seen:
            (state, x, dt, a_log, b, c), _ = seen["ssd_decode_step"]
            recs["ssd_decode_step"] = {
                "name": "ssd_decode_step", "dtype": str(x.dtype),
                "shape": {"B": state.shape[0], "nh": state.shape[1],
                          "hd": state.shape[2], "ds": state.shape[3]},
                **_hold_ssd_decode(torch, state, x, dt, a_log, b, c)[2]}
    return recs


def _time_ssd_path(torch, seen, label):
    """The SSD kernel ops timed on the inputs of their last call in a run
    (``_ssd_intra_times``, ``_ssd_decode_times``). Returns {kernel name:
    record}, the records also printed."""
    timer = Timer(torch)
    out = {}
    with torch.no_grad():
        if "ssd_intra_chunk" in seen:
            (xdt, la, b, c, L), _ = seen["ssd_intra_chunk"]
            B, S, nh, hd = xdt.shape
            out["ssd_intra_chunk"] = {
                "phase": "kernel", "name": "ssd_intra_chunk", "case": label,
                "dtype": str(b.dtype).split(".")[-1],
                "shape": {"B": B, "S": S, "chunk": L, "nh": nh, "hd": hd,
                          "ds": b.shape[-1]},
                **_ssd_intra_times(torch, timer, xdt, la, b, c, L, 10, 3)}
        if "ssd_decode_step" in seen:
            (state, x, dt, a_log, b, c), _ = seen["ssd_decode_step"]
            out["ssd_decode_step"] = {
                "phase": "kernel", "name": "ssd_decode_step", "case": label,
                "dtype": str(x.dtype).split(".")[-1],
                "shape": {"B": state.shape[0], "nh": state.shape[1],
                          "hd": state.shape[2], "ds": state.shape[3]},
                **_ssd_decode_times(torch, timer, state.clone(), state, x,
                                    dt, a_log, b, c)}
    for rec in out.values():
        emit(rec)
    del timer
    return out


@contextlib.contextmanager
def _ssd_state_dropped(torch, ssm_mod):
    """The kernel route with the state carried into each sequence's second
    chunk dropped: a scan that loses one chunk boundary's state."""
    plain = ssm_mod.ssd_scan

    def scan(x, dt, a_log, b, c, *, chunk, initial_state=None, **kw):
        if x.shape[1] <= chunk:
            return plain(x, dt, a_log, b, c, chunk=chunk,
                         initial_state=initial_state, **kw)
        y1, _ = plain(x[:, :chunk], dt[:, :chunk], a_log, b[:, :chunk],
                      c[:, :chunk], chunk=chunk, initial_state=initial_state,
                      **kw)
        y2, st = plain(x[:, chunk:], dt[:, chunk:], a_log, b[:, chunk:],
                       c[:, chunk:], chunk=chunk, **kw)
        return torch.cat([y1, y2], dim=1), st

    ssm_mod.ssd_scan = scan
    try:
        yield
    finally:
        ssm_mod.ssd_scan = plain


def _ssm_route_logps(torch, cfg, params, tokens):
    """Token logps [B, T-1] through the training forward's route: detached
    views of every leaf that require a gradient, gradients enabled (the
    differentiable scan), no backward. Fails if the intra-chunk kernel
    ran."""
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.optimizer import flatten, unflatten
    n0 = sops.LAUNCHES["ssd_intra_chunk"]
    views = {k: v.detach().requires_grad_(True)
             for k, v in flatten(params).items()}
    with torch.enable_grad():
        lp = trainer_mod._score_tokens(unflatten(views), cfg, tokens)[0]
    if sops.LAUNCHES["ssd_intra_chunk"] != n0:
        raise AssertionError("the grad-enabled forward ran the intra-chunk "
                             "kernel")
    return lp.detach()


def _ssm_f32_grads(torch, name, tokens):
    """Full width, SSM_F32_LAYERS layers, float32: the gradient of a seeded
    linear function of the token logps and entropies with respect to every
    SSM leaf, on the card and on the CPU from the same weights; then one
    Adam step (RLConfig's defaults) of those leaves on the card, which must
    move every one of them (in float32 an lr-sized step is not rounded
    away, as it is at bf16 leaves near 1). Returns the record."""
    from repro_torch.configs.base import RLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.optimizer import (
        adam_init,
        adam_update,
        flatten,
        unflatten,
    )
    cfg = dataclasses.replace(get_config(name), num_layers=SSM_F32_LAYERS,
                              dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(21), device="cpu",
                        requires_grad=True)
    with torch.no_grad():
        _scale_ssm(cpu, SSM_SCALE[name])
    g = torch.Generator().manual_seed(22)
    gl, ge = torch.randn(2, *tokens[:, 1:].shape, generator=g)
    grads = {}
    for dev in ("cuda", "cpu"):
        views = {k: v.detach().to(dev).requires_grad_(True)
                 for k, v in flatten(cpu).items()}
        lp, en, _ = trainer_mod._score_tokens(unflatten(views), cfg,
                                              tokens.to(dev))
        loss = (lp * gl.to(dev)).sum() + (en * ge.to(dev)).sum()
        keys = [k for k in views if "/ssm/" in f"/{k}"]
        gs = torch.autograd.grad(loss, [views[k] for k in keys])
        if dev == "cuda":
            leaves = unflatten({k: views[k].detach() for k in keys})
            new, _, _ = adam_update(unflatten(dict(zip(keys, gs))),
                                    adam_init(leaves), leaves, RLConfig())
            new = flatten(new)
            moved = {k: (new[k] != views[k]).float().mean().item()
                     for k in keys}
            del leaves, new
        grads[dev] = dict(zip(keys, (t.cpu() for t in gs)))
        del views, lp, en, loss, gs
    rec = {"layers": SSM_F32_LAYERS, "tokens": list(tokens.shape),
           "rtol": SSM_F32_GRAD_RTOL, "leaves": {}}
    bad = [k for k, share in moved.items() if not share > 0]
    for k, ref in grads["cpu"].items():
        got = grads["cuda"][k]
        scale = ref.abs().max().item()
        ratio = ((got - ref).abs() / (SSM_F32_GRAD_RTOL * (
            ref.abs() + scale))).max().item()
        rec["leaves"][k.rsplit("/", 1)[-1]] = {
            "err_over_tol": ratio, "max_abs": scale,
            "adam_step_moved_share": moved[k]}
        if not (ratio <= 1.0 and scale > 0
                and bool(torch.isfinite(got).all())):
            bad.append(k)
    if sorted(rec["leaves"]) != sorted(SSM_LEAVES) or bad:
        raise AssertionError(f"{name} float32 card vs CPU gradients or "
                             f"Adam step {bad}: {rec}")
    return rec


def _ssm_train_step_program(torch, cfg, params, rb):
    """(b) for one SSM stack: launch/steps.py's make_train_step (A-3PO, 4
    microbatches) on the rollout's batch with seeded advantages, the
    counts at 0 just before it: loss, entropy and gradient norm finite,
    the parameters moved, the logprob and A-3PO kernels launched and the
    intra-chunk kernel not. Returns (record, launches)."""
    import numpy as np
    from repro_torch.configs.base import RLConfig
    from repro_torch.launch import steps
    from repro_torch.training import adam_init
    step = steps.make_train_step(cfg, RLConfig(), "a3po",
                                 num_microbatches=STEPS_MICRO)
    batch = _steps_batch(torch, rb, np)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    new, _, loss, ent, gn = step(params, adam_init(params), batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _path_counts(SSM_TRAIN_PATH)
    changed, total = _changed(torch, params, new)
    rec = {"seconds": secs, "loss": float(loss), "entropy": float(ent),
           "grad_norm": float(gn), "params_changed": changed,
           "params_total": total, "batch": list(batch["tokens"].shape),
           "microbatches": STEPS_MICRO, "launches": launches}
    if not all(math.isfinite(rec[k]) for k in ("loss", "entropy",
                                                "grad_norm")) \
            or changed == 0 or launches["ssd_intra_chunk"] != 0 \
            or launches["ssd_decode_step"] != 0 \
            or min(launches[k] for k in SSM_TRAIN_PATH[2:]) <= 0:
        raise AssertionError(f"{cfg.name} make_train_step: {rec}")
    return rec, launches


def _ssm_trainer(torch, name, smi):
    """(a, b) ``name`` at full width and depth, bf16, SSM projections x8:
    4 prompts x a group of 4 sampled through the dense RolloutEngine
    (version 0, seeded Bernoulli rewards), then one a3po Trainer.step at
    staleness 1 and one recompute step after it; for mamba2 also the step
    program. A hybrid stack's rollout runs its shared attention through
    flash (prefill) and dense decode, which join the path's kernels.
    Returns (launches by path, times by path)."""
    import numpy as np
    from repro_torch.configs.base import RLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import model as M
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.rollout.engine import RolloutEngine
    from repro_torch.training import (
        Trainer,
        TrainState,
        adam_init,
        assemble_train_batch,
    )
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.optimizer import flatten
    from repro_torch.training.trainer import METRIC_KEYS

    cfg = get_config(name)
    path = SSM_TRAIN_PATH + (DENSE_ROLLOUT_PATH if "attn" in cfg.block_kinds()
                             else ())
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                           device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)
    with torch.no_grad():
        _scale_ssm(params, SSM_SCALE[name])
    rng = np.random.default_rng(14)
    prompts, lengths = _ragged_prompts(cfg, TRAIN_PROMPTS,
                                       SSM_TRAIN_PROMPT_PAD, 15)
    prompts = np.repeat(prompts, GROUP, axis=0)
    lengths = np.repeat(lengths, GROUP)
    engine = RolloutEngine(cfg, RLConfig(temperature=1.0, top_p=1.0),
                           max_new_tokens=SSM_TRAIN_MAX_NEW)
    rl = RLConfig(group_size=GROUP, num_minibatches=4)
    trainers = {a: Trainer(cfg, rl, a) for a in ("a3po", "recompute")}
    state = TrainState(params, adam_init(params),
                       torch.ones((), dtype=torch.int32, device="cuda"))
    prox_seen = {}
    plain_prox = trainer_mod.recompute_prox_logp

    def prox_kept(p, cfg_, tokens):
        prox_seen["logp"] = plain_prox(p, cfg_, tokens)
        return prox_seen["logp"]

    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    trainer_mod.recompute_prox_logp = prox_kept
    try:
        with _capture_ops(torch, {**_dense_sites(train=True),
                                  **_ssd_sites()}) as seen:
            t0 = time.perf_counter()
            rb = engine.generate(params, prompts, lengths,
                                 torch.Generator(device="cuda").manual_seed(
                                     16), version=0)
            serve_s = time.perf_counter() - t0
            gen = _check_generated(np, rb, f"{name} rollout")
            batch = assemble_train_batch(
                [rb], rng.binomial(1, 0.5, len(lengths)).astype(np.float32),
                device="cuda")
            for algo in ("a3po", "recompute"):
                before = state
                # Adam's float32 first moment, updated in place: a leaf
                # got a gradient in this step iff its m is not b1 * m
                m_old = {k: rl.adam_b1 * v for k, v in
                         flatten(state.opt["m"]).items()}
                n0 = sops.LAUNCHES["ssd_intra_chunk"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, m = trainers[algo].step(state, batch)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                _check_metrics(np, m, METRIC_KEYS)
                m_new = flatten(new.opt["m"])
                no_grad = [k for k, v in m_new.items()
                           if torch.equal(v, m_old[k])
                           or not bool(torch.isfinite(v).all())]
                del m_old, m_new
                old, upd = flatten(state.params), flatten(new.params)
                # bf16 leaves of size ~1 (norm scales, d_skip, dt_bias)
                # round an lr-sized update away: reported, not failed
                still = [k for k in old if torch.equal(old[k], upd[k])]
                intra = sops.LAUNCHES["ssd_intra_chunk"] - n0
                rec = {"algo": algo, "seconds": secs,
                       "prox_time_s": m["prox_time_s"],
                       "staleness": m["staleness_mean"],
                       "leaves": len(old), "leaves_without_gradient":
                       no_grad, "leaves_unmoved_in_bf16": still,
                       "ssd_intra_chunk_launches": intra,
                       "host_syncs": trainers[algo].last_host_syncs,
                       "peak_mem_gb": torch.cuda.max_memory_allocated()
                       / 1e9,
                       "metrics": {k: m[k] for k in METRIC_KEYS}}
                n_ssm = cfg.block_kinds().count("ssm")
                if no_grad or len(still) == len(old) \
                        or m["staleness_mean"] != len(steps) + 1 \
                        or intra != (n_ssm if algo == "recompute" else 0) \
                        or (algo == "a3po" and m["iw_mean"] != 1.0):
                    raise AssertionError(f"{name} {algo} step: {rec}")
                steps.append(rec)
                state = new
    finally:
        trainer_mod.recompute_prox_logp = plain_prox
    launches = _path_counts(path)
    if min(launches.values()) <= 0 \
            or any(k not in seen for k in path if not k.endswith("_bwd")):
        raise AssertionError(f"{name} training launches {launches}")

    # (a) the routes at recompute's parameters: its prox logps (the kernel
    # route, captured in the step) against the training forward's route,
    # and a kernel route that drops the state into the second chunk
    parts = {}
    t0 = time.perf_counter()
    mask = batch.response_mask > 0
    with torch.no_grad():
        grad_route = _ssm_route_logps(torch, cfg, before.params, batch.tokens)
        with _ssd_state_dropped(torch, ssm_mod):
            wrong = trainer_mod.score_tokens(before.params, cfg,
                                             batch.tokens)[0]
    gaps = {k: (v - grad_route)[mask].abs() for k, v in (
        ("prox", prox_seen["logp"]), ("state_dropped", wrong))}
    routes = {"tol": SSM_ROUTE_LOGP_TOL, "tokens": int(mask.sum()),
              "max_abs_gap": gaps["prox"].max().item(),
              "mean_abs_gap": gaps["prox"].mean().item(),
              "wrong_state_dropped_max_abs_gap":
                  gaps["state_dropped"].max().item(),
              "wrong_state_dropped_mean_abs_gap":
                  gaps["state_dropped"].mean().item()}
    if not (routes["max_abs_gap"] <= SSM_ROUTE_LOGP_TOL
            < routes["wrong_state_dropped_max_abs_gap"]):
        raise AssertionError(f"{name}: kernel and training routes {routes}")
    del grad_route, wrong, gaps, prox_seen
    torch.cuda.empty_cache()
    parts["routes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    held = _hold_path_kernels(torch, seen, SSM_DECODE_WRONG)
    held.update(_hold_ssd_kernels(torch, seen))
    parts["held_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    times = _time_path_kernels(torch, seen, f"ssm_train_{name}")
    times.update(_time_ssd_path(torch, seen, f"ssm_train_{name}"))
    parts["timed_s"] = time.perf_counter() - t0
    del seen
    t0 = time.perf_counter()
    f32 = _ssm_f32_grads(torch, name, batch.tokens[:1].cpu())
    parts["float32_grads_s"] = time.perf_counter() - t0

    by_path = {f"ssm_train_{name}": launches}
    program = None
    if name == "mamba2-370m":
        program, by_path[f"ssm_steps_{name}"] = _ssm_train_step_program(
            torch, cfg, state.params, rb)

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainers["a3po"].step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    # the raw device events against prof.events() once a run (~35 s)
    prof = _device_profile(torch, step, cross_check=name == "mamba2-370m")
    parts["profile_s"] = time.perf_counter() - t0
    emit({"phase": "ssm_training", "model": name, "layers": cfg.num_layers,
          "params": cfg.num_params(), "dtype": "bfloat16",
          "ssm_proj_scale": SSM_SCALE[name], "nvidia_smi": smi,
          "batch": list(batch.tokens.shape), "minibatches": 4,
          "serve_s": serve_s, "generated": gen, "steps": steps,
          "routes": routes, "float32_grads": f32, "launches": launches,
          "held": held, "check_seconds": parts,
          "make_train_step": program, "a3po_step_profile": {
              k: prof[k] for k in ("wall_s", "device_busy_s",
                                   "device_idle_share",
                                   "top_device_kernels", "cross_check")}})
    del params, state, new, before, engine, batch
    torch.cuda.empty_cache()
    return by_path, {f"ssm_train_{name}": times}


def _row_logps_by_stamp(torch, M, cfg, trees, toks, P, stamps):
    """The logps of a row's generated tokens toks[P:] as the engine made
    them across publishes: the prompt prefilled under the first token's
    version, then each token i > 0 fed under token i's stamp (the version
    whose step produced its logits), on one dense cache."""
    from repro_torch.models.layers import logits_from_hidden
    n = len(stamps)
    tree = trees[int(stamps[0])]
    h, cache = M.prefill(tree, cfg, toks[None, :P], max_len=P + n)
    out = [torch.log_softmax(logits_from_hidden(
        tree["embedding"], h[:, -1], cfg), dim=-1)[0, toks[P]]]
    for i in range(1, n):
        logits, cache = M.decode_step(trees[int(stamps[i])], cfg, cache,
                                      toks[None, P + i - 1])
        out.append(torch.log_softmax(logits, dim=-1)[0, toks[P + i]])
    return torch.stack(out)


def _check_stamped_behaviour(torch, M, cfg, rollouts, trees):
    """Every behaviour logp of the control plane's rollouts against the
    trees that made it: a row generated under one version against that
    tree's forward_logits; a row that crossed a publish (in-flight rows
    resume under the new tree on their cache) token by token through
    ``_row_logps_by_stamp``."""
    import numpy as np
    worst, n_tok, n_mixed, logp_sum = 0.0, 0, 0, 0.0
    dev = "cuda"
    with torch.no_grad():
        for rb in rollouts:
            stamps = (rb.gen_versions if rb.gen_versions is not None
                      else np.full(rb.gen_logp.shape, rb.version))
            toks = torch.as_tensor(rb.tokens.astype(np.int64), device=dev)
            rows = {}
            for b in range(rb.batch_size):
                n = int(rb.gen_mask[b].sum())
                vs = stamps[b, :n]
                if n and (vs == vs[0]).all():
                    rows.setdefault(int(vs[0]), []).append(b)
                elif n:
                    P = int(rb.prompt_lengths[b])
                    ref = _row_logps_by_stamp(torch, M, cfg, trees, toks[b],
                                              P, vs).cpu().numpy()
                    worst = max(worst, float(np.abs(
                        ref - rb.gen_logp[b, :n]).max()))
                    n_mixed += n
            for v, bs in rows.items():
                lp = torch.log_softmax(M.forward_logits(
                    trees[v], cfg, toks[bs, :-1]), dim=-1)
                for i, b in enumerate(bs):
                    P = int(rb.prompt_lengths[b])
                    n = int(rb.gen_mask[b].sum())
                    ref = lp[i, P - 1: P - 1 + n].gather(
                        -1, toks[b, P: P + n, None])[:, 0].cpu().numpy()
                    worst = max(worst, float(np.abs(
                        ref - rb.gen_logp[b, :n]).max()))
            for b in range(rb.batch_size):
                n = int(rb.gen_mask[b].sum())
                n_tok += n
                logp_sum += float(rb.gen_logp[b, :n].sum())
    out = {"batches": len(rollouts), "tokens_checked": n_tok,
           "tokens_across_publishes": n_mixed,
           "behaviour_logp_max_abs_err": worst,
           "mean_behaviour_logp": logp_sum / max(n_tok, 1),
           "logp_tol": ENGINE_LOGP_TOL, "max_mean_logp": MAX_MEAN_LOGP,
           "versions": sorted(trees)}
    if n_tok == 0 or worst > ENGINE_LOGP_TOL \
            or out["mean_behaviour_logp"] > MAX_MEAN_LOGP:
        raise AssertionError(f"stamped behaviour: {out}")
    return out


@contextlib.contextmanager
def _recorded_async_run(torch):
    """Record, from an --engine async run, every tree the orchestrator's
    weight store held (by version) and every RolloutBatch the control
    plane returned."""
    from repro_torch.async_rl import orchestrator
    from repro_torch.serving.control_plane import ServingControlPlane
    kept = {"trees": {}, "rollouts": []}
    plain_store = orchestrator.WeightStore
    plain_gen = ServingControlPlane.generate_batch

    class Store(plain_store):
        def __init__(self, params, version=0):
            super().__init__(params, version)
            kept["trees"][version] = params

        def publish(self, params, version):
            kept["trees"][version] = params
            super().publish(params, version)

    def generate_batch(self, *args, **kw):
        rb = plain_gen(self, *args, **kw)
        kept["rollouts"].append(rb)
        return rb

    orchestrator.WeightStore = Store
    ServingControlPlane.generate_batch = generate_batch
    try:
        yield kept
    finally:
        orchestrator.WeightStore = plain_store
        ServingControlPlane.generate_batch = plain_gen


def _ssm_loop(torch, name, tmp):
    """(c) The launcher on ``name`` at full size, a3po, seeded Bernoulli
    rewards, SSM projections x8: mamba2 with --engine sim at staleness 2,
    sampled at top-p 0.9; zamba2 with --engine async. Every behaviour logp
    against forward_logits of the tree that made it; each kernel op of
    the path held against its plain version on its last call and timed
    there. Returns (path name, launches, times)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.obs.runlog import read_jsonl

    engine, top_p = SSM_LOOP[name]
    cfg = get_config(name)
    path = str(tmp / f"ssm_{name}.jsonl")
    argv = ["--arch", name, "--steps", str(SSM_LOOP_STEPS), "--algo",
            "a3po", "--engine", engine, "--log-jsonl", path, "--quiet"]
    kept = {}

    def scale(p):
        _scale_ssm(p, SSM_SCALE[name])
    kinds = ["ssd_decode_step", "ssd_intra_chunk", "token_logprob_entropy",
             "token_logprob_entropy_bwd", "a3po_loss", "a3po_loss_bwd"]
    torch.cuda.reset_peak_memory_stats()
    if engine == "sim":
        argv += ["--staleness", str(SSM_LOOP_STALENESS)]
        with _scaled_launcher(torch, train, cfg, kept, scale=scale,
                              top_p=top_p), \
                _capture_path(torch, extra=_ssd_sites()) as seen:
            _reset_counts()
            t0 = time.perf_counter()
            train.main(argv)
            elapsed = time.perf_counter() - t0
            counts = _path_counts(kinds)
        t_checks = time.perf_counter()
        rollouts, trees = seen.pop("rollouts"), seen.pop("trees")
        behaviour = _check_behaviour(torch, M, cfg, rollouts,
                                     kept["state"].params, trees,
                                     SSM_LOOP_STALENESS)
    else:
        kinds += ["paged_decode_attention", "paged_prefill_attention"]
        with _scaled_orchestrator(torch, train, kept, scale=scale), \
                _recorded_async_run(torch) as run, \
                _capture_ops(torch, {**_paged_sites(), **_ssd_sites(),
                                     **_dense_sites(train=True)}) as seen:
            _reset_counts()
            t0 = time.perf_counter()
            train.main(argv)
            elapsed = time.perf_counter() - t0
            counts = _path_counts(kinds)
        t_checks = time.perf_counter()
        behaviour = _check_stamped_behaviour(torch, M, cfg, run["rollouts"],
                                             run["trees"])
        orch = kept["orch"]
        behaviour["worker_crashes"] = len(orch.worker.crashes)
        if orch.worker.crashes or orch.worker.alive:
            raise AssertionError(f"{name} --engine async worker: "
                                 f"{orch.worker.crashes}")
        del run
    peak = torch.cuda.max_memory_allocated() / 1e9
    recs = read_jsonl(path)
    _check_records(np, recs, f"{name} {engine}")
    rec = {"phase": "ssm_loop", "model": name, "engine": engine,
           "top_p": top_p, "rewards": "seeded Bernoulli(0.5)",
           "ssm_proj_scale": SSM_SCALE[name], "steps": len(recs),
           "elapsed_s": elapsed, "steps_per_s": len(recs) / elapsed,
           "staleness": [r["staleness_mean"] for r in recs],
           "host_syncs": [r["host_syncs"] for r in recs],
           "rollout_s": [r["rollout_time_s"] for r in recs],
           "train_s": [r["train_time_s"] for r in recs],
           "reward": [r["reward"] for r in recs],
           "loss": [r["loss"] for r in recs],
           "peak_mem_gb": peak, "launches": counts, **behaviour}
    emit(rec)
    stale_ok = (rec["staleness"] == [0.0, 1.0, 2.0, 2.0] if engine == "sim"
                else all(0 <= s <= SSM_LOOP_STALENESS + 1
                         for s in rec["staleness"]))
    if len(recs) != SSM_LOOP_STEPS or not stale_ok \
            or rec["host_syncs"] != [1.0] * SSM_LOOP_STEPS \
            or min(counts.values()) <= 0 \
            or any(k not in seen for k in kinds if not k.endswith("_bwd")):
        raise AssertionError(f"{name} loop: {rec}")
    label = f"ssm_{engine}_{name}"
    held = _hold_path_kernels(torch, seen)
    held.update(_hold_ssd_kernels(torch, seen))
    held.update(_hold_paged_kernels(torch, seen))
    times = _time_path_kernels(torch, seen, label)
    times.update(_time_ssd_path(torch, seen, label))
    times.update(_time_paged(torch, seen, label))
    emit({"phase": "ssm_loop_checks", "model": name, "kernels": held,
          "seconds": time.perf_counter() - t_checks})
    del seen, kept
    torch.cuda.empty_cache()
    return label, counts, times


def phase_ssm_training(torch, tmp, smi):
    """Phase 20: SSM and hybrid training on the card, each path driven with
    the counts set to 0 just before it. Returns (launches by path, times
    by path)."""
    t_phase = time.perf_counter()
    by_path, at_paths = {}, {}
    for name in SSM_SCALE:
        launches, times = _ssm_trainer(torch, name, smi)
        by_path.update(launches)
        at_paths.update(times)
        label, by_path_loop, times = _ssm_loop(torch, name, tmp)
        by_path[label], at_paths[label] = by_path_loop, times
    emit({"phase": "ssm_training_phase", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase})
    return by_path, at_paths


def _release(torch):
    """Free what the last phase left: the cycles that still hold device
    tensors (a phase's closures, its engine and trainer), then the
    allocator's cache. Without the collection, when such a cycle is freed
    depends on when Python's collector happens to run."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    import torch
    phase_build()
    # phase 17 (f)'s dry-runs need only the host: they run beside the
    # card's phases from here, and phase 17 collects them
    with tempfile.TemporaryDirectory() as tmp:
        procs = _start_dryruns(Path(tmp))
        try:
            return _main(torch, smi, t_start, Path(tmp), procs)
        finally:
            for _, log, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()


def _main(torch, smi, t_start, dry_tmp, dry_procs) -> int:
    with torch.no_grad():
        kernels = phase_kernels(torch)
        launches = phase_engine(torch)
    _release(torch)
    kernels.update(phase_training_kernels(torch))
    _release(torch)
    launches.update({k: v for k, v in phase_training(torch).items()
                     if k not in launches})
    phase_training_f32(torch)
    _release(torch)
    with torch.no_grad():
        kernels.update(phase_dense_kernels(torch))
    _release(torch)
    launches.update(phase_rollout(torch))
    with tempfile.TemporaryDirectory() as tmp:
        phase_async_rl(torch, Path(tmp))
        _release(torch)
        cp_launches = phase_control_plane(torch, Path(tmp))
        _release(torch)
        # the fault-tolerance runtime and the load harness, each path
        # driven with the counts set to 0 just before it
        by_path = {"resume": phase_resume(torch, Path(tmp)),
                   "guard": phase_guard(torch, Path(tmp))}
        by_path["engine_async_faults"], async_times = phase_async_faults(
            torch, Path(tmp))
        by_path["loadgen_replay"], loadgen_times = phase_loadgen(
            torch, Path(tmp), smi)
    at_paths = {"engine_async_faults": async_times,
                "loadgen_replay": loadgen_times}
    _release(torch)
    with torch.no_grad():
        kernels.update(phase_ssd_kernels(torch))
        ssm = [phase_ssm_serving(torch, name) for name in SSM_SCALE]
    for k in ("ssd_decode_step", "ssd_intra_chunk"):
        launches[k] = sum(run[k] for run in ssm)
    _release(torch)
    # the MoE, MLA and frontend stacks, each path driven with the counts
    # set to 0 just before it
    with torch.no_grad():
        by_path["moe_rollout"], at_paths["moe_rollout"] = phase_moe_serving(
            torch)
    _release(torch)  # the launcher's subprocess needs 64.8 GB
    phase_serve_launcher(torch)
    for name in ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"):
        by_path[f"moe_train_{name}"], at_paths[f"moe_train_{name}"] = \
            phase_moe_training(torch, name)
    with torch.no_grad():
        for name in ("llava-next-mistral-7b", "musicgen-large"):
            by_path[f"frontend_{name}"], at_paths[f"frontend_{name}"] = \
                phase_frontend(torch, name)
    _release(torch)
    # the examples, each path driven with the counts set to 0 just before
    # it, then train_async_rl's path at full width
    t_examples = time.perf_counter()
    by_path.update(phase_examples(torch, dry_tmp))
    full_launches, full_times = phase_examples_full(torch, smi)
    by_path.update(full_launches)
    at_paths.update(full_times)
    emit({"phase": "examples_phase", "seconds":
          time.perf_counter() - t_examples})
    _release(torch)
    by_path["steps"], at_paths["steps"] = phase_steps(torch, dry_tmp,
                                                      dry_procs)
    _release(torch)
    with torch.no_grad():
        dp_launches, dp_times = phase_dense_prefill(torch, smi)
    by_path.update(dp_launches)
    at_paths.update(dp_times)
    _release(torch)
    with tempfile.TemporaryDirectory() as tmp:
        ssm_launches, ssm_times = phase_ssm_training(torch, Path(tmp), smi)
    by_path.update(ssm_launches)
    at_paths.update(ssm_times)
    src = {"paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
        "src/repro/kernels/decode_attn/paged_kernel.py:69"),
        "paged_prefill_attention": (
        "src/repro_torch/kernels/csrc/paged_prefill_attn.cu",
        "src/repro/kernels/prefill_attn/kernel.py:85"),
        "a3po_loss": (
        "src/repro_torch/kernels/csrc/a3po_loss.cu",
        "src/repro/kernels/a3po_loss/kernel.py:44"),
        "a3po_loss_bwd": (
        "src/repro_torch/kernels/csrc/a3po_loss.cu",
        "src/repro/kernels/a3po_loss/ops.py:45"),
        "token_logprob_entropy": (
        "src/repro_torch/kernels/csrc/token_logprob_entropy.cu",
        "src/repro/kernels/logprob/kernel.py:87"),
        "token_logprob_entropy_bwd": (
        "src/repro_torch/kernels/csrc/token_logprob_entropy.cu",
        "src/repro/kernels/logprob/kernel.py:87"),
        "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attn.cu",
        "src/repro/kernels/flash_attn/kernel.py:72"),
        "decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attn.cu",
        "src/repro/kernels/decode_attn/kernel.py:57"),
        "ssd_decode_step": (
        "src/repro_torch/kernels/csrc/ssd.cu",
        "src/repro/kernels/ssd/kernel.py:63"),
        "ssd_intra_chunk": (
        "src/repro_torch/kernels/csrc/ssd.cu",
        "src/repro/kernels/ssd/kernel.py:102")}
    line = []
    for name, (source, replaces) in src.items():
        k = kernels[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"],
                     "shape": k.get("shape")})
        wgmma = {"token_logprob_entropy": "token_logprob_entropy_wgmma",
                 "token_logprob_entropy_bwd":
                 "token_logprob_entropy_bwd_wgmma"}.get(name)
        if wgmma:
            line[-1]["wgmma_launches"] = launches[wgmma]
        if name == "token_logprob_entropy_bwd":
            line[-1]["peak_mem_gb_above_inputs"] = k[
                "peak_mem_gb_above_inputs"]
        if "splits" in k:
            line[-1]["splits"] = k["splits"]
        cp_by_path = {p: n[name] for p, n in cp_launches.items()
                      if name in n}
        if cp_by_path:
            line[-1]["control_plane_launches"] = cp_by_path
        line[-1]["launches_by_path"] = {p: n[name] for p, n in by_path.items()
                                        if name in n}
        timed = {p: {k: t[name][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "dtype",
            "shape")} for p, t in at_paths.items() if name in t}
        if timed:
            line[-1]["at_paths"] = timed
        for extra in ("launch_floor_ms", "parent_path_ms", "path_ms"):
            if extra in k:
                line[-1][extra] = k[extra]
    emit({"phase": "done", "elapsed_s": time.perf_counter() - t_start})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
