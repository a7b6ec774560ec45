"""Quickstart on the PyTorch port: the A-3PO approximation + the
Algorithm API (the counterpart of ``examples/quickstart.py``).

Shows the paper's core idea standalone — approximate the proximal policy by
staleness-aware log-linear interpolation instead of a forward pass — then
runs the same data through pluggable Algorithm objects from the registry
(on the card the A-3PO built-in runs the reduced A-3PO loss kernel).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import RLConfig
from repro_torch.core.a3po import compute_prox_logp_approximation
from repro_torch.core.algorithms import LossInputs, available, get_algorithm
from repro_torch.models.model import require_device

B, T = 4, 16


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)
    device = require_device(args.device)
    g = torch.Generator(device=device).manual_seed(0)
    rl = RLConfig()

    # what the rollout engine hands the trainer:
    behav_logp = -torch.rand((B, T), generator=g, device=device) * 2
    versions = torch.tensor([0, 1, 2, 3], device=device)  # behavior versions
    current_version = 3                                    # v(pi_theta)

    # what the live policy says about the same tokens (the training fwd):
    logp = behav_logp + 0.1 * torch.randn((B, T), generator=g, device=device)

    # --- the paper's Listing 1: no forward pass, elementwise only ---------
    prox_logp = compute_prox_logp_approximation(
        behav_logp, logp, versions, current_version, rl)
    print("staleness d:", (current_version - versions).tolist())
    print("prox sandwiched between behav/target:",
          bool(torch.all(
              (prox_logp >= torch.minimum(behav_logp, logp) - 1e-6)
              & (prox_logp <= torch.maximum(behav_logp, logp) + 1e-6))))

    # --- the Algorithm registry: every objective is a pluggable object ----
    print("registered algorithms:", available())
    advantages = torch.randn((B, T), generator=g, device=device)
    mask = torch.ones((B, T), device=device)
    batch = LossInputs(advantages=advantages, mask=mask,
                       behav_logp=behav_logp, versions=versions,
                       current_version=current_version)

    algo = get_algorithm("a3po")  # reduced-kernel A-3PO (alias: "loglinear")
    loss, metrics = algo.loss(logp, batch, rl)
    print(f"A-3PO loss: {float(loss):+.4f}  "
          f"iw in [{float(metrics['iw_min']):.3f}, "
          f"{float(metrics['iw_max']):.3f}]  "
          f"clipped: {int(metrics['clipped_tokens'])} tokens  "
          f"kl: {float(metrics['kl']):+.4f}")

    # swapping the algorithm is one registry lookup — asympo needs no
    # behavior logps at all (see `launch/train.py --algo list` for flags)
    asympo = get_algorithm("asympo")
    loss2, _ = asympo.loss(
        logp, LossInputs(advantages=advantages, mask=mask), rl)
    print(f"ASymPO loss (behavior-free): {float(loss2):+.4f}")


if __name__ == "__main__":
    main()
