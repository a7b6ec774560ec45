"""The roofline terms and collective statistics of a step
(``repro.distributed.hlo_analysis``).

The reference parses per-device HLO for collective bytes and prices them
at TPU v5e rates. The port's collectives come from the cost census
(``op_cost.Census``, a ``CommDebugMode``): counts from ``CommDebugMode``,
bytes from each collective's output shape. The rates are the H100 SXM data
sheet's, the same ones ``chip_smoke.py`` uses for its kernel bounds:

* 989e12 flop/s dense bf16 on the tensor cores;
* 3.35e12 B/s HBM3;
* links, per GPU and direction: NVLink 450e9 B/s for a mesh axis whose
  ranks stay inside one 8-GPU node; the network, 50e9 B/s (400 Gb/s NDR
  InfiniBand, one NIC a GPU), for an axis that crosses nodes. On the
  production meshes every axis crosses nodes: the innermost "model" axis is
  16 wide.

These are a data-sheet roofline over a fake mesh, not measurements.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS_BF16 = 989e12    # FLOP/s per GPU, dense bf16
HBM_BW = 3.35e12            # B/s per GPU
NVLINK_BW = 450e9           # B/s per GPU and direction, inside a node
NETWORK_BW = 50e9           # B/s per GPU, 400 Gb/s NDR across nodes
GPUS_PER_NODE = 8


def axis_bandwidth(mesh_shape: Dict[str, int], axis: str) -> float:
    """The link rate a collective over ``axis`` sees: NVLink when the
    axis's ranks fit in one node (ranks laid out row-major over the mesh,
    8 a node), the network otherwise (and for an unknown axis)."""
    if axis not in mesh_shape:
        return NETWORK_BW
    names = list(mesh_shape)
    stride = 1
    for a in names[names.index(axis) + 1:]:
        stride *= mesh_shape[a]
    span = stride * mesh_shape[axis]
    return NVLINK_BW if span <= GPUS_PER_NODE else NETWORK_BW


def collective_seconds(mesh_shape: Dict[str, int],
                       bytes_by_axis: Dict[str, float]) -> float:
    return sum(b / axis_bandwidth(mesh_shape, a)
               for a, b in bytes_by_axis.items())


def collective_stats(census) -> Tuple[float, Dict[str, Dict[str, float]]]:
    """(total bytes, {kind: {count, bytes}}) of a census's collectives:
    the counts are ``CommDebugMode``'s, the bytes the outputs'."""
    from repro_torch.distributed.op_cost import collective_counts
    counts = collective_counts(census)
    per = census.cost.collective_ops
    out = {k: {"count": int(counts.get(k, 0)),
               "bytes": float(per.get(k, {}).get("bytes", 0.0))}
           for k in sorted(set(counts) | set(per))}
    return float(census.cost.collective_bytes), out


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float,
                   collective_s: float = None) -> Dict[str, float]:
    """Three roofline terms in seconds per GPU. ``collective_s`` may be
    given when the bytes ran over links of different rates
    (``collective_seconds``); else they are priced at the network's."""
    compute = flops_per_device / PEAK_FLOPS_BF16
    memory = bytes_per_device / HBM_BW
    collective = (collective_bytes_per_device / NETWORK_BW
                  if collective_s is None else collective_s)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant  # type: ignore[assignment]
    return terms
