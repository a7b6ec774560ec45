"""Small configurations and traffic for the CPU tests: the cells' own
files with their sizes cut down, so that a test run holds them."""
import copy
import time

import torch

from perfbench import harness

DENSE = {"name": "tiny-dense", "arch": "dense", "arch_type": "dense",
         "num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256, "qkv_bias": True,
         "tie_embeddings": True, "rope_theta": 10000.0, "norm_eps": 1e-05,
         "dtype": "bfloat16", "remat": True,
         "weight_scale": {"factor": 8.0,
                          "leaves": ["blocks/attn/w*", "blocks/ffn/*"]}}
MODELS = {"dense": DENSE}


def model(arch: str, dtype: str = "bfloat16") -> dict:
    return dict(copy.deepcopy(MODELS[arch]), dtype=dtype)


def traffic(name: str = "train.a3po", **kw) -> dict:
    """A cell's traffic file at 2 prompts x 4, rows of 64 tokens."""
    tr = harness.traffic_file(name)
    tr.update(prompts=2, group=4, row_len=64,
              prompt_len={"dist": "uniform", "low": 8, "high": 16},
              response_len={"dist": "lognormal", "median": 16,
                            "sigma": 0.8})
    tr.update(kw)
    return tr


def run(m: dict, tr: dict, seed: int, *, limits=None, seconds=0.0,
        trace=False) -> harness.Run:
    return harness.Run(cell="tiny", model=m, traffic=tr,
                       limits=limits or {}, seed=seed, seconds=seconds,
                       trace_on=trace, device=torch.device("cpu"),
                       t_start=time.perf_counter())
