"""The one generator of the benchmark's inputs: a pool of batches made on
the device from the seed, as a configuration (what the floats are) and a
traffic mix (how many, in what batches) describe them.

Configuration keys read here: ``dtype`` (a torch dtype name), ``mean``,
``std`` (the normal distribution the floats are drawn from) and
``zero_fraction`` (the share of floats set to exact zeros, each float on
its own). Traffic keys: ``members`` and ``floats`` (a batch of that many
tensors of that many floats each), ``pool_min_bytes`` and
``pool_min_batches`` (the pool holds at least that many bytes and
batches, so that every call finds its input cold in the L2 cache).
Every seed gets the same sizes; the seed picks the values.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import torch


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def batch_bytes(config: dict, traffic: dict) -> int:
    item = torch.empty((), dtype=dtype_of(config["dtype"])).element_size()
    return traffic["members"] * traffic["floats"] * item


def pool_batches(config: dict, traffic: dict) -> int:
    per = batch_bytes(config, traffic)
    return max(traffic["pool_min_batches"], -(-traffic["pool_min_bytes"] // per))


def make_pool(config: dict, traffic: dict, seed: int,
              device: torch.device) -> List[List[torch.Tensor]]:
    """The pool: batches of ``members`` 1-D tensors, each a view of one
    tensor drawn in one call on the device."""
    dt = dtype_of(config["dtype"])
    P, M, N = pool_batches(config, traffic), traffic["members"], traffic["floats"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn(P * M * N, generator=g, device=device, dtype=dt)
    x.mul_(config["std"]).add_(config["mean"])
    if config["zero_fraction"]:
        zero = torch.rand(P * M * N, generator=g, device=device) < config["zero_fraction"]
        x.masked_fill_(zero, 0)
        del zero
    x = x.view(P, M, N)
    return [list(x[p]) for p in range(P)]
