"""The control of ``correct``, and the faults it must catch.

The control is the reference put in the program's place one precision
below the configuration's (``control_dtype``: fp8 for bf16, fp32 for fp64):
each batch goes through that type and back before the program compresses
it, as a codec that rounds would. Its runs have to come out not correct.
The faults break the timed path in the ways a codec can go wrong: a
decompress that hands back its previous answer (state unchanged), half of
a batch left out, one bit of an archive flipped where compress produced
it, one bit of an output flipped where decompress produced it. A
collective cell (``ranks.py``) has the same control and faults on its
all-gather (``GATHER_FAULTS``), and one more: the exchange between the
ranks left out.

    python3 bench_torch/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--world <w>]

runs, for each seed, a sound run and a control run of the cell at its own
sizes (a collective cell over ``--world`` ranks on NCCL, by default its
chips), and prints the numbers compared of each. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch.distributed as dist  # noqa: E402

from bench_torch import harness, ranks, traffic  # noqa: E402


class _Through:
    """The codec as it is; subclasses change one call."""

    def __init__(self, codec, config: dict):
        self.codec, self.config = codec, config

    def compress(self, batch: List[torch.Tensor]):
        return self.codec.compress(batch)

    def decompress(self, comp, caps):
        return self.codec.decompress(comp, caps)


class Lowered(_Through):
    """The control: every float rounded through control_dtype first."""

    def compress(self, batch):
        low = traffic.dtype_of(self.config["control_dtype"])
        return self.codec.compress([t.to(low).to(t.dtype) for t in batch])


class Stale(_Through):
    """Decompress hands back the previous call's outputs."""

    prev = None

    def decompress(self, comp, caps):
        outs, ok = self.codec.decompress(comp, caps)
        prev = self.prev if self.prev is not None else [torch.zeros_like(o) for o in outs]
        self.prev = outs
        return prev, ok


class HalfBatch(_Through):
    """Compress leaves out the second half of the batch (of the floats,
    for a batch of one): it codes zeros in their place."""

    def compress(self, batch):
        if len(batch) > 1:
            h = len(batch) // 2
            batch = batch[:h] + [torch.zeros_like(t) for t in batch[h:]]
        else:
            t = batch[0].clone()
            t[t.numel() // 2:] = 0
            batch = [t]
        return self.codec.compress(batch)


class FlipArchive(_Through):
    """One bit flipped in the middle of member 0's archive."""

    def compress(self, batch):
        comp, sizes = self.codec.compress(batch)
        comp[0, int(sizes[0]) // 2] ^= 1
        return comp, sizes


class FlipOutput(_Through):
    """One bit flipped in the first float of member 0's output."""

    def decompress(self, comp, caps):
        outs, ok = self.codec.decompress(comp, caps)
        outs[0].view(torch.uint8)[0] ^= 1
        return outs, ok


FAULTS = {"stale": Stale, "half_batch": HalfBatch, "flip_archive": FlipArchive,
          "flip_output": FlipOutput}


class LoweredGather(ranks.Gather):
    """The control of a collective cell: each bucket rounded through
    control_dtype before the all-gather."""

    def gather(self, bucket):
        low = traffic.dtype_of(self.config["control_dtype"])
        return super().gather(bucket.to(low).to(bucket.dtype))


class StaleGather(ranks.Gather):
    """The all-gather hands back the previous call's output."""

    prev = None

    def gather(self, bucket):
        out, ok, wire = super().gather(bucket)
        prev = self.prev if self.prev is not None else torch.zeros_like(out)
        self.prev = out
        return prev, ok, wire


class HalfGather(ranks.Gather):
    """The second half of the bucket left out: zeros are gathered there."""

    def gather(self, bucket):
        t = bucket.clone()
        t[t.numel() // 2:] = 0
        return super().gather(t)


class NoExchange(ranks.Gather):
    """The exchange between the ranks left out: every received row, and its
    size header, is this rank's own."""

    def received(self, wire):
        rows, metas, words = wire
        r = dist.get_rank()
        return rows[r].expand_as(rows).clone(), metas[r].expand_as(metas).clone(), words


class FlipWire(ranks.Gather):
    """One bit flipped in the middle of rank 0's payload row as it arrives."""

    def received(self, wire):
        rows, metas, words = wire
        rows[0, int(metas[0, 1]) // 2] ^= 1
        return rows, metas, words


class FlipGathered(ranks.Gather):
    """One bit flipped in the first float of the gathered output."""

    def gather(self, bucket):
        out, ok, wire = super().gather(bucket)
        out.view(torch.uint8)[0] ^= 1
        return out, ok, wire


GATHER_FAULTS = {"stale": StaleGather, "half_batch": HalfGather, "no_exchange": NoExchange,
                 "flip_archive": FlipWire, "flip_output": FlipGathered}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--world", type=int)
    args = ap.parse_args()
    cell, config = harness.load_cell(args.workload)[:2]
    world = args.world or cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"fewer than {world} CUDA devices", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    collective = "collective" in config
    for seed in args.seeds:
        for name, wrap in (("sound", None), ("control", LoweredGather if collective else Lowered)):
            if collective:
                out = ranks.run(args.workload, seed, args.seconds, False, world=world,
                                backend="nccl", device_type="cuda",
                                t_start=time.perf_counter(), codec=wrap)
            else:
                out = harness.run(args.workload, seed, args.seconds, False, device=dev,
                                  t_start=time.perf_counter(), wrap=wrap, log=log)
            print(json.dumps({"workload": args.workload, "seed": seed, "run": name,
                              "correct": out["correct"], "checks": out["checks"]}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
