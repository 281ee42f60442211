"""The port's side of ``tests/test_torch_parallel.py``: the inputs of every
case, made from a seed with numpy, and the rank processes that run the
port's parallel layer (``dietgpu_fork_torch.parallel``) on gloo over them.

A world of one runs in the calling process; larger worlds run in processes
of ``torch.multiprocessing``'s spawn context, which meet through a file
store and write each rank's results to ``<out>/rank<r>.npz``. Neither this
module nor the rank processes import jax or the JAX package. The tests here
need no JAX: argument checks in a world of one.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import (
    bytes_from_numpy,
    floats_from_words,
    rows_from_numpy,
)
from dietgpu_fork_torch.parallel import collectives as co
from dietgpu_fork_torch.parallel import sharded as sh
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WORLDS = (1, 2, 4)
FLOAT_N = 5000  # floats a member of the sharded float codec
ANS_S = 8192  # bytes a member of the sharded raw ANS
# name: (word dtype, torch dtype, chunk_words, data), (W, 2048) a case
GATHERS = {
    "bf16": (np.uint16, torch.bfloat16, None, "normal"),
    "fp16": (np.uint16, torch.float16, None, "normal"),
    "fp32": (np.uint32, torch.float32, None, "normal"),
    "bf16-chunk128": (np.uint16, torch.bfloat16, 128, "normal"),
    "fp32-raw": (np.uint32, torch.float32, None, "bits"),
}
# name: (word dtype, torch dtype, shape of an addend), reduce-scatter
REDUCE_SCATTERS = {"fp32": (np.uint32, torch.float32, (4096,)),
                   "bf16": (np.uint16, torch.bfloat16, (2048,))}
ALL_REDUCE_SHAPE = (1, 1024)  # fp32
PPERMUTE_N = 512  # bf16
PERMS = ("ring", "identity", "partial")
FP64_N = 4096
JOIN_SECONDS = 600  # the longest a spawned world may take
ODD_N = 2047  # bf16 floats a piece: an odd count, checked against the input


def perm_of(kind: str, world: int):
    """The pairs of a ppermute case: the ring, the identity, or the ring
    without its last pair, so that rank 0 receives nothing (no pair at all
    in a world of one)."""
    ring = [(i, (i + 1) % world) for i in range(world)]
    if kind == "ring":
        return ring
    if kind == "identity":
        return [(i, i) for i in range(world)]
    return ring[:-1]


def float_words(rng, word_dtype, shape, data="normal"):
    """N(0,1) words of a float type (bf16 is fp32's high half), or uniform
    random bits."""
    if data == "bits":
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(word_dtype)
    x = rng.normal(0, 1, shape)
    if word_dtype == np.uint16:  # bf16; fp16 by its own name below
        return (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    if word_dtype == np.uint32:
        return x.astype(np.float32).view(np.uint32)
    return x.astype(np.float64).view(np.uint64)


def _words(rng, wdt, tdt, shape, data="normal"):
    if tdt == torch.float16 and data == "normal":
        return rng.normal(0, 1, shape).astype(np.float16).view(np.uint16)
    return float_words(rng, wdt, shape, data)


def exponential_bytes(rng, n, lam):
    """Exponential-sharpness bytes, the reference ANSTest.cu's law."""
    return np.minimum(rng.exponential(scale=256.0 / lam, size=n), 255).astype(
        np.uint8)


def world_inputs(world: int) -> dict:
    """Every case's global input for a world of ``world`` ranks, seeded by
    the world."""
    rng = np.random.default_rng(1000 + world)
    B = 2 * world
    inp = {
        "float/bf16": _words(rng, np.uint16, torch.bfloat16, (B, FLOAT_N)),
        "float/fp32": _words(rng, np.uint32, torch.float32, (B, FLOAT_N)),
        "ans": rng.integers(0, 64, (B, ANS_S), dtype=np.uint8),
        "table": exponential_bytes(rng, B * ANS_S, 2.0).reshape(B, ANS_S),
        "ppermute": _words(rng, np.uint16, torch.bfloat16, (world, PPERMUTE_N)),
        "all_reduce": _words(rng, np.uint32, torch.float32,
                             (world,) + ALL_REDUCE_SHAPE),
        "fp64/gather": _words(rng, np.uint64, torch.float64, (world, FP64_N)),
        "fp64/rs": _words(rng, np.uint64, torch.float64, (world, FP64_N)),
    }
    for name, (wdt, tdt, _, data) in GATHERS.items():
        inp[f"gather/{name}"] = _words(rng, wdt, tdt, (world, 2048), data)
    inp["gather/bf16-odd"] = _words(rng, np.uint16, torch.bfloat16, (world, ODD_N))
    for name, (wdt, tdt, shape) in REDUCE_SCATTERS.items():
        inp[f"rs/{name}"] = _words(rng, wdt, tdt, (world,) + shape)
    return inp


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.numpy()


def rank_results(rank: int, world: int) -> dict:
    """Every case through the port on this rank of an initialised group, on
    the CPU: {case/field: numpy array}."""
    inp = world_inputs(world)
    g = sh.data_mesh()
    cpu = torch.device("cpu")
    out = {}

    def piece(name, dtype):
        return floats_from_words(inp[name][rank: rank + 1], dtype)

    for name, ft in (("float/bf16", FloatType.BFLOAT16),
                     ("float/fp32", FloatType.FLOAT32)):
        rows = rows_from_numpy(inp[name].view(np.uint32))
        xs = sh.shard_batch(g, rows, device=cpu)
        ss = sh.shard_batch(g, torch.full((2 * world,), FLOAT_N, dtype=torch.int32),
                            device=cpu)
        comp, cb = sh.float_compress_sharded(g, xs, ss, ft)
        words, ok, n, _, _ = sh.float_decompress_sharded(g, comp, FLOAT_N, ft)
        out.update({f"{name}/comp": _np(comp), f"{name}/comp_bytes": _np(cb),
                    f"{name}/words": _np(words), f"{name}/ok": _np(ok),
                    f"{name}/n": _np(n),
                    f"{name}/sizes": _np(sh.global_compressed_sizes(cb, g))})

    sizes = torch.full((2 * world,), ANS_S, dtype=torch.int32)
    for name, enc in (("ans", sh.ans_encode_sharded),
                      ("table", sh.ans_encode_shared_table)):
        xs = sh.shard_batch(g, bytes_from_numpy(inp[name]), device=cpu)
        comp, cb = enc(g, xs, sh.shard_batch(g, sizes, device=cpu))
        dec, ok, n, _ = sh.ans_decode_sharded(g, comp, ANS_S)
        out.update({f"{name}/comp": _np(comp), f"{name}/comp_bytes": _np(cb),
                    f"{name}/out": _np(dec), f"{name}/ok": _np(ok)})

    def keep(name, res):
        o, ok, wire = res
        out.update({f"{name}/out": _np(o), f"{name}/ok": _np(ok),
                    f"{name}/wire": _np(wire)})

    for name, (_, tdt, cw, _) in GATHERS.items():
        keep(f"gather/{name}", co.compressed_all_gather(
            piece(f"gather/{name}", tdt), g, chunk_words=cw, return_stats=True))
    keep("gather/bf16-odd", co.compressed_all_gather(
        piece("gather/bf16-odd", torch.bfloat16), g, return_stats=True))
    for name, (_, tdt, _) in REDUCE_SCATTERS.items():
        keep(f"rs/{name}", co.compressed_reduce_scatter(
            piece(f"rs/{name}", tdt), g, return_stats=True))
    keep("all_reduce", co.compressed_all_reduce(
        piece("all_reduce", torch.float32), g, return_stats=True))
    for kind in PERMS:
        keep(f"ppermute/{kind}", co.compressed_ppermute(
            piece("ppermute", torch.bfloat16), perm_of(kind, world), g,
            return_stats=True))
    keep("fp64/gather", co.compressed_all_gather(
        piece("fp64/gather", torch.float64), g, return_stats=True))
    keep("fp64/rs", co.compressed_reduce_scatter(
        piece("fp64/rs", torch.float64), g, return_stats=True))
    keep("fp64/ppermute", co.compressed_ppermute(
        piece("fp64/gather", torch.float64), perm_of("ring", world), g,
        return_stats=True))
    return out


def _rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        res = rank_results(rank, world)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def start_world(world: int, tmp: Path):
    """Start the ranks of a world in spawned processes; returns the
    process context (join it with ``finish_world``)."""
    tmp.mkdir(parents=True, exist_ok=True)
    return mp.start_processes(_rank_main, args=(world, str(tmp / "store"), str(tmp)),
                              nprocs=world, join=False, start_method="spawn")


def finish_world(ctx, world: int, tmp: Path):
    """Join a started world (a world of one runs here and now); returns
    each rank's results in rank order."""
    if ctx is None:
        tmp.mkdir(parents=True, exist_ok=True)
        threads = torch.get_num_threads()
        try:
            _rank_main(0, world, str(tmp / "store"), str(tmp))
        finally:
            torch.set_num_threads(threads)
    else:
        deadline = time.monotonic() + JOIN_SECONDS
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"a world of {world} took over "
                                   f"{JOIN_SECONDS} s")
    res = []
    for r in range(world):
        with np.load(tmp / f"rank{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


# -- a world of one: argument checks --------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        yield sh.data_mesh()
    finally:
        dist.destroy_process_group()


def test_shard_batch_takes_the_rank_block(world_of_one):
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(sh.shard_batch(world_of_one, x, device="cpu"), x)
    sub = sh.data_mesh([0])
    assert torch.equal(sh.shard_batch(sub, x, device="cpu"), x)


@pytest.mark.parametrize("perm", [[(0, 0), (0, 0)], [(0, 1)], [(1, 0)]])
def test_ppermute_refuses_a_bad_perm(world_of_one, perm):
    x = torch.zeros((1, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="perm"):
        co.compressed_ppermute(x, perm, world_of_one)


@pytest.mark.parametrize("shape", [(2, 8), (8,)])
def test_reductions_refuse_a_piece_of_more_than_one_addend(world_of_one, shape):
    x = torch.zeros(shape, dtype=torch.float32)
    with pytest.raises(ValueError, match="piece"):
        co.compressed_reduce_scatter(x, world_of_one)
    with pytest.raises(ValueError, match="piece"):
        co.compressed_all_reduce(x, world_of_one)


def test_unsupported_dtype_is_refused(world_of_one):
    with pytest.raises(ValueError, match="unsupported dtype"):
        co.compressed_all_gather(torch.zeros((1, 8), dtype=torch.int32),
                                 world_of_one)


def test_shared_table_refuses_a_total_past_int32(world_of_one, monkeypatch):
    x = torch.zeros((2, 64), dtype=torch.uint8)
    sizes = torch.full((2,), 64, dtype=torch.int32)
    monkeypatch.setattr(sh, "_MAX_TOTAL", 127)
    with pytest.raises(ValueError, match="int32"):
        sh.ans_encode_shared_table(world_of_one, x, sizes)
    monkeypatch.setattr(sh, "_MAX_TOTAL", 128)
    comp, cb = sh.ans_encode_shared_table(world_of_one, x, sizes)
    out, ok, _, _ = sh.ans_decode_sharded(world_of_one, comp, 64)
    assert bool(ok.all()) and torch.equal(out, x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [1, 7, 2049])
def test_gather_of_an_odd_16bit_piece_comes_back_whole(world_of_one, dtype, n):
    """Each gathered piece is converted back on its own, so the pad half of
    a piece with an odd count of floats never shifts the next piece."""
    x = torch.randn((1, n), generator=torch.Generator().manual_seed(n)).to(dtype)
    got, ok = co.compressed_all_gather(x, world_of_one)
    assert bool(ok.all())
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))
