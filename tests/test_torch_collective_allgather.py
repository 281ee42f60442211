"""ZeRO-3's compressed bucket all-gather (``compressed_all_gather`` of
``dietgpu_fork_torch/parallel/collectives.py``) over gloo at worlds of 2 and
4, on small bf16 pieces, one of which does not compress and rides raw:
outputs against the pieces, the received archive rows against the plain
reference of the benchmark (``bench_torch/reference.py``), the parallel
layer's spans in a traced call, the all-reduce and the permute that share
its encode and decode, the readers of the parallel layer's metrics, and the
benchmark's entries for the cell ``collective_bf16.allgather4``."""

from __future__ import annotations

import collections
import json
import os
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bench_torch import harness, reference, tracing
from dietgpu_fork_torch.parallel import collectives as co
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
PIECES = {"even": 3000, "odd": 2049}  # bf16 floats a piece
RAW_RANK = 1  # its pieces are random bits: they ride the wire raw
ADDEND = 64  # fp32 floats of an all-reduce addend
JOIN_SECONDS = 120
PARALLEL_SPANS = ("parallel:compressed_all_gather", "stage:parallel.encode",
                  "stage:parallel.sizes", "stage:parallel.transfer",
                  "stage:parallel.decode", "stage:parallel.output")
CELL = "collective_bf16.allgather4"


def piece(rank: int, n: int) -> torch.Tensor:
    """Rank's (1, n) bf16 piece: N(0,1), or random bits on RAW_RANK."""
    g = torch.Generator().manual_seed(1000 * rank + n)
    if rank == RAW_RANK:
        return torch.randint(-(1 << 15), 1 << 15, (1, n), generator=g,
                             dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return torch.randn(1, n, generator=g).to(torch.bfloat16)


def addend(rank: int) -> torch.Tensor:
    """Small whole numbers in fp32: every order of their sum is exact."""
    g = torch.Generator().manual_seed(77 + rank)
    return torch.randint(-100, 100, (1, ADDEND), generator=g).to(torch.float32)


def rank_results(rank: int, world: int) -> dict:
    res = {}
    wires = []
    exchange = co._gather_chunked

    def keep(*args, **kwargs):
        wires.append(exchange(*args, **kwargs))
        return wires[-1]

    co._gather_chunked = keep
    try:
        for name, n in PIECES.items():
            wires.clear()
            out, ok, wire = co.compressed_all_gather(piece(rank, n), return_stats=True)
            rows, metas, words = wires[0]
            res[name] = {"out": out, "ok": ok, "wire": wire, "rows": rows,
                         "metas": metas, "words": words}
    finally:
        co._gather_chunked = exchange
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        co.compressed_all_gather(piece(rank, PIECES["even"]))
    res["spans"] = collections.Counter(
        e.name for e in prof.events() if e.name.startswith(("parallel:", "stage:parallel.",
                                                            "sync:parallel.")))
    res["all_reduce"] = co.compressed_all_reduce(addend(rank))
    ring = [(i, (i + 1) % world) for i in range(world)]
    for kind, perm in (("ring", ring), ("partial", ring[:-1])):
        res[kind] = co.compressed_ppermute(piece(rank, PIECES["even"]), perm)
    return res


def _rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        res = rank_results(rank, world)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's ranks' results, the worlds run side by side."""
    started = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        started[world] = (tmp, mp.start_processes(
            _rank_main, args=(world, str(tmp / "store"), str(tmp)), nprocs=world,
            join=False, start_method="spawn"))
    deadline = time.monotonic() + JOIN_SECONDS
    out = {}
    for world, (tmp, ctx) in started.items():
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"a world of {world} took over {JOIN_SECONDS} s")
        out[world] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(PIECES))
def test_gather_returns_every_piece_bit_for_bit(worlds, world, name):
    want = torch.cat([piece(q, PIECES[name]) for q in range(world)])
    for r, res in enumerate(worlds[world]):
        got = res[name]
        assert got["ok"].tolist() == [True] * world
        assert torch.equal(_bits(got["out"]), _bits(want))
        # one piece rode raw, the others as archives
        assert got["metas"][:, 0].tolist() == [
            co._FLAG_RAW if q == RAW_RANK else co._FLAG_COMP for q in range(world)]
        assert int(got["wire"][0]) == got["words"] == got["rows"].shape[1]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(PIECES))
def test_received_archives_read_back_by_the_plain_reference(worlds, world, name):
    n = PIECES[name]
    for res in worlds[world]:
        rows, metas = res[name]["rows"], res[name]["metas"]
        arch = [q for q in range(world) if int(metas[q, 0]) == co._FLAG_COMP]
        faults = reference.Faults()
        bad, ends = reference.check_float_archives(
            rows.contiguous().view(torch.uint8), [q * rows.shape[1] for q in arch],
            [piece(q, n)[0] for q in arch], 10, False, faults)
        assert bad == 0 and faults.total == 0
        assert [e - q * rows.shape[1] for q, e in zip(arch, ends)] == [
            int(metas[q, 1]) for q in arch]
        raw = rows[RAW_RANK].view(torch.bfloat16)[:n]
        assert torch.equal(_bits(raw), _bits(piece(RAW_RANK, n)[0]))


@pytest.mark.parametrize("world", WORLDS)
def test_a_traced_gather_holds_the_parallel_spans_and_one_sizes_read(worlds, world):
    for res in worlds[world]:
        spans = res["spans"]
        assert all(spans[s] == 1 for s in PARALLEL_SPANS), spans
        assert spans["sync:parallel.sizes"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_and_ppermute_agree_with_plain_sums_and_permutations(worlds, world):
    total = sum(addend(q) for q in range(world))
    src = {d: s for s, d in [(i, (i + 1) % world) for i in range(world)]}
    for r, res in enumerate(worlds[world]):
        out, ok = res["all_reduce"]
        assert bool(ok.all()) and torch.equal(out, total)
        out, ok = res["ring"]
        assert bool(ok.all())
        assert torch.equal(_bits(out), _bits(piece(src[r], PIECES["even"])))
        out, ok = res["partial"]
        if r == 0:  # the ring without its last pair: nothing comes here
            assert not bool(ok.any()) and not bool(_bits(out).any())
        else:
            assert bool(ok.all())
            assert torch.equal(_bits(out), _bits(piece(src[r], PIECES["even"])))


# -- the readers of the parallel layer, on a hand-made trace ----------------


def _x(cat, name, ts, end, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid,
         "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _call(at, corr, parallel=True):
    """One all-gather call at ``at``: the encode (a model launch, the
    models' sync, a launch of the meta), the sizes (an NCCL launch and the
    read under its sync), the transfer (an NCCL launch), the decode (a
    kernel wrapper's launch), the output."""
    ua = lambda name, a, b: _x("user_annotation", name, at + a, at + b)  # noqa: E731
    rt = lambda name, a, b, c=None: _x("cuda_runtime", name, at + a, at + b,  # noqa: E731
                                       None if c is None else corr + c)
    dev = lambda name, a, b, c: _x("kernel", name, at + a, at + b, corr + c, tid=7)  # noqa: E731
    events = [
        ua("bench.allgather", 0, 100),
        ua("stage:parallel.encode", 2, 40),
        ua("model:float_codec.float_compress_core", 5, 35),
        rt("cudaLaunchKernel", 6, 7, 0),
        ua("sync:float_codec.count_check", 10, 14),
        rt("cudaStreamSynchronize", 11, 13),
        rt("cudaLaunchKernel", 36, 37, 1),
        ua("stage:parallel.sizes", 41, 50),
        rt("cudaLaunchKernel", 42, 43, 2),
        ua("sync:parallel.sizes", 44, 49),
        rt("cudaMemcpyAsync", 45, 48, 3),
        ua("stage:parallel.transfer", 51, 55),
        rt("cudaLaunchKernel", 52, 53, 4),
        ua("stage:parallel.decode", 56, 90),
        ua("model:float_codec.float_decompress_core", 57, 85),
        ua("kernel:decode_join16_blocks", 60, 70),
        rt("cudaLaunchKernel", 61, 62, 5),
        ua("stage:parallel.output", 91, 94),
        rt("cudaStreamSynchronize", 96, 99),
        dev("(anonymous namespace)::split16_hist_kernel", 8, 20, 0),
        dev("void at::native::vectorized_elementwise_kernel", 37, 38, 1),
        dev("ncclDevKernel_AllGather_RING_LL", 43, 45, 2),
        dev("ncclDevKernel_AllGather_RING_LL", 53, 58, 4),
        dev("(anonymous namespace)::decode_kernel<1>", 63, 75, 5),
    ]
    if parallel:
        events.append(ua("parallel:compressed_all_gather", 1, 95))
    return events


@pytest.mark.parametrize("parallel", [True, False])
def test_the_parallel_readers_on_a_hand_made_trace(parallel):
    t = tracing.TracedSlice(_call(10, 1, parallel) + _call(120, 11, parallel))
    host_ms = harness._reader("parallel_host_ms.allgather")(t)
    launches = harness._reader("parallel_launches_per_roundtrip")(t)
    if not parallel:  # a program that records no parallel: span reads nothing
        assert host_ms is None and launches is None
        return
    # the span's 94 us less the models' 5-35 and 57-85 (the kernel and the
    # count check inside them) and the sizes read's 44-49
    assert host_ms == pytest.approx((94 - 30 - 28 - 5) / 1e3)
    # the meta's launch, the two NCCL launches and the read's copy; the
    # models' and the kernel wrapper's launches are theirs
    assert launches == 4


# -- the benchmark's entries for the cell -----------------------------------


def test_the_benchmark_holds_the_cell_on_four_chips_with_its_readers():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells[CELL]["chips"] == 4 and cells[CELL]["traffic"] == "allgather4"
    config = {c["name"]: c for c in spec["configs"]}[cells[CELL]["config"]]
    assert config["reduced"] == [] and (harness.ROOT / config["file"]).is_file()
    fours = sum(w["chips"] == 4 for w in spec["workloads"])
    assert fours <= max(1, len(spec["workloads"]) // 4)
    listing = [m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [])]
    assert {"parallel_host_ms.allgather", "parallel_launches_per_roundtrip",
            "nccl_device_ms.allgather", "codec_device_ms.allgather",
            "host_syncs_per_roundtrip"} <= set(listing)
    assert all((harness.HERE / "metrics" / f"{m}.py").is_file() for m in listing)
    e2e = {m["name"] for m in spec["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert e2e == {"roundtrip_p95_ms", "codec_mem_mib", "setup_s"}
