"""One run of a collective cell: one process a rank, the ranks in lockstep.

A cell whose configuration names a ``collective`` runs here. ``run``
starts one process a rank with ``torch.multiprocessing``'s spawn context;
rank r runs on device r of its type with one torch thread and meets the
others through a file store in a temporary directory. Rank 0 writes the
result, which ``run`` returns.

Each rank's bucket is one member of the traffic mix, taken in turn from a
pool made on its device from the seed and the rank (``rank_seed``), so
that any rank can make any other rank's bucket again. The loop is closed,
one call at a time. Between calls, outside the timed interval, the ranks
agree on rank 0's word whether the window is still open and, if it is,
on the instant at which every rank starts the next call: ``START_LEAD_S``
after the last of them got there, on the monotonic clock that the
processes of one host share. So the window ends at the same call on every
rank, and every rank times the call from the same point: from that
instant to the return of its synchronise after the call. A call's
time is the slowest rank's, gathered after the window. A rank that raises
ends the run: its peers would wait for it inside the exchange. A sample
of the calls, drawn
from the seed and the same on every rank, keeps its outputs and the
payload rows that crossed the wire, which are checked once the window has
closed (``reference.py``).
"""

from __future__ import annotations

import datetime
import json
import math
import os
import random
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import harness, reference, stats, traffic, tracing

FLAG_COMP, FLAG_RAW = 1, 2  # the collective's payload flags: archive, raw words
# how long after the last rank reaches the word between calls every rank
# starts the next one: more than the word takes to reach every rank
START_LEAD_S = 1e-3


def now() -> float:
    """Seconds on the host's monotonic clock, the same in every process."""
    return time.clock_gettime(time.CLOCK_MONOTONIC)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's pool: distinct for each rank below 64."""
    return (seed << 6) + rank


class Gather:
    """The timed path: the port's compressed all-gather of one bucket
    (``parallel/collectives.py``). While open it keeps the payload rows,
    their size headers and the words moved, as the exchange inside the
    timed call returned them, in ``wire``."""

    def __init__(self, config: dict):
        from dietgpu_fork_torch.parallel import collectives
        self.config = config
        self.co = collectives
        self.wire: Optional[tuple] = None
        exchange = tracing._lookup(collectives, "_gather_chunked")

        def keep(*args, **kwargs):
            self.wire = self.received(exchange(*args, **kwargs))
            return self.wire

        self._patches = tracing.Patches()
        self._patches.set(collectives, "_gather_chunked", keep)

    def received(self, wire: tuple) -> tuple:
        """What the exchange returned: (rows, size headers, words moved)."""
        return wire

    def gather(self, bucket: torch.Tensor):
        """(every rank's bucket in rank order, ok flags, wire words)."""
        return self.co.compressed_all_gather(
            bucket, None, prob_bits=self.config["prob_bits"], return_stats=True)

    def close(self) -> None:
        self._patches.__exit__()


COLLECTIVES = {"all_gather": Gather}


class RankRun:
    """The state of one rank's run: its pool, the collective and what was
    read."""

    def __init__(self, config: dict, mix: dict, seed: int, rank: int, world: int,
                 device: torch.device, codec=None):
        if mix["members"] != 1:
            raise ValueError("a collective's bucket is one member")
        self.config, self.mix, self.seed = config, mix, seed
        self.rank, self.world, self.device = rank, world, device
        self.buckets = [b[0] for b in traffic.make_pool(config, mix, rank_seed(seed, rank), device)]
        self.n = mix["floats"]
        self.bucket_bytes = traffic.batch_bytes(config, mix)
        self.codec = (codec or COLLECTIVES[config["collective"]])(config)
        self.next = 0
        self.rng = random.Random(seed)
        self.samples: List[tuple] = []
        self.seen = 0
        self.times: List[float] = []
        self.late: List[float] = []  # how long after a call's start this rank reached it
        self.oks: List[torch.Tensor] = []
        self.wires: List[torch.Tensor] = []
        self.attempted = 0
        self.mem_peak = 0
        self.codec_mem = 0

    def call(self, start: float, trace: bool = False) -> None:
        """One call, which every rank starts at ``start`` (``now()``); its
        time runs from then to the return of this rank's synchronise."""
        cuda = self.device.type == "cuda"
        b = self.next % len(self.buckets)
        self.next += 1
        span = torch.profiler.record_function if trace else (lambda name: nullcontext())
        if cuda:
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.attempted += 1
        self.codec.wire = None
        self.late.append(max(0.0, now() - start))
        while now() < start:
            pass
        with span("bench.allgather"):
            out, ok, wire = self.codec.gather(self.buckets[b])
            harness._sync(self.device)
        t1 = now()
        if cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.mem_peak = max(self.mem_peak, peak)
            self.codec_mem = max(self.codec_mem, peak - base)
        self.oks.append(ok)
        self.times.append(t1 - start)
        self.wires.append(wire)
        self._sample((b, out, ok, self.codec.wire))
        self.codec.wire = None

    # reservoir sampling from the seed: every rank draws the same calls
    _sample = harness.Run._sample

    def go_on(self, open_: bool) -> Optional[float]:
        """The word between calls: None where rank 0 says the window has
        closed, else the instant (``now()``) at which every rank starts the
        next call, ``START_LEAD_S`` after the last rank got here."""
        word = torch.tensor([float(open_ and self.rank == 0), now() + START_LEAD_S],
                            dtype=torch.float64, device=self.device)
        dist.all_reduce(word, op=dist.ReduceOp.MAX)
        go, start = word.tolist()
        return start if go else None

    def reset_window(self) -> None:
        self.samples, self.seen = [], 0
        self.times, self.wires, self.late = [], [], []
        self.codec_mem = 0

    def expected(self) -> List[List[torch.Tensor]]:
        """Every rank's pool of buckets, this rank's too, made again from
        the seed."""
        return [[b[0] for b in traffic.make_pool(self.config, self.mix, rank_seed(self.seed, q),
                                                 self.device)]
                for q in range(self.world)]

    def check(self) -> dict:
        """This rank's numbers compared (both exact, limit 0) and its
        readings. ``output_bad_floats``: floats of the gathered output
        whose bits differ from the buckets made again from the seed, a call
        whose ok flags are not all true counting all its floats.
        ``archive_bad_floats``: floats that the reference does not read back
        from the payload rows that crossed the wire in the call, a raw row
        (flag 2) compared raw, a sample whose rows break a rule of the
        format counting all its floats."""
        floats = self.world * self.n
        failed = (~torch.stack(self.oks).all(1)).tolist() if self.oks else []
        out_bad, arch_bad = sum(failed) * floats, 0
        faults = reference.Faults()
        pools = self.expected()
        comp_words = raw_words = 0
        for b, out, _, wire in self.samples:
            want = [pools[q][b] for q in range(self.world)]
            out_bad += harness._mismatch(list(out.reshape(self.world, -1)), want)
            before = faults.total
            try:
                bad, words = _check_rows(wire, want, self.config, faults)
            except (RuntimeError, ValueError, IndexError) as e:
                faults.counts["reference_error"] += 1
                print(f"rank {self.rank}: reference: {e}"[:300], file=sys.stderr, flush=True)
                bad, words = floats, 0
            arch_bad += floats if faults.total > before else bad
            comp_words += words
            raw_words += self.world * self.bucket_bytes // 4
        wire = torch.cat(self.wires).tolist() if self.wires else []
        return {"output_bad_floats": out_bad, "archive_bad_floats": arch_bad,
                "failed": failed, "faults": dict(faults.counts),
                "ratio": comp_words / raw_words if raw_words else math.nan,
                "wire_share": (sum(wire) / len(wire) / (self.bucket_bytes / 4)
                               if wire else math.nan)}


def _check_rows(wire: Optional[tuple], want: List[torch.Tensor], config: dict,
                faults: reference.Faults):
    """Floats that the reference does not read back from a call's payload
    rows (int32[world, pad_w]) under their size headers [flag, words];
    returns (those floats, the payload words)."""
    faults.check(wire is not None, "wire_rows_missing")
    if wire is None:
        return sum(t.numel() for t in want), 0
    rows, metas, _ = wire
    world, pad_w = rows.shape
    faults.check(world == len(want), "wire_rows")
    heads = metas[:, :2].tolist()
    raw_w = -(-want[0].numel() * want[0].element_size() // 4)
    bad, words, arch, members = 0, 0, [], []
    for q, ((flag, n_w), t) in enumerate(zip(heads, want)):
        words += n_w
        faults.check(0 < n_w <= min(pad_w, raw_w), "wire_payload_words")
        if flag == FLAG_COMP:
            arch.append(q)
            members.append(t)
        elif flag == FLAG_RAW:
            got = rows[q].contiguous().view(t.dtype)[: t.numel()]
            bad += harness._mismatch([got], [t])
            faults.check(n_w == raw_w, "wire_raw_words")
        else:
            faults.check(False, "wire_flag")
    if arch:
        u8 = rows.contiguous().view(torch.uint8)
        mismatch, ends = reference.check_float_archives(
            u8, [q * pad_w for q in arch], members, config["prob_bits"],
            config["checksum"], faults)
        bad += mismatch
        for q, end in zip(arch, ends):
            faults.check(end - q * pad_w == heads[q][1], "archive_size")
    return bad, words


def _traced(r: RankRun, layer: List[dict], tmp: Path):
    """Profile ``trace_roundtrips`` calls on every rank; returns this
    rank's (busy_s, window_s) and, on rank 0, the per-layer metrics and
    the breakdown."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if r.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(r.mix["trace_roundtrips"]):
            r.call(r.go_on(True), trace=True)
        harness._sync(r.device)
    path = tmp / f"trace{r.rank}.json"
    prof.export_chrome_trace(str(path))
    del prof
    t = tracing.TracedSlice(tracing.load_events(path))
    path.unlink()
    w = t.window()
    busy = (t.busy_s(), (w[1] - w[0]) / 1e6 if w else 0.0)
    if r.rank:
        return busy, None, None
    print(f"traced slice: {len(t.calls['allgather'])} calls", file=sys.stderr, flush=True)
    metrics = {}
    for m in layer:
        v = harness._reader(m["name"])(t)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return busy, metrics, t.breakdown()


def _rank_main(rank: int, world: int, backend: str, device_type: str, cell_name: str,
               seed: int, seconds: float, trace: bool, t_start: float, spec_path: str,
               codec, tmp: str, deadline_s: float) -> None:
    torch.set_num_threads(1)
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{Path(tmp) / 'store'}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=deadline_s))
    try:
        out = _run_rank(rank, world, device, cell_name, seed, seconds, trace, t_start,
                        Path(spec_path), codec, Path(tmp))
    except BaseException:
        # the peers may wait for this rank inside a collective, where no
        # teardown of the group can end: leave at once, and ``run`` ends them
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    if rank == 0:
        (Path(tmp) / "result.json").write_text(json.dumps(out))


def _run_rank(rank, world, device, cell_name, seed, seconds, trace, t_start, spec_path,
              codec, tmp: Path) -> Optional[dict]:
    def log(msg):
        if rank == 0:
            print(msg, file=sys.stderr, flush=True)

    cell, config, mix, e2e, layer = harness.load_cell(cell_name, spec_path)
    r = RankRun(config, mix, seed, rank, world, device, codec)
    log(f"ranks: {world} over {dist.get_backend()}; pool: {len(r.buckets)} buckets of "
        f"{r.n} {config['dtype']} a rank, {r.bucket_bytes} B a bucket")
    try:
        for _ in range(mix["warmup_roundtrips"]):
            r.call(r.go_on(True))
        harness._sync(device)
        r.reset_window()
        setup_s = time.perf_counter() - t_start
        busy = metrics = breakdown = None
        if not trace:
            t_end = time.perf_counter() + seconds
            start = r.go_on(True)
            while start is not None:
                r.call(start)
                start = r.go_on(time.perf_counter() < t_end)
        else:
            busy, metrics, breakdown = _traced(r, layer, tmp)
        harness._sync(device)
        mem = (r.mem_peak, r.codec_mem)
        checks = r.check()
    finally:
        r.codec.close()
    mine = {"times": r.times, "late": r.late, "mem": mem, "busy": busy, "checks": checks,
            "unwanted": harness.unwanted_modules()}
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank:
        return None
    return _result(every, e2e, setup_s, metrics, breakdown, r, device, log)


def _result(every, e2e, setup_s, metrics, breakdown, r: RankRun, device, log) -> dict:
    """Rank 0's result line from every rank's readings."""
    world = len(every)
    bad = sorted({m for e in every for m in e["unwanted"]})
    if bad:
        raise RuntimeError(f"a rank holds modules it must not load: {bad}")
    n = {len(e["times"]) for e in every}
    if len(n) != 1:
        raise RuntimeError(f"the ranks timed different numbers of calls: {sorted(n)}")
    times = [max(ts) for ts in zip(*(e["times"] for e in every))]
    failed = [any(fs) for fs in zip(*(e["checks"]["failed"] for e in every))]
    checks = {k: {"value": sum(e["checks"][k] for e in every), "limit": 0}
              for k in ("output_bad_floats", "archive_bad_floats")}
    c0 = every[0]["checks"]
    log(f"calls: {r.attempted} attempted, {sum(failed)} failed; ratio {c0['ratio']:.6f} "
        f"over {len(r.samples)} sampled; wire share {c0['wire_share']:.6f}; "
        f"{len(times)} timed")
    if times:
        slowest = [max(range(world), key=lambda q: every[q]["times"][i]) for i in range(len(times))]
        log("ranks' median call ms " + ", ".join(
            "%.3f" % (1e3 * stats.percentile(e["times"], 50)) for e in every)
            + "; share of calls each rank was slowest " + ", ".join(
            "%.3f" % (slowest.count(q) / len(times)) for q in range(world))
            + "; share of calls each rank reached after the start " + ", ".join(
            "%.3f" % (sum(x > 0 for x in e["late"]) / len(e["late"])) for e in every)
            + ", at most ms " + ", ".join("%.3f" % (1e3 * max(e["late"])) for e in every))
    faults = {k: v for e in every for k, v in e["checks"]["faults"].items()}
    if faults:
        log(f"format faults: {faults}")
    if metrics is None:
        m = {}
        if times:
            m["roundtrip_p95_ms"] = {"value": 1e3 * stats.percentile(times, 95), "unit": "ms"}
            m["allgather_gbps"] = {"value": stats.rate_gbps(
                [world * r.bucket_bytes] * len(times), times), "unit": "GB/s"}
        if device.type == "cuda":
            m["codec_mem_mib"] = {"value": max(e["mem"][1] for e in every) / harness.MIB,
                                  "unit": "MiB"}
        m["setup_s"] = {"value": setup_s, "unit": "s"}
        metrics = {k: v for k, v in m.items() if k in {x["name"] for x in e2e}}
    correct = bool(r.samples) and bool(times) and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": world, "memory_peak_bytes": max(e["mem"][0] for e in every)}
    if every[0]["busy"] is not None:
        dev["busy_s"] = sum(e["busy"][0] for e in every) / world
        dev["window_s"] = sum(e["busy"][1] for e in every) / world
    out = {"correct": correct, "attempted": r.attempted, "failed": sum(failed),
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, world: int,
        backend: str, device_type: str, t_start: float,
        spec_path: Path = harness.ROOT / "BENCHMARK.json", codec=None,
        deadline_s: float = 300.0) -> dict:
    """One run of a collective cell over ``world`` ranks, each in a process
    of its own on device r of ``device_type`` (``cpu``: all on the CPU),
    grouped over ``backend`` (``nccl`` on the card, ``gloo`` on the CPU);
    returns rank 0's result line's object. ``codec`` replaces the
    configuration's collective (a subclass of its class: the control and
    the faults). A rank that fails, or a world that has not ended within
    ``deadline_s`` seconds (by default well inside the 360 s that a run of
    the benchmark may take), ends every rank and raises."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(world, backend, device_type, cell_name, seed, seconds, trace, t_start,
                  str(spec_path), codec, tmp, deadline_s))
        deadline = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world} took over {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return json.loads((Path(tmp) / "result.json").read_text())
