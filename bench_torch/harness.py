"""One run of one cell: set up, warm up, measure, check.

A cell of ``BENCHMARK.json`` names a configuration
(``configs/<config>.json``: the floats and the codec's settings) and a
traffic mix (``traffic/<traffic>.json``: batch shape, pool, how many round
trips to warm, sample and trace). Its per-layer metrics are read by
``metrics/<metric>.py``, each a module with ``read(trace)``.

The loop is closed, with one caller: each round trip takes the next batch
of the pool, compresses it through ``api.codec.compress_data``,
synchronises, decompresses that archive through ``decompress_data`` and
synchronises again, each call timed on the host clock from its start to
the return of the synchronise. Every round trip in the window counts.
A sample of them, drawn from the seed, keeps its archives and outputs,
which are checked once the window has closed (``reference.py``).
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import sys
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import reference, stats, traffic, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MIB = 1 << 20
# modules that no process of a run may hold, compared by top-level name
UNWANTED = ("jax", "jaxlib", "flax", "dietgpu_fork_tpu")


def unwanted_modules() -> List[str]:
    """The modules of ``UNWANTED`` that this process holds."""
    return sorted(m for m in sys.modules if m.split(".")[0] in UNWANTED)


class Codec:
    """The timed path: the API's public batch entry points."""

    def __init__(self, config: dict):
        from dietgpu_fork_torch.api import codec as api
        self.api = api
        self.dtype = traffic.dtype_of(config["dtype"])
        self.checksum = config["checksum"]
        self.prob_bits = config["prob_bits"]
        self.sparse = config["sparse"]

    def compress(self, batch: List[torch.Tensor]):
        comp, sizes, _ = self.api.compress_data(
            True, batch, self.checksum, self.prob_bits, self.sparse)
        return comp, sizes

    def decompress(self, comp: torch.Tensor, caps: List[int]):
        """Returns (outputs, every member decoded and its checksum held)."""
        outs, _, success, status, _ = self.api.decompress_data(
            True, comp, caps, self.dtype, self.checksum, self.prob_bits, self.sparse)
        return outs, bool(success.all()) and status.ok


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json"):
    """(cell, configuration, traffic, the cell's end-to-end and per-layer
    metric entries). The configuration and traffic files lie beside the
    spec, in ``<spec's directory>/bench_torch/{configs,traffic}``."""
    with open(spec_path) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {spec_path}")
    cell = cells[name]
    data = Path(spec_path).parent / HERE.name
    config = traffic.load(data / "configs" / f"{cell['config']}.json")
    mix = traffic.load(data / "traffic" / f"{cell['traffic']}.json")
    mine = [[m for m in spec[k] if name in m.get("workloads", [name])]
            for k in ("end_to_end", "per_layer")]
    return cell, config, mix, *mine


def _reader(metric: str) -> Callable:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mismatch(outs: List[torch.Tensor], members: List[torch.Tensor]) -> int:
    """Floats of the outputs whose bits differ from the inputs', a missing
    or extra float counting as one."""
    bad = 0 if len(outs) == len(members) else sum(t.numel() for t in members)
    for o, t in zip(outs, members):
        n = min(o.numel(), t.numel())
        bad += abs(o.numel() - t.numel())
        if o.dtype != t.dtype:
            bad += n
        elif n:
            bad += int((reference.float_bits(o[:n]) != reference.float_bits(t[:n])).sum())
    return bad


class Run:
    """The state of one run: the pool, the codec and what was read."""

    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device,
                 wrap: Optional[Callable] = None):
        self.config, self.mix, self.device = config, mix, device
        self.pool = traffic.make_pool(config, mix, seed, device)
        self.raw_bytes = traffic.batch_bytes(config, mix)
        self.caps = [t.numel() for t in self.pool[0]]
        codec = Codec(config)
        self.codec = wrap(codec, config) if wrap else codec
        self.next = 0
        self.rng = random.Random(seed)
        self.samples: List[tuple] = []
        self.seen = 0
        self.t_comp: List[float] = []
        self.t_dec: List[float] = []
        self.attempted = 0
        self.failed = 0
        self.mem_peak = 0
        self.codec_mem = 0
        self.comp_bytes = 0

    def roundtrip(self, trace: bool = False) -> None:
        cuda = self.device.type == "cuda"
        b = self.next % len(self.pool)
        self.next += 1
        batch = self.pool[b]
        span = torch.profiler.record_function if trace else (lambda name: nullcontext())
        if cuda:
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.attempted += 1
        try:
            t0 = time.perf_counter()
            with span("bench.compress"):
                with span("api.compress_data"):
                    comp, sizes = self.codec.compress(batch)
                _sync(self.device)
            t1 = time.perf_counter()
            with span("bench.decompress"):
                with span("api.decompress_data"):
                    outs, ok = self.codec.decompress(comp, self.caps)
                _sync(self.device)
            t2 = time.perf_counter()
        except (RuntimeError, ValueError) as e:
            self.failed += 1
            print(f"round trip {self.attempted} failed: {e}"[:300], file=sys.stderr)
            return
        if cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.mem_peak = max(self.mem_peak, peak)
            self.codec_mem = max(self.codec_mem, peak - base)
        self.failed += not ok
        self.t_comp.append(t1 - t0)
        self.t_dec.append(t2 - t1)
        self._sample((b, comp, sizes, outs))

    def _sample(self, item) -> None:
        """Reservoir sampling from the seed: each round trip so far is kept
        with the same chance."""
        k = self.mix["sample_roundtrips"]
        if len(self.samples) < k:
            self.samples.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < k:
                self.samples[j] = item
        self.seen += 1

    def reset_window(self) -> None:
        self.samples, self.seen = [], 0
        self.t_comp, self.t_dec = [], []
        self.codec_mem = 0

    def check(self) -> Dict[str, Dict[str, int]]:
        """The numbers compared, each with its limit; both are exact, so
        the limit is 0. ``output_bad_floats``: floats that did not come back
        intact from the program's decompress, a round trip that failed (or
        whose success or checksum status the API reported false) counting
        all its floats. ``archive_bad_floats``: floats that the reference
        does not read back from the program's archive, a sampled batch whose
        archives break a rule of the format counting all its floats."""
        faults = reference.Faults()
        floats = self.mix["members"] * self.mix["floats"]
        out_bad, arch_bad = self.failed * floats, 0
        cfg = self.config
        for b, comp, sizes, outs in self.samples:
            members = self.pool[b]
            out_bad += _mismatch(outs, members)
            sizes = sizes.tolist()
            self.comp_bytes += sum(sizes)
            before = faults.total
            try:
                bad = reference.check_batch(
                    comp, sizes, members, cfg["prob_bits"], cfg["checksum"],
                    cfg["sparse"], faults)
            except (RuntimeError, ValueError, IndexError) as e:
                faults.counts["reference_error"] += 1
                print(f"reference: {e}"[:300], file=sys.stderr)
            arch_bad += floats if faults.total > before else bad
        self.faults = faults
        return {"output_bad_floats": {"value": out_bad, "limit": 0},
                "archive_bad_floats": {"value": arch_bad, "limit": 0}}


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: torch.device, t_start: float, wrap: Optional[Callable] = None,
        spec_path: Path = ROOT / "BENCHMARK.json", log=print) -> dict:
    """One run of a cell; returns the result line's object."""
    cell, config, mix, e2e, layer = load_cell(cell_name, spec_path)
    r = Run(config, mix, seed, device, wrap)
    log(f"pool: {len(r.pool)} batches of {mix['members']} x {mix['floats']} "
        f"{config['dtype']}, {r.raw_bytes} B a batch")
    for _ in range(mix["warmup_roundtrips"]):
        r.roundtrip()
    _sync(device)
    r.reset_window()
    setup_s = time.perf_counter() - t_start
    dev_extra, breakdown = {}, None
    if not trace:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            r.roundtrip()
        metrics = {k: v for k, v in _end_to_end(r, setup_s).items()
                   if k in {m["name"] for m in e2e}}
    else:
        metrics, dev_extra, breakdown = _traced(r, layer, log)
    _sync(device)
    checks = r.check()
    n_rt = len(r.t_comp)
    log(f"round trips: {r.attempted} attempted, {r.failed} failed; "
        f"ratio {r.comp_bytes / max(1, len(r.samples) * r.raw_bytes):.6f} "
        f"over {len(r.samples)} sampled; {n_rt} timed")
    if r.faults.counts:
        log(f"format faults: {dict(r.faults.counts)}")
    correct = bool(r.samples) and n_rt > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": r.mem_peak, **dev_extra}
    out = {"correct": correct, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _end_to_end(r: Run, setup_s: float) -> dict:
    m = {}
    if r.t_comp:
        rts = [a + b for a, b in zip(r.t_comp, r.t_dec)]
        m["compress_gbps"] = {"value": stats.rate_gbps([r.raw_bytes] * len(r.t_comp), r.t_comp),
                              "unit": "GB/s"}
        m["decompress_gbps"] = {"value": stats.rate_gbps([r.raw_bytes] * len(r.t_dec), r.t_dec),
                                "unit": "GB/s"}
        m["roundtrip_p95_ms"] = {"value": 1e3 * stats.percentile(rts, 95), "unit": "ms"}
    if r.device.type == "cuda":
        m["codec_mem_mib"] = {"value": r.codec_mem / MIB, "unit": "MiB"}
    m["setup_s"] = {"value": setup_s, "unit": "s"}
    return m


def _traced(r: Run, layer: List[dict], log):
    """Profile a slice of round trips, then run the same batches again
    with the kernel launches recorded for their byte counts, and read the
    cell's per-layer metrics. Returns (metrics, busy_s and window_s, the
    breakdown)."""
    # one more pass over the pool first, so that the caching allocator
    # holds a block for every size the slice asks for
    for _ in range(len(r.pool)):
        r.roundtrip()
    n = r.mix["trace_roundtrips"]
    start = r.next
    acts = [torch.profiler.ProfilerActivity.CPU]
    if r.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing.instrument():
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                r.roundtrip(trace=True)
            _sync(r.device)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = tracing.load_events(path)
    del prof
    with tracing.ByteRecorder() as rec:
        for i in range(start, start + n):
            rec.direction = "compress"
            comp, _ = r.codec.compress(r.pool[i % len(r.pool)])
            rec.direction = "decompress"
            r.codec.decompress(comp, r.caps)
            del comp
    t = tracing.TracedSlice(events, rec.bytes, rec.calls)
    log(f"traced slice: {t.roundtrips} round trips, {len(events)} trace events")
    for d, w, calls, ms, share in t.kernel_shares():
        log(f"kernel {d} {w}: {calls} launches, {ms:.4f} ms, {share:.2f}% of its bound")
    metrics = {}
    for m in layer:
        v = _reader(m["name"])(t)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    w = t.window()
    window_s = (w[1] - w[0]) / 1e6 if w else 0.0
    return metrics, {"busy_s": t.busy_s(), "window_s": window_s}, t.breakdown()
