"""Spans around the program's layers, recorded from the benchmark's own
files in the traced run only, and the reduction of a profiler trace to the
quantities the per-layer metrics read.

Spans (``torch.profiler.record_function``, so device work can be traced
back to them through the launching runtime call):

* ``bench.compress`` / ``bench.decompress``: a timed call and the
  synchronise after it (the harness); ``bench.allgather``: a timed call of
  a collective cell and its synchronise (``ranks.py``);
* ``api.compress_data`` / ``api.decompress_data``: the API entry;
* ``model:<module>.<function>``: the model entries, wrapped under the
  names their callers look them up by (``MODEL_ENTRIES``);
* ``kernel:<wrapper>``: each kernel wrapper of
  ``runtime/cuda_kernels.py``, as the ops modules call it.
"""

from __future__ import annotations

import bisect
import collections
import functools
import importlib
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from torch.profiler import record_function

from . import rooflines, stats

# (module, attribute the callers look up, span)
MODEL_ENTRIES = (
    ("dietgpu_fork_torch.api.codec", "float_compress_padded",
     "model:float_codec.float_compress_padded"),
    ("dietgpu_fork_torch.api.codec", "float_decompress_core",
     "model:float_codec.float_decompress_core"),
    ("dietgpu_fork_torch.api.codec", "sparse_float_compress_padded",
     "model:sparse.sparse_float_compress_padded"),
    ("dietgpu_fork_torch.api.codec", "sparse_float_decompress_core",
     "model:sparse.sparse_float_decompress_core"),
    ("dietgpu_fork_torch.models.sparse", "float_compress_core",
     "model:float_codec.float_compress_core"),
    ("dietgpu_fork_torch.models.sparse", "float_decompress_core",
     "model:float_codec.float_decompress_core"),
)
KERNELS_MODULE = "dietgpu_fork_torch.runtime.cuda_kernels"
DIRECTIONS = ("compress", "decompress")
# every timed call's span name, ``bench.<call>``: the directions and the
# collectives' calls
CALLS = DIRECTIONS + ("allgather",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _spanned(fn, name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapper


class Patches:
    """Replaces module attributes while open and puts them back on close."""

    def __init__(self):
        self._saved: List[Tuple[object, str, object]] = []

    def set(self, module, attr: str, value) -> None:
        self._saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, attr, value in reversed(self._saved):
            setattr(module, attr, value)
        self._saved.clear()


def _lookup(module, attr: str):
    """The attribute, or an error naming it: a renamed entry or wrapper
    would otherwise change what a metric reads with nothing to show it."""
    if not hasattr(module, attr):
        raise AttributeError(
            f"{module.__name__}.{attr} is gone: bench_torch/tracing.py and "
            "bench_torch/rooflines.py name the program's entries and kernel wrappers")
    return getattr(module, attr)


def instrument() -> Patches:
    """Spans around the model entries and every kernel wrapper; raises if
    the program lacks one."""
    K = importlib.import_module(KERNELS_MODULE)
    spans = [(importlib.import_module(m), attr, span) for m, attr, span in MODEL_ENTRIES]
    spans += [(K, w, "kernel:" + w) for w in rooflines.WRAPPERS]
    fns = [_lookup(mod, attr) for mod, attr, _ in spans]
    p = Patches()
    for (mod, attr, span), fn in zip(spans, fns):
        p.set(mod, attr, _spanned(fn, span))
    return p


class ByteRecorder(Patches):
    """While open, every kernel launch adds the bytes it needs
    (``rooflines.kernel_bytes``) and one call to the current direction's
    totals. It reads its arguments back to the host: run it outside the
    profiled calls."""

    def __init__(self):
        super().__init__()
        self.direction = DIRECTIONS[0]
        self.bytes: Dict[str, Dict[str, int]] = {d: collections.Counter() for d in DIRECTIONS}
        self.calls: Dict[str, Dict[str, int]] = {d: collections.Counter() for d in DIRECTIONS}
        K = importlib.import_module(KERNELS_MODULE)
        fns = [_lookup(K, w) for w in rooflines.WRAPPERS]
        for w, fn in zip(rooflines.WRAPPERS, fns):
            self.set(K, w, self._recording(w, fn))

    def _recording(self, w: str, fn):
        @functools.wraps(fn)
        def rec(*args):
            out = fn(*args)
            self.bytes[self.direction][w] += rooflines.kernel_bytes(w, args, out)
            self.calls[self.direction][w] += 1
            return out
        return rec


def load_events(path) -> List[dict]:
    with open(path) as f:
        d = json.load(f)
    return d["traceEvents"] if isinstance(d, dict) else d


def _end(e) -> float:
    return e["ts"] + e.get("dur", 0)


class TracedSlice:
    """A profiled slice of round trips, reduced for the metric readers.
    Times are in microseconds, as the trace gives them."""

    def __init__(self, events: Sequence[dict], kernel_bytes=None, kernel_calls=None):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        calls = [e for e in xs if e.get("cat") == "user_annotation"
                 and e.get("name") in {"bench." + c for c in CALLS}]
        self.tid = calls[0]["tid"] if calls else None
        host = sorted((e for e in xs if e.get("tid") == self.tid
                       and e.get("cat") not in DEVICE_CATS), key=lambda e: (e["ts"], -e.get("dur", 0)))
        self.spans = [e for e in host if e.get("cat") == "user_annotation"]
        self.runtime = [e for e in host if e.get("cat") in RUNTIME_CATS]
        self.host = host
        self.calls = {d: [(e["ts"], _end(e)) for e in calls if e["name"] == "bench." + d]
                      for d in CALLS}
        # a round trip: a compress and its decompress, or a collective's call
        self.roundtrips = len(self.calls["compress"]) + len(self.calls["allgather"])
        self.kernel_bytes = kernel_bytes or {d: {} for d in DIRECTIONS}
        self.kernel_calls = kernel_calls or {d: {} for d in DIRECTIONS}
        # each host event's enclosing spans, outermost first
        self.ancestors: Dict[int, Tuple[str, ...]] = {}
        stack: List[dict] = []
        for e in host:
            while stack and _end(stack[-1]) <= e["ts"]:
                stack.pop()
            self.ancestors[id(e)] = tuple(s["name"] for s in stack)
            if e.get("cat") == "user_annotation":
                stack.append(e)
        by_corr = {}
        for e in self.runtime:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                by_corr[c] = e
        # device ops with the runtime call that launched them
        self.device: List[Tuple[dict, dict]] = []
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                launch = by_corr.get(e.get("args", {}).get("correlation"))
                if launch is not None:
                    self.device.append((e, launch))

    # -- attribution ---------------------------------------------------------

    def _stack(self, e) -> Tuple[str, ...]:
        return self.ancestors[id(e)] + ((e["name"],) if e.get("cat") == "user_annotation" else ())

    def direction_of(self, e) -> Optional[str]:
        for d in CALLS:
            if "bench." + d in self._stack(e):
                return d
        return None

    @staticmethod
    def _owner(stack: Sequence[str], prefixes: Sequence[str]) -> Optional[str]:
        """The innermost span whose name starts with one of prefixes."""
        for name in reversed(stack):
            if name.startswith(tuple(prefixes)):
                return name
        return None

    # -- what the metric readers read ---------------------------------------

    def api_host_ms(self, direction: str) -> Optional[float]:
        """Host ms a call inside the API entry, outside the model entries it
        calls and outside runtime calls that wait for the device (copies to
        or from the host, synchronisations); "roundtrip": the two calls of
        a round trip together."""
        if direction == "roundtrip":
            parts = [self.api_host_ms(d) for d in DIRECTIONS]
            return None if None in parts else sum(parts)
        api = "api." + ("compress_data" if direction == "compress" else "decompress_data")
        own = [e for e in self.spans if e["name"] == api]
        if not own:
            return None
        total = sum(e["dur"] for e in own)
        for e in self.host:
            owner = self._owner(self.ancestors[id(e)], ("api.", "model:"))
            if owner != api:
                continue
            if e["name"].startswith("model:") or (
                    e.get("cat") in RUNTIME_CATS and _waits(e["name"])):
                total -= e["dur"]
        return total / len(own) / 1e3

    def device_ms(self, direction: str, inside: str, outside: str) -> Optional[float]:
        """Device ms a call of the ops launched inside a span whose name
        starts with ``inside`` and not inside one starting with ``outside``."""
        n = len(self.calls[direction])
        if not n:
            return None
        total, seen = 0.0, False
        for op, launch in self.device:
            if self.direction_of(launch) != direction:
                continue
            owner = self._owner(self._stack(launch), (inside, outside))
            if owner is not None and owner.startswith(inside):
                total += op.get("dur", 0)
                seen = True
        return total / n / 1e3 if seen else None

    def device_ms_of(self, call: str, pick: Callable[[str], bool]) -> Optional[float]:
        """Device ms a call of ``call`` (a name of ``CALLS``) of the ops
        launched inside it whose name ``pick`` takes."""
        n = len(self.calls[call])
        ops = [op for op, launch in self.device
               if self.direction_of(launch) == call and pick(op["name"])]
        if not n or not ops:
            return None
        return sum(op.get("dur", 0) for op in ops) / n / 1e3

    def launches_per_roundtrip(self) -> Optional[float]:
        """Runtime calls that put work on the device (kernel launches,
        copies, fills), per round trip."""
        n = sum(1 for e in self.runtime if _launches(e["name"]) and self.direction_of(e))
        if not n or not self.roundtrips:
            return None
        return n / self.roundtrips

    def kernel_time_us(self, direction: str) -> Dict[str, float]:
        """Device microseconds of the port's own kernels by wrapper, each
        launched inside its ``kernel:`` span (torch's fills of the outputs
        left out)."""
        out: Dict[str, float] = collections.Counter()
        for op, launch in self.device:
            if op.get("cat") != "kernel" or "at::" in op["name"]:
                continue
            if self.direction_of(launch) != direction:
                continue
            owner = self._owner(self._stack(launch), ("kernel:",))
            if owner is not None:
                out[owner[len("kernel:"):]] += op.get("dur", 0)
        return out

    def kernels_roofline(self, direction: str) -> Optional[float]:
        """Percent: the least time of the port's kernel launches at the
        device memory's rate over their device time, summed."""
        t = self.kernel_time_us(direction)
        used = [w for w in t if w in self.kernel_bytes[direction]]
        if not used:
            return None
        nbytes = sum(self.kernel_bytes[direction][w] for w in used)
        return 100 * rooflines.bound_s(nbytes) / (sum(t[w] for w in used) / 1e6)

    def kernel_shares(self) -> List[Tuple[str, str, int, float, float]]:
        """(direction, wrapper, launches, device ms, percent of its bound)."""
        rows = []
        for d in DIRECTIONS:
            t = self.kernel_time_us(d)
            for w, us in sorted(t.items()):
                nb = self.kernel_bytes[d].get(w)
                if nb is not None and us > 0:
                    rows.append((d, w, self.kernel_calls[d].get(w, 0), us / 1e3,
                                 100 * rooflines.bound_s(nb) / (us / 1e6)))
        return rows

    def _device_intervals(self):
        return [(op["ts"], _end(op)) for op, _ in self.device]

    def idle_share(self, direction: str) -> Optional[float]:
        """Percent of the calls' time in which no device op ran;
        "roundtrip": of every call's time."""
        windows = [w for d in CALLS if direction in (d, "roundtrip") for w in self.calls[d]]
        if not windows or not self.device:
            return None
        ivs = self._device_intervals()
        busy = sum(stats.covered(ivs, w) for w in windows)
        return 100 * (1 - busy / sum(b - a for a, b in windows))

    def window(self) -> Optional[Tuple[float, float]]:
        ws = [w for d in CALLS for w in self.calls[d]]
        if not ws:
            return None
        return min(a for a, _ in ws), max(b for _, b in ws)

    def busy_s(self) -> float:
        w = self.window()
        return stats.covered(self._device_intervals(), w) / 1e6 if w else 0.0

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time in the slice, and the idle
        time inside the calls by what the host was doing: the innermost
        host event around each gap's middle."""
        w = self.window()
        ops: Dict[str, float] = collections.Counter()
        for op, _ in self.device:
            if w and w[0] <= op["ts"] <= w[1]:
                ops[_short(op["name"])] += op.get("dur", 0) / 1e6
        times, names = self._timeline()
        idle: Dict[str, float] = collections.Counter()
        ivs = self._device_intervals()
        for d in CALLS:
            for win in self.calls[d]:
                for a, b in stats.gaps(ivs, win):
                    i = bisect.bisect_right(times, (a + b) / 2) - 1
                    idle[names[i] if i >= 0 else "host"] += (b - a) / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}

    def _timeline(self):
        """Change points of the innermost host event on the main thread."""
        times, names = [], []
        stack: List[dict] = []

        def mark(t):
            name = _short(stack[-1]["name"]) if stack else "host, outside any op"
            if names and names[-1] == name:
                return
            times.append(t)
            names.append(name)

        for e in self.host:
            while stack and _end(stack[-1]) <= e["ts"]:
                t = _end(stack.pop())
                while stack and _end(stack[-1]) <= t:
                    stack.pop()
                mark(t)
            stack.append(e)
            mark(e["ts"])
        while stack:
            t = _end(stack.pop())
            while stack and _end(stack[-1]) <= t:
                stack.pop()
            mark(t)
        return times, names


def _waits(name: str) -> bool:
    return "Synchronize" in name or "Memcpy" in name


def _launches(name: str) -> bool:
    return "LaunchKernel" in name or "Memcpy" in name or "Memset" in name


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."
