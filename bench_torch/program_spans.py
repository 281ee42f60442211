"""Readings of the spans that the program records itself while a profiler
runs (``dietgpu_fork_torch/utils/profiling.py``), from a ``TracedSlice``'s
public attributes (``host``, ``spans``, ``runtime``, ``calls``,
``roundtrips``, ``ancestors``):

* ``api:<function>``: a public entry of the API;
* ``model:<module>.<function>``: a model entry;
* ``kernel:<wrapper>``: a kernel wrapper;
* ``stage:<module>.<stage>``: a stage of a path;
* ``sync:<module>.<site>``: a statement that blocks the host on the device.

The benchmark's own spans (``tracing.instrument``) wrap the model entries
and the kernel wrappers under the same names as the program's spans inside
them: a span counts once where a span of its name encloses it, and times
are read from unions of intervals. The program's work is what lies inside
its ``api:`` spans; in a slice whose calls enter no ``api:`` span (a
collective's call, which calls the models itself), what lies inside the
calls. A slice reads None everywhere where the program recorded none of
its own spans, or where no device op ran (a run on the CPU, where no
statement waits on a device).
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

from . import stats
from .tracing import CALLS, _end, _launches

FAMILIES = ("api:", "model:", "kernel:")
# the span families that only the program records (the benchmark's own
# spans wrap model entries and kernel wrappers under the program's names)
OWN = ("api:", "stage:", "sync:")


def readable(t) -> bool:
    """Whether the slice holds the program's own spans and device work."""
    return bool(t.device) and any(s["name"].startswith(OWN) for s in t.spans)


def _has_api(t) -> bool:
    return any(s["name"].startswith("api:") for s in t.spans)


def _in_program(t, e, has_api: bool) -> bool:
    """Whether e lies inside the program's work: inside an ``api:`` span,
    or, in a slice without one, inside a call."""
    if has_api:
        return _innermost(t.ancestors[id(e)], ("api:",)) is not None
    return _direction(t, e) is not None


def _direction(t, e) -> Optional[str]:
    for d in CALLS:
        if "bench." + d in t.ancestors[id(e)]:
            return d
    return None


def _directions(direction: str) -> Tuple[str, ...]:
    return CALLS if direction == "roundtrip" else (direction,)


def _innermost(names: Sequence[str], prefixes) -> Optional[str]:
    for name in reversed(names):
        if name.startswith(tuple(prefixes)):
            return name
    return None


def spans_of(t, prefix: str, directions: Sequence[str] = CALLS) -> List[dict]:
    """The spans whose name starts with prefix, inside a call of the given
    directions, leaving out each one that a span of its own name encloses."""
    return [s for s in t.spans if s["name"].startswith(prefix)
            and s["name"] not in t.ancestors[id(s)] and _direction(t, s) in directions]


def host_syncs_per_roundtrip(t) -> Optional[float]:
    """``sync:`` spans inside the program's work (the API's entries, or a
    collective's calls), per round trip."""
    if not readable(t) or not t.roundtrips:
        return None
    has_api = _has_api(t)
    n = sum(1 for s in spans_of(t, "sync:") if _in_program(t, s, has_api))
    return n / t.roundtrips


def launches_by_family(t) -> Dict[Optional[str], int]:
    """Runtime calls that put work on the device (``tracing._launches``)
    inside the calls, by the family of their innermost ``api:``,
    ``model:`` or ``kernel:`` span (None: inside none)."""
    out: Dict[Optional[str], int] = collections.Counter()
    for e in t.runtime:
        if _launches(e["name"]) and _direction(t, e):
            owner = _innermost(t.ancestors[id(e)], FAMILIES)
            out[None if owner is None else owner[:owner.index(":") + 1]] += 1
    return out


def launches_per_roundtrip(t, family: str) -> Optional[float]:
    """Launching runtime calls per round trip whose innermost ``api:``,
    ``model:`` or ``kernel:`` span is of ``family``."""
    if not readable(t) or not t.roundtrips:
        return None
    return launches_by_family(t)[family] / t.roundtrips


def model_host_ms(t, direction: str) -> Optional[float]:
    """Host ms a call (a round trip: "roundtrip") spends inside ``model:``
    spans, outside ``kernel:`` and ``sync:`` spans."""
    dirs = _directions(direction)
    n = t.roundtrips if direction == "roundtrip" else len(t.calls[direction])
    if not readable(t) or not n:
        return None
    model = stats.union((s["ts"], _end(s)) for s in spans_of(t, "model:", dirs))
    if not model:
        return None
    out = [(s["ts"], _end(s)) for p in ("kernel:", "sync:") for s in spans_of(t, p, dirs)]
    total = sum(b - a - stats.covered(out, (a, b)) for a, b in model)
    return total / n / 1e3


def sync_coverage(t) -> Optional[dict]:
    """The host's waits on the device against the ``sync:`` spans:
    ``runtime_syncs`` (``cudaStreamSynchronize`` / ``cudaDeviceSynchronize``
    calls inside an ``api:`` span), ``covered`` (of those, the ones inside
    a ``sync:`` span), ``sync_spans`` and ``empty`` (``sync:`` spans inside
    an ``api:`` span that hold no such call), over the whole slice."""
    if not readable(t):
        return None
    waits = [e for e in t.runtime if "Synchronize" in e["name"] and _direction(t, e)
             and _innermost(t.ancestors[id(e)], ("api:",)) is not None]
    covered = sum(1 for e in waits if _innermost(t.ancestors[id(e)], ("sync:",)))
    syncs = [s for s in spans_of(t, "sync:")
             if _innermost(t.ancestors[id(s)], ("api:",)) is not None]
    starts = sorted(e["ts"] for e in waits)
    empty = [s["name"] for s in syncs
             if bisect.bisect_right(starts, _end(s)) == bisect.bisect_left(starts, s["ts"])]
    return {"runtime_syncs": len(waits), "covered": covered, "sync_spans": len(syncs),
            "empty": sorted(collections.Counter(empty).items())}


def _label(names: Sequence[str]) -> str:
    """Where a host event lies by stage: its innermost ``stage:`` span,
    else its innermost ``model:`` or ``api:`` span, else "host"."""
    return (_innermost(names, ("stage:",)) or _innermost(names, ("model:", "api:"))
            or "host")


def by_stage(t) -> Dict[str, Dict[str, float]]:
    """Per stage label (``_label``) and direction: ``launches`` a round
    trip and ``idle_ms`` a round trip, the time inside the calls in which no
    device op ran, each stretch split at the program's span boundaries."""
    if not readable(t) or not t.roundtrips:
        return {}
    rows: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for e in t.runtime:
        d = _direction(t, e)
        if d and _launches(e["name"]):
            rows[_label(t.ancestors[id(e)])][d + ".launches"] += 1 / t.roundtrips
    # change points of the label over the main thread's program spans
    prog = [s for s in t.spans if s["name"].split(":")[0] in ("api", "model", "stage")]
    points = sorted({p for s in prog for p in (s["ts"], _end(s))})
    labels = []
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        labels.append(_label([s["name"] for s in prog if s["ts"] <= mid < _end(s)]))
    ivs = [(op["ts"], _end(op)) for op, _ in t.device]
    for d in CALLS:
        for win in t.calls[d]:
            for a, b in stats.gaps(ivs, win):
                cuts = [a] + [p for p in points if a < p < b] + [b]
                for x, y in zip(cuts, cuts[1:]):
                    i = bisect.bisect_right(points, (x + y) / 2) - 1
                    lab = labels[i] if 0 <= i < len(labels) else "host"
                    rows[lab][d + ".idle_ms"] += (y - x) / 1e3 / t.roundtrips
    return {k: dict(v) for k, v in rows.items()}
