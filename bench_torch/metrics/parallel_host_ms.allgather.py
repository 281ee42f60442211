"""Host ms an all-gather call spends inside the program's ``parallel:``
spans, outside its ``model:``, ``kernel:`` and ``sync:`` spans: the
parallel layer's own glue around the codec (``parallel/collectives.py``;
rank 0's traced calls). None where the program records no ``parallel:``
span."""

from bench_torch import program_spans, stats
from bench_torch.tracing import _end

CALL = ("allgather",)


def read(trace):
    n = len(trace.calls["allgather"])
    if not program_spans.readable(trace) or not n:
        return None
    par = stats.union((s["ts"], _end(s)) for s in program_spans.spans_of(trace, "parallel:", CALL))
    if not par:
        return None
    out = [(s["ts"], _end(s)) for p in ("model:", "kernel:", "sync:")
           for s in program_spans.spans_of(trace, p, CALL)]
    return sum(b - a - stats.covered(out, (a, b)) for a, b in par) / n / 1e3
