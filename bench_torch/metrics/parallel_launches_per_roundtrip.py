"""Runtime calls that put work on the device per round trip (a
collective's call) whose innermost program span of ``api:``, ``model:``,
``kernel:`` and ``parallel:`` is a collective's (``parallel/collectives.py``):
the parallel layer's own launches, copies and fills, NCCL's among them.
None where the program records no ``parallel:`` span."""

from bench_torch import program_spans
from bench_torch.tracing import _launches

FAMILIES = program_spans.FAMILIES + ("parallel:",)


def read(trace):
    if not program_spans.readable(trace) or not trace.roundtrips:
        return None
    if not any(s["name"].startswith("parallel:") for s in trace.spans):
        return None
    n = sum(1 for e in trace.runtime
            if _launches(e["name"]) and program_spans._direction(trace, e)
            and (program_spans._innermost(trace.ancestors[id(e)], FAMILIES)
                 or "").startswith("parallel:"))
    return n / trace.roundtrips
