"""Runtime calls that put work on the device per round trip whose innermost
program span of ``api:``, ``model:`` and ``kernel:`` is the API's
(``program_spans.py``): the API layer's own launches."""

from bench_torch import program_spans


def read(trace):
    return program_spans.launches_per_roundtrip(trace, "api:")
