"""Statements that block the host on the device, per round trip: the
program's ``sync:`` spans inside its API entries (``program_spans.py``)."""

from bench_torch import program_spans


def read(trace):
    return program_spans.host_syncs_per_roundtrip(trace)
