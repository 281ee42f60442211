"""Runtime calls that put work on the device per round trip whose innermost
program span of ``api:``, ``model:`` and ``kernel:`` is a model entry's
(``program_spans.py``): the torch glue of the models and ops, outside the
kernel wrappers."""

from bench_torch import program_spans


def read(trace):
    return program_spans.launches_per_roundtrip(trace, "model:")
