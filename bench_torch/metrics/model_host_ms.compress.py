"""Host ms a compress call spends inside the program's ``model:`` spans,
outside its ``kernel:`` and ``sync:`` spans (``program_spans.py``)."""

from bench_torch import program_spans


def read(trace):
    return program_spans.model_host_ms(trace, "compress")
