"""Percent of the round trips' host time (both calls) in which no device op ran."""


def read(trace):
    return trace.idle_share("roundtrip")
