"""Percent of the compress calls' host time in which no device op ran."""


def read(trace):
    return trace.idle_share("compress")
