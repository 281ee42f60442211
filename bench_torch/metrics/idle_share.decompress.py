"""Percent of the decompress calls' host time in which no device op ran."""


def read(trace):
    return trace.idle_share("decompress")
