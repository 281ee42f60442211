"""Percent: the least time of the port's kernel launches in decompress
calls at the device memory's rate (rooflines.py) over their device time."""


def read(trace):
    return trace.kernels_roofline("decompress")
