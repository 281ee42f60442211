"""Runtime calls that put work on the device (kernel launches, copies,
fills) per round trip: the host-side cost of the models and ops layers."""


def read(trace):
    return trace.launches_per_roundtrip()
