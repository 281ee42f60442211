"""Device ms an all-gather call spends in NCCL's kernels: the exchange of
the size headers and of the payload rows, with the wait for the peers
that the kernels spin through (rank 0's traced calls)."""


def read(trace):
    return trace.device_ms_of("allgather", lambda name: "nccl" in name.lower())
