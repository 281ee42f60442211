"""Device ms an all-gather call spends in every device op other than
NCCL's kernels: the compress of the rank's bucket, the decode of every
received row, and the copies and fills around them (rank 0's traced
calls)."""


def read(trace):
    return trace.device_ms_of("allgather", lambda name: "nccl" not in name.lower())
