"""Device ms a decompress call spends on the ops that the sparse codec
(models/sparse.py) launches itself, outside the dense float codec it calls."""


def read(trace):
    return trace.device_ms("decompress", "model:sparse.", "model:float_codec.")
