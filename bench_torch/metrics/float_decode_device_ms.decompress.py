"""Device ms a decompress call spends on the float codec's decode: the ops
whose innermost ``stage:`` span is ``stage:ans.decode`` (K4, K6 or K12)
or ``stage:float_codec.join`` (K7 or K13 after K6), the program's spans."""

STAGES = ("stage:ans.decode", "stage:float_codec.join")


def read(trace):
    parts = [trace.device_ms("decompress", s, "stage:") for s in STAGES]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
