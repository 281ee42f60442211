"""Percent: the least time of the float decode's kernel launches in
decompress calls (the fused K4 or K12, or K6 then K7 or K13) at the device
memory's rate (rooflines.py) over their device time."""

from bench_torch import rooflines

WRAPPERS = ("decode_rows", "decode_blocks", "decode_join16", "decode_join16_blocks",
            "decode_join32", "decode_join32_blocks", "join_wide_at", "join16_at")


def read(trace):
    t = trace.kernel_time_us("decompress")
    nbytes = trace.kernel_bytes["decompress"]
    used = [w for w in WRAPPERS if t.get(w) and w in nbytes]
    if not used:
        return None
    need = rooflines.bound_s(sum(nbytes[w] for w in used))
    return 100 * need / (sum(t[w] for w in used) / 1e6)
