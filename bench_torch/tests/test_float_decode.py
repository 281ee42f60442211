"""The float decode's readers (``float_decode_device_ms.decompress``,
``float_decode_roofline.decompress``) on hand-made traces of one fp32
round trip: a two-pass decode (K6 in ``stage:ans.decode``, then K7 in
``stage:float_codec.join``) and a fused one (K12 in ``stage:ans.decode``),
each with the K8 verify and a select outside those stages."""

import pytest

from bench_torch import harness, rooflines, tracing


def X(cat, name, ts, end, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid,
         "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def ua(name, ts, end):
    return X("user_annotation", name, ts, end)


def launch(ts, corr):
    return X("cuda_runtime", "cudaLaunchKernel", ts, ts + 0.5, corr)


def dev(name, ts, end, corr):
    return X("kernel", name, ts, end, corr, tid=7)


# compress: one K5 launch, which no decode reader reads
COMPRESS = [
    ua("bench.compress", 0, 100),
    ua("api.compress_data", 1, 90),
    ua("api:compress_data", 1.5, 89.5),
    ua("stage:float_codec.split", 10, 20),
    ua("kernel:split_wide_hist", 11, 19),
    launch(12, 1),
    dev("split_wide_hist_kernel<4>", 20, 40, 1),
]


def decompress(fused: bool):
    """The decompress of a round trip, from 100 to 200: the decode's
    kernels from 150, the select at 175-178 and K8 at 180-185."""
    ev = [
        ua("bench.decompress", 100, 200),
        ua("api.decompress_data", 101, 190),
        ua("api:decompress_data", 101.5, 189.5),
        ua("model:float_codec.float_decompress_core", 110, 170),
        ua("stage:ans.parse", 111, 130),
        launch(112, 10),
        dev("void at::native::index_kernel", 140, 145, 10),
        ua("stage:ans.decode", 131, 140),
        launch(134, 11),
        launch(160, 14),
        ua("stage:float_codec.verify", 162, 168),
        ua("kernel:byte_hist", 163, 167),
        launch(164, 15),
        dev("void at::native::where_kernel", 175, 178, 14),
        dev("(anonymous namespace)::byte_hist_kernel<false>", 180, 185, 15),
    ]
    if fused:
        ev += [ua("kernel:decode_join32", 132, 139),
               dev("(anonymous namespace)::rans_decode_kernel<2, true>", 150, 166, 11)]
    else:
        ev += [ua("kernel:decode_rows", 132, 139),
               dev("(anonymous namespace)::rans_decode_kernel<0, true>", 150, 156, 11),
               ua("stage:float_codec.join", 141, 150),
               ua("kernel:join_wide_at", 142, 149),
               launch(143, 12),
               dev("(anonymous namespace)::join_kernel<4>", 156, 166, 12)]
    return ev


# the bytes each decode launch needs: 8 us of the bound for K6, 6 for K7,
# 10 for K12 (rooflines.HBM_BYTES_PER_S a second)
B = rooflines.HBM_BYTES_PER_S * 1e-6
BYTES = {
    False: {"compress": {"split_wide_hist": int(15 * B)},
            "decompress": {"decode_rows": int(3 * B), "join_wide_at": int(6 * B),
                           "byte_hist": int(4 * B)}},
    True: {"compress": {"split_wide_hist": int(15 * B)},
           "decompress": {"decode_join32": int(10 * B), "byte_hist": int(4 * B)}},
}


def sliced(fused: bool, spans: bool = True):
    ev = COMPRESS + decompress(fused)
    if not spans:  # a program that records none of its own spans
        ev = [e for e in ev if not e["name"].startswith(("api:", "stage:"))]
    calls = {d: {w: 1 for w in BYTES[fused][d]} for d in BYTES[fused]}
    return tracing.TracedSlice(ev, BYTES[fused], calls)


@pytest.mark.parametrize("fused,ms", [(False, 16e-3), (True, 16e-3)])
def test_decode_device_ms_reads_the_decode_and_join_stages(fused, ms):
    # two-pass: K6 6 us + K7 10 us; fused: K12 16 us; the select, K8 and
    # the parse's gather lie outside both stages
    read = harness._reader("float_decode_device_ms.decompress")
    assert read(sliced(fused)) == pytest.approx(ms)


@pytest.mark.parametrize("fused,share", [(False, 100 * 9 / 16), (True, 100 * 10 / 16)])
def test_decode_roofline_reads_the_decode_wrappers_alone(fused, share):
    # two-pass: (3 + 6) us of bound over 6 + 10 us; fused: 10 over 16;
    # K8's byte_hist and the compress's K5 left out
    read = harness._reader("float_decode_roofline.decompress")
    assert read(sliced(fused)) == pytest.approx(share, rel=1e-6)


def test_decode_readers_tell_the_formulations_apart():
    two, one = sliced(False), sliced(True)
    assert set(two.kernel_time_us("decompress")) == {"decode_rows", "join_wide_at", "byte_hist"}
    assert set(one.kernel_time_us("decompress")) == {"decode_join32", "byte_hist"}


@pytest.mark.parametrize("fused", [False, True])
def test_without_the_programs_spans_the_device_ms_reads_nothing(fused):
    # a program without stage spans: None, and no exception; the roofline
    # reads the benchmark's own kernel spans, so it reads alike
    t = sliced(fused, spans=False)
    assert harness._reader("float_decode_device_ms.decompress")(t) is None
    assert harness._reader("float_decode_roofline.decompress")(t) == \
        harness._reader("float_decode_roofline.decompress")(sliced(fused))


def test_no_decode_launch_reads_nothing():
    ev = [e for e in COMPRESS + decompress(False) if "decode" not in e["name"]
          and "join" not in e["name"]]
    t = tracing.TracedSlice(ev, BYTES[False], {})
    assert harness._reader("float_decode_roofline.decompress")(t) is None
