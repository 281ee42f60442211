"""The readings of the program's own spans (``program_spans.py``) on a
synthetic trace, and every older reader unchanged by those spans."""

import pytest

from bench_torch import harness, program_spans, tracing


def X(cat, name, ts, end, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid,
         "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def ua(name, ts, end):
    return X("user_annotation", name, ts, end)


def rt(name, ts, end, corr=None):
    return X("cuda_runtime", name, ts, end, corr)


def dev(name, ts, end, corr, cat="kernel"):
    return X(cat, name, ts, end, corr, tid=7)


# what the benchmark records around a program that records no span: one
# round trip, the spans of the harness and of tracing.instrument()
BENCH = [
    ua("bench.compress", 0, 100),
    ua("api.compress_data", 1, 90),
    X("cpu_op", "aten::zeros", 2, 9),
    rt("cudaLaunchKernel", 3, 4, corr=1),
    ua("model:float_codec.float_compress_padded", 10, 60),
    ua("kernel:encode_rows", 12, 20),
    rt("cudaLaunchKernel", 13, 14, corr=2),
    rt("cudaMemcpyAsync", 40, 55, corr=3),
    rt("cudaStreamSynchronize", 56, 58),
    rt("cudaStreamSynchronize", 70, 80, corr=4),
    rt("cudaDeviceSynchronize", 91, 99, corr=7),
    ua("bench.decompress", 100, 200),
    ua("api.decompress_data", 101, 190),
    ua("model:sparse.sparse_float_decompress_core", 105, 180),
    rt("cudaLaunchKernel", 106, 107, corr=5),
    ua("model:float_codec.float_decompress_core", 140, 170),
    ua("kernel:decode_rows", 141, 150),
    rt("cudaLaunchKernel", 142, 143, corr=6),
    rt("cudaStreamSynchronize", 183, 187),
    dev("void at::native::vectorized_elementwise_kernel<FillFunctor>", 20, 25, 1),
    dev("(anonymous namespace)::rans_encode_kernel<false>", 30, 50, 2),
    dev("Memcpy DtoH (Device -> Pageable)", 52, 54, 3, cat="gpu_memcpy"),
    dev("void at::native::index_kernel", 110, 130, 5),
    dev("(anonymous namespace)::decode_kernel<0>", 150, 160, 6),
]
# the program's own spans inside those
PROGRAM = [
    ua("api:compress_data", 1.5, 89.5),
    ua("stage:api.pack_rows", 2, 9.5),
    ua("model:float_codec.float_compress_padded", 10.5, 59.5),
    ua("model:float_codec.float_compress_core", 11, 59),
    ua("stage:ans.encode", 11.5, 21),
    ua("kernel:encode_rows", 12.5, 19.5),
    ua("sync:table.target", 30, 31),
    ua("sync:float_codec.count_check", 39, 59),
    ua("sync:api.sizes", 69, 81),
    ua("api:decompress_data", 101.5, 189.5),
    ua("model:sparse.sparse_float_decompress_core", 105.5, 179.5),
    ua("stage:sparse.header", 105.8, 108),
    ua("model:float_codec.float_decompress_core", 140.5, 169.5),
    ua("stage:ans.decode", 140.8, 151),
    ua("kernel:decode_rows", 141.2, 149.8),
    ua("sync:api.sizes", 182, 188),
    ua("sync:api.sizes", 182.5, 187.5),
]
BYTES = {"compress": {"encode_rows": int(3.35e12 * 10e-6)},
         "decompress": {"decode_rows": int(3.35e12 * 5e-6)}}
CALLS = {"compress": {"encode_rows": 1}, "decompress": {"decode_rows": 1}}


@pytest.fixture
def t():
    return tracing.TracedSlice(BENCH + PROGRAM, BYTES, CALLS)


@pytest.fixture
def parent():
    return tracing.TracedSlice(BENCH, BYTES, CALLS)


def test_sync_spans_inside_the_api_count_once_a_round_trip(t):
    # count_check, table.target and two api.sizes, the nested one once
    assert program_spans.host_syncs_per_roundtrip(t) == 4


def test_launches_go_to_their_innermost_api_model_or_kernel_span(t):
    assert program_spans.launches_by_family(t) == {"api:": 1, "model:": 2, "kernel:": 2}
    assert program_spans.launches_per_roundtrip(t, "api:") == 1
    assert program_spans.launches_per_roundtrip(t, "model:") == 2


def test_the_families_add_up_to_every_launch(t):
    fam = program_spans.launches_by_family(t)
    assert None not in fam
    assert sum(fam.values()) / t.roundtrips == t.launches_per_roundtrip()


def test_model_host_time_leaves_out_kernel_and_sync_spans(t):
    # compress: the model spans cover 10-60 once; kernel 12-20 and the
    # syncs 30-31 and 39-59 inside it
    assert program_spans.model_host_ms(t, "compress") == pytest.approx((50 - 8 - 21) / 1e3)
    # decompress: 105-180 once, the kernel 141-150; api.sizes lies outside
    assert program_spans.model_host_ms(t, "decompress") == pytest.approx((75 - 9) / 1e3)
    assert program_spans.model_host_ms(t, "roundtrip") == pytest.approx((21 + 66) / 1e3)


@pytest.mark.parametrize("metric,value", [
    ("host_syncs_per_roundtrip", 4), ("api_launches_per_roundtrip", 1),
    ("model_launches_per_roundtrip", 2), ("model_host_ms.compress", 0.021),
    ("model_host_ms.decompress", 0.066), ("model_host_ms.roundtrip", 0.087),
])
def test_each_new_reader_is_found_by_name_and_reads_its_value(t, parent, metric, value):
    read = harness._reader(metric)
    assert read(t) == pytest.approx(value)
    # a program that records no span reads nothing, and raises nothing
    assert read(parent) is None


def test_nothing_is_read_where_no_device_op_ran():
    cpu = [e for e in BENCH + PROGRAM if e["tid"] != 7]
    t = tracing.TracedSlice(cpu, BYTES, CALLS)
    assert program_spans.host_syncs_per_roundtrip(t) is None
    assert program_spans.launches_per_roundtrip(t, "api:") is None
    assert program_spans.model_host_ms(t, "compress") is None
    assert program_spans.sync_coverage(t) is None and program_spans.by_stage(t) == {}


@pytest.mark.parametrize("reading", [
    lambda t: t.api_host_ms("compress"),
    lambda t: t.api_host_ms("decompress"),
    lambda t: t.api_host_ms("roundtrip"),
    lambda t: t.device_ms("compress", "model:sparse.", "model:float_codec."),
    lambda t: t.device_ms("decompress", "model:sparse.", "model:float_codec."),
    lambda t: t.launches_per_roundtrip(),
    lambda t: t.kernel_time_us("compress"),
    lambda t: t.kernel_time_us("decompress"),
    lambda t: t.kernels_roofline("compress"),
    lambda t: t.kernels_roofline("decompress"),
    lambda t: t.idle_share("compress"),
    lambda t: t.idle_share("decompress"),
    lambda t: t.idle_share("roundtrip"),
    lambda t: t.busy_s(),
])
def test_every_older_reading_is_the_same_with_the_programs_spans(t, parent, reading):
    assert reading(t) == reading(parent)


def test_every_older_reader_file_reads_the_same(t, parent):
    for p in sorted((harness.HERE / "metrics").glob("*.py")):
        read = harness._reader(p.stem)
        if read(parent) is not None:
            assert read(t) == read(parent), p.stem


def test_sync_coverage_finds_waits_outside_sync_spans_and_empty_ones(t):
    # the three waits inside the API lie in sync spans; the harness's
    # synchronise at 91-99 lies outside the API; table.target holds none
    assert program_spans.sync_coverage(t) == {
        "runtime_syncs": 3, "covered": 3, "sync_spans": 4,
        "empty": [("sync:table.target", 1)]}


def test_idle_and_launches_by_stage(t):
    rows = program_spans.by_stage(t)
    assert rows["stage:api.pack_rows"]["compress.launches"] == 1
    assert rows["stage:ans.encode"]["compress.launches"] == 1
    assert rows["model:float_codec.float_compress_core"]["compress.launches"] == 1
    assert rows["stage:sparse.header"]["decompress.launches"] == 1
    assert rows["stage:ans.decode"]["decompress.launches"] == 1
    # the gap 0-20 before the fill: 11.5-20 inside ans.encode, 2-9.5 in
    # pack_rows; 25-30, 50-52 and 54-59 inside float_compress_core
    assert rows["stage:ans.encode"]["compress.idle_ms"] == pytest.approx(8.5e-3)
    assert rows["stage:api.pack_rows"]["compress.idle_ms"] == pytest.approx(7.5e-3)
    assert rows["model:float_codec.float_compress_core"]["compress.idle_ms"] == \
        pytest.approx(12.5e-3)
    for d, busy in (("compress", 27), ("decompress", 30)):
        idle = sum(r.get(d + ".idle_ms", 0) for r in rows.values())
        assert idle == pytest.approx((100 - busy) / 1e3)
