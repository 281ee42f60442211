import pytest

from bench_torch import rooflines, tracing


def X(cat, name, ts, end, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid,
         "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def ua(name, ts, end):
    return X("user_annotation", name, ts, end)


def dev(name, ts, end, corr, cat="kernel"):
    return X(cat, name, ts, end, corr, tid=7)


EVENTS = [
    ua("bench.compress", 0, 100),
    ua("api.compress_data", 1, 90),
    X("cpu_op", "aten::zeros", 2, 10),
    X("cuda_runtime", "cudaLaunchKernel", 3, 4, corr=1),
    ua("model:float_codec.float_compress_padded", 10, 60),
    ua("kernel:encode_rows", 12, 20),
    X("cuda_runtime", "cudaLaunchKernel", 13, 14, corr=2),
    X("cuda_runtime", "cudaMemcpyAsync", 40, 55, corr=3),
    X("cuda_runtime", "cudaStreamSynchronize", 70, 80, corr=4),
    X("cuda_runtime", "cudaDeviceSynchronize", 91, 99, corr=7),
    ua("bench.decompress", 100, 200),
    ua("api.decompress_data", 101, 190),
    ua("model:sparse.sparse_float_decompress_core", 105, 180),
    X("cuda_runtime", "cudaLaunchKernel", 106, 107, corr=5),
    ua("model:float_codec.float_decompress_core", 140, 170),
    ua("kernel:decode_rows", 141, 150),
    X("cuda_runtime", "cudaLaunchKernel", 142, 143, corr=6),
    dev("void at::native::vectorized_elementwise_kernel<FillFunctor>", 20, 25, 1),
    dev("(anonymous namespace)::rans_encode_kernel<false>", 30, 50, 2),
    dev("Memcpy DtoH (Device -> Pageable)", 52, 54, 3, cat="gpu_memcpy"),
    dev("void at::native::index_kernel", 110, 130, 5),
    dev("(anonymous namespace)::decode_kernel<0>", 150, 160, 6),
    X("gpu_user_annotation", "bench.compress", 20, 54, tid=7),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 3, "id": 1, "pid": 1, "tid": 1},
]
BYTES = {"compress": {"encode_rows": int(3.35e12 * 10e-6)},
         "decompress": {"decode_rows": int(3.35e12 * 5e-6)}}
CALLS = {"compress": {"encode_rows": 1}, "decompress": {"decode_rows": 1}}


@pytest.fixture
def t():
    return tracing.TracedSlice(EVENTS, BYTES, CALLS)


def test_api_host_time_leaves_out_models_and_waits(t):
    assert t.api_host_ms("compress") == pytest.approx((89 - 50 - 10) / 1e3)
    assert t.api_host_ms("decompress") == pytest.approx((89 - 75) / 1e3)


def test_sparse_device_time_leaves_out_the_float_codec(t):
    assert t.device_ms("decompress", "model:sparse.", "model:float_codec.") == pytest.approx(0.020)
    assert t.device_ms("compress", "model:sparse.", "model:float_codec.") is None


def test_launches_count_kernels_copies_and_fills_per_round_trip(t):
    assert t.roundtrips == 1
    assert t.launches_per_roundtrip() == 5


def test_roofline_is_the_bound_over_the_kernels_own_time(t):
    assert t.kernel_time_us("compress") == {"encode_rows": 20}
    assert t.kernels_roofline("compress") == pytest.approx(50.0)
    assert t.kernels_roofline("decompress") == pytest.approx(50.0)
    assert [r[:3] for r in t.kernel_shares()] == [
        ("compress", "encode_rows", 1), ("decompress", "decode_rows", 1)]


def test_idle_share_and_busy_time_from_the_union_of_device_ops(t):
    assert t.idle_share("compress") == pytest.approx(100 * (1 - 27 / 100))
    assert t.idle_share("decompress") == pytest.approx(100 * (1 - 30 / 100))
    assert t.busy_s() == pytest.approx(57e-6)
    assert t.window() == (0, 200)


def test_breakdown_names_device_ops_and_what_the_host_did_in_each_gap(t):
    b = t.breakdown()
    assert {k for k, v in b["device_ops"][:2]} == {
        "void at::native::index_kernel", "(anonymous namespace)::rans_encode_kernel<false>"}
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    idle = dict(b["idle_gaps"])
    # the compress window's last gap, 54-100: its middle lies in the API's
    # synchronise
    assert idle["cudaStreamSynchronize"] == pytest.approx(46e-6)
    assert sum(idle.values()) == pytest.approx((200 - 57) / 1e6)


def test_readers_are_found_by_name_and_read_the_slice(t):
    from bench_torch import harness
    assert harness._reader("idle_share.compress")(t) == t.idle_share("compress")
    assert harness._reader("kernels_roofline.decompress")(t) == pytest.approx(50.0)


def test_nothing_to_read_gives_nothing():
    empty = tracing.TracedSlice([ua("bench.compress", 0, 1), ua("bench.decompress", 1, 2)])
    assert empty.kernels_roofline("compress") is None
    assert empty.idle_share("compress") is None
    assert empty.launches_per_roundtrip() is None
    assert empty.api_host_ms("compress") is None


def test_every_kernel_wrapper_has_a_count():
    import dietgpu_fork_torch.runtime.cuda_kernels as K
    assert set(rooflines.WRAPPERS) == set(K.launches) - {
        "rans_encode_rows", "rans_encode_blocks", "rans_decode_rows", "rans_decode_blocks",
        "rans_decode_join16", "rans_decode_join16_blocks", "rans_decode_join32",
        "rans_decode_join32_blocks", "bitmap_pack", "sparse_compact", "sparse_expand",
        "join16"} | {"encode_rows", "encode_blocks", "decode_rows", "decode_blocks",
                     "decode_join16", "decode_join16_blocks", "decode_join32",
                     "decode_join32_blocks", "pack_bitmap", "compact_by_bitmap",
                     "expand_by_bitmap", "join16_rows"}
    assert all(callable(getattr(K, w)) for w in rooflines.WRAPPERS)


def test_a_round_trip_takes_both_calls(t):
    assert t.api_host_ms("roundtrip") == pytest.approx(t.api_host_ms("compress")
                                                       + t.api_host_ms("decompress"))
    assert t.idle_share("roundtrip") == pytest.approx(100 * (1 - 57 / 200))


@pytest.mark.parametrize("module,attr", [
    ("dietgpu_fork_torch.models.sparse", "float_compress_core"),
    ("dietgpu_fork_torch.api.codec", "sparse_float_decompress_core"),
    (tracing.KERNELS_MODULE, "encode_rows"),
])
def test_a_renamed_entry_or_wrapper_stops_the_traced_run(monkeypatch, module, attr):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.delattr(mod, attr)
    K = importlib.import_module(tracing.KERNELS_MODULE)
    before = {w: getattr(K, w, None) for w in rooflines.WRAPPERS}
    with pytest.raises(AttributeError, match=attr):
        tracing.instrument()
    assert {w: getattr(K, w, None) for w in rooflines.WRAPPERS} == before
    if module == tracing.KERNELS_MODULE:
        with pytest.raises(AttributeError, match=attr):
            tracing.ByteRecorder()


def test_instrument_wraps_every_entry_and_puts_it_back():
    import importlib
    K = importlib.import_module(tracing.KERNELS_MODULE)
    fn = K.encode_rows
    with tracing.instrument():
        assert K.encode_rows is not fn and K.encode_rows.__wrapped__ is fn
    assert K.encode_rows is fn
