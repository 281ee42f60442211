"""The per-layer readers on a synthetic trace of a collective cell's calls
(``ranks.py``): each ``bench.allgather`` call is a round trip, the
program's work is what lies inside the calls (they enter no ``api:``
span), and the word between the calls counts nowhere."""

import pytest

from bench_torch import harness, program_spans, tracing
from bench_torch.tests.test_program_spans import X, dev, rt, ua

NCCL = "ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)"


def call(at, corr):
    """One call at ``at``: compress (model, stage, a kernel, a sync), the
    exchange (a launch outside the models, an NCCL kernel), decode."""
    return [
        ua("bench.allgather", at, at + 100),
        ua("model:float_codec.float_compress_core", at + 1, at + 40),
        ua("stage:ans.encode", at + 2, at + 20),
        ua("kernel:encode_blocks", at + 3, at + 10),
        rt("cudaLaunchKernel", at + 4, at + 5, corr=corr),
        rt("cudaLaunchKernel", at + 12, at + 13, corr=corr + 1),
        ua("sync:float_codec.count_check", at + 30, at + 38),
        rt("cudaStreamSynchronize", at + 31, at + 37),
        rt("cudaLaunchKernel", at + 45, at + 46, corr=corr + 2),
        ua("model:float_codec.float_decompress_core", at + 60, at + 90),
        ua("sync:ans.layout", at + 62, at + 66),
        rt("cudaLaunchKernel", at + 70, at + 71, corr=corr + 3),
        rt("cudaDeviceSynchronize", at + 92, at + 99),
        dev("(anonymous namespace)::rans_encode_blocks_kernel", at + 6, at + 16, corr),
        dev("void at::native::vectorized_elementwise_kernel", at + 14, at + 18, corr + 1),
        dev(NCCL, at + 47, at + 57, corr + 2),
        dev("(anonymous namespace)::decode_kernel<1>", at + 72, at + 80, corr + 3),
    ]


# two calls, and the word before each: an all-reduce outside the calls
EVENTS = (
    [rt("cudaLaunchKernel", 0, 1, corr=90), dev(NCCL, 1, 3, 90)] + call(10, 1)
    + [rt("cudaLaunchKernel", 112, 113, corr=91), dev(NCCL, 113, 115, 91)] + call(120, 11)
)


@pytest.fixture
def t():
    return tracing.TracedSlice(EVENTS)


def test_each_collective_call_is_a_round_trip(t):
    assert t.roundtrips == 2 and len(t.calls["allgather"]) == 2
    assert t.calls["compress"] == t.calls["decompress"] == []


@pytest.mark.parametrize("metric,value", [
    # four launches inside each call; the words' all-reduces outside
    ("host_launches_per_roundtrip", 4),
    # count_check and the layout read, no api: span around them
    ("host_syncs_per_roundtrip", 2),
    # the launch inside ans.encode's model span and the decode's; the
    # kernel wrapper's and the exchange's are not the models'
    ("model_launches_per_roundtrip", 2),
    # compress 1-40 less the kernel 3-10 and the sync 30-38; decode 60-90
    # less the sync 62-66
    ("model_host_ms.roundtrip", (39 - 7 - 8 + 30 - 4) / 1e3),
    # device busy 6-18, 47-57 and 72-80 of each call's 100
    ("idle_share.roundtrip", 100 * (1 - 30 / 100)),
    ("nccl_device_ms.allgather", 10 / 1e3),
    ("codec_device_ms.allgather", (10 + 4 + 8) / 1e3),
])
def test_each_reader_a_collective_cell_lists_reads_its_calls(t, metric, value):
    assert harness._reader(metric)(t) == pytest.approx(value)


def test_the_api_readers_read_nothing_of_a_collective(t):
    assert t.api_host_ms("roundtrip") is None
    assert program_spans.launches_per_roundtrip(t, "api:") == 0
    assert program_spans.sync_coverage(t)["runtime_syncs"] == 0


def test_a_trace_without_the_programs_spans_reads_nothing():
    bare = [e for e in EVENTS if not e["name"].startswith(("stage:", "sync:"))]
    t = tracing.TracedSlice(bare)
    assert program_spans.host_syncs_per_roundtrip(t) is None
    assert program_spans.model_host_ms(t, "roundtrip") is None
