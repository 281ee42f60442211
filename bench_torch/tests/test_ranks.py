"""The rank runner of collective cells (``ranks.py``), driven over gloo on
the CPU at worlds of 1, 2 and 4 on small buckets: a sound run is correct
and reports the cell's end-to-end metrics with one device a rank; the
control and every fault the all-gather can have come out not correct.
Each run has a deadline of its own, so that a hung rank fails the test
instead of stalling the suite. The cell, ``collective_bf16.allgather4``
(``configs/collective_bf16.json``, ``traffic/allgather4.json``), is not in
``BENCHMARK.json``; the tests add it to a copy of the spec, with its
metrics, as a PR that lands it would."""

import json
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from bench_torch import control, harness, ranks, traffic
from bench_torch.tests.test_control import small_spec

CELL = "collective_bf16.allgather4"
SMALL = {"members": 1, "floats": 65536, "pool_min_bytes": 0, "pool_min_batches": 4,
         "warmup_roundtrips": 1, "sample_roundtrips": 2, "trace_roundtrips": 2}
DEADLINE_S = 150
ONE_CHIP_E2E = {
    "float_bf16.single123m": {"compress_gbps", "decompress_gbps", "roundtrip_p95_ms",
                              "codec_mem_mib", "setup_s"},
    "float_bf16.batch128": {"roundtrip_p95_ms", "codec_mem_mib", "setup_s"},
    "sparse_fp64.b5x15m": {"compress_gbps", "decompress_gbps", "roundtrip_p95_ms",
                           "codec_mem_mib", "setup_s"},
    "sparse_fp64.b3x1m": {"compress_gbps", "decompress_gbps", "roundtrip_p95_ms",
                          "codec_mem_mib", "setup_s"},
    "float_fp32.single123m": {"compress_gbps", "decompress_gbps", "roundtrip_p95_ms",
                              "codec_mem_mib", "setup_s"},
}

# per-layer metrics a one-chip cell reports
ONE_CHIP_PER_LAYER = {"float_bf16.single123m": 14, "sparse_fp64.b5x15m": 14,
                      "float_bf16.batch128": 7, "sparse_fp64.b3x1m": 12,
                      "float_fp32.single123m": 14}


# the entries that land the cell in BENCHMARK.json
ROUNDTRIP_READERS = ("host_launches_per_roundtrip", "host_syncs_per_roundtrip",
                     "model_launches_per_roundtrip", "model_host_ms.roundtrip",
                     "idle_share.roundtrip")
ENTRIES = {
    "configs": [{"name": "collective_bf16", "file": "bench_torch/configs/collective_bf16.json",
                 "reduced": []}],
    "workloads": [{"name": CELL, "config": "collective_bf16", "traffic": "allgather4",
                   "chips": 4}],
    "end_to_end": [{"name": "allgather_gbps", "unit": "GB/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": [CELL]}],
    "per_layer": [{"name": name, "unit": "ms", "better": "lower", "source": "device_trace",
                   "layer": layer, "moves": "allgather_gbps", "workloads": [CELL]}
                  for name, layer in (("nccl_device_ms.allgather", "parallel"),
                                      ("codec_device_ms.allgather", "kernels"))],
}


def with_collective(path):
    """The spec at ``path`` with the collective cell and its metrics."""
    spec = json.loads(path.read_text())
    for key, entries in ENTRIES.items():
        spec[key] += entries
    for m in spec["per_layer"]:
        if m["name"] in ROUNDTRIP_READERS:
            m["workloads"].append(CELL)
    path.write_text(json.dumps(spec))
    return path


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    path = with_collective(small_spec(tmp_path_factory.mktemp("small"), SMALL))
    (path.parent / "bench_torch" / "traffic" / "allgather4.json").write_text(json.dumps(SMALL))
    return path


def run(spec, world, codec=None, seed=2**31 + 23, seconds=0.3, trace=False):
    return ranks.run(CELL, seed, seconds, trace, world=world, backend="gloo",
                     device_type="cpu", t_start=time.perf_counter(), spec_path=spec,
                     codec=codec, deadline_s=DEADLINE_S)


def compared(out):
    return {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_a_sound_run_is_correct(spec, world):
    out = run(spec, world)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert set(compared(out).values()) == {0}
    # on the CPU codec_mem_mib is not measured
    assert set(out["metrics"]) == {"roundtrip_p95_ms", "allgather_gbps", "setup_s"}
    assert out["device"]["count"] == world and out["device"]["platform"] == "cpu"
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_a_traced_run_is_correct_and_gives_the_device_keys(spec):
    out = run(spec, 2, seconds=0, trace=True)
    assert out["correct"] and out["attempted"] == 1 + SMALL["trace_roundtrips"]
    # no device op runs on the CPU, so no per-layer reader finds anything
    assert out["metrics"] == {}
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out


def test_the_control_is_not_correct(spec):
    c = compared(run(spec, 2, control.LoweredGather))
    assert c["output_bad_floats"] > 1000 and c["archive_bad_floats"] > 1000


@pytest.mark.parametrize("fault", sorted(control.GATHER_FAULTS))
def test_every_fault_is_not_correct(spec, fault):
    out = run(spec, 2, control.GATHER_FAULTS[fault])
    assert not out["correct"], compared(out)


def test_a_rank_that_fails_ends_the_run(spec):
    with pytest.raises(Exception):
        ranks.run(CELL, 1, 0.1, False, world=2, backend="gloo", device_type="cpu",
                  t_start=time.perf_counter(), spec_path=spec.parent / "missing.json",
                  deadline_s=DEADLINE_S)


class RaisesOnRankOne(ranks.Gather):
    """Rank 1's second call raises before the exchange, where its peer
    waits for it."""

    calls = 0

    def gather(self, bucket):
        self.calls += 1
        if dist.get_rank() == 1 and self.calls == 2:
            raise RuntimeError("planted")
        return super().gather(bucket)


def test_a_call_that_raises_ends_every_rank_at_once(spec, capfd):
    t0 = time.monotonic()
    with pytest.raises(Exception):
        run(spec, 2, RaisesOnRankOne)
    assert time.monotonic() - t0 < DEADLINE_S / 2
    assert "RuntimeError: planted" in capfd.readouterr().err


def test_a_call_is_timed_from_the_start_rank_zero_names(spec, tmp_path):
    cell, config, mix, _, _ = harness.load_cell(CELL, spec)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    r = ranks.RankRun(config, mix, 3, 0, 1, torch.device("cpu"))
    try:
        before = ranks.now()
        start = r.go_on(True)
        assert before < start <= ranks.now() + ranks.START_LEAD_S
        # a rank that waits for the start: the wait does not count
        ahead = ranks.now() + 0.05
        r.call(ahead)
        assert r.late == [0.0] and 0 < r.times[0] < ranks.now() - ahead + 1e-3
        # a rank that reaches a call after its start: the delay counts
        late = ranks.now() - 0.05
        r.call(late)
        assert r.late[1] >= 0.05 and r.times[1] >= r.late[1]
        assert r.go_on(False) is None
    finally:
        r.codec.close()
        dist.destroy_process_group()


def test_every_rank_makes_every_ranks_bucket_alike(spec):
    cell, config, mix, _, _ = harness.load_cell(CELL, spec)
    a = ranks.RankRun(config, mix, 5, 0, 2, torch.device("cpu"))
    b = ranks.RankRun(config, mix, 5, 1, 2, torch.device("cpu"))
    try:
        assert all(torch.equal(x.view(torch.int16), y.view(torch.int16))
                   for pa, pb in zip(a.expected(), b.expected()) for x, y in zip(pa, pb))
        assert not torch.equal(a.buckets[0], b.buckets[0])
    finally:
        a.codec.close()
        b.codec.close()


def test_one_chip_cells_keep_their_metrics():
    for name, e2e in ONE_CHIP_E2E.items():
        cell, config, mix, mine, layer = harness.load_cell(name)
        assert cell["chips"] == 1 and "collective" not in config
        assert {m["name"] for m in mine} == e2e
        assert len(layer) == ONE_CHIP_PER_LAYER[name]
        assert "allgather_gbps" not in {m["name"] for m in mine}
        assert not [m for m in layer if m["name"].endswith(".allgather")]


def test_the_collective_cell_reports_its_metrics(spec):
    cell, config, mix, e2e, layer = harness.load_cell(CELL, spec)
    assert cell["chips"] == 4 and config["collective"] in ranks.COLLECTIVES
    assert {m["name"] for m in e2e} == {"roundtrip_p95_ms", "allgather_gbps",
                                        "codec_mem_mib", "setup_s"}
    assert {m["name"] for m in layer} == set(ROUNDTRIP_READERS) | {
        "nccl_device_ms.allgather", "codec_device_ms.allgather"}
    assert all(m["moves"] in {x["name"] for x in e2e} for m in layer)
    # its data files are those of the repo, the traffic as it would run
    full = traffic.load(harness.HERE / "traffic" / "allgather4.json")
    assert full["floats"] * 4 == 5 * 10**7 and traffic.pool_batches(config, full) == 8


def test_run_without_the_cards_exits_2_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload", "float_bf16.batch128",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 2 and res.stdout == ""
