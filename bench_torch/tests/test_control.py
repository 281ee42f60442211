"""The control and each fault a cell can have, driven through the rest of a
run at a small size on the CPU: each must come out not correct, and a
sound run correct."""

import json
import shutil
import time

import pytest
import torch

from bench_torch import control, harness

SMALL = {"members": 3, "floats": 3000, "pool_min_bytes": 50000, "pool_min_batches": 2,
         "warmup_roundtrips": 1, "sample_roundtrips": 2, "trace_roundtrips": 2}
CELLS = ["float_bf16.single123m", "sparse_fp64.b5x15m"]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return small_spec(tmp_path_factory.mktemp("small"), SMALL)


def small_spec(root, mix):
    """BENCHMARK.json and its configurations beside every traffic mix cut
    to ``mix``."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(harness.HERE / "configs", root / "bench_torch" / "configs")
    (root / "bench_torch" / "traffic").mkdir()
    for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]:
        (root / "bench_torch" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
    return root / "BENCHMARK.json"


def run(spec, cell, wrap, seed=2**31 + 11, seconds=0.2, trace=False):
    return harness.run(cell, seed, seconds, trace, device=torch.device("cpu"),
                       t_start=time.perf_counter(), wrap=wrap, spec_path=spec,
                       log=lambda m: None)


def compared(out):
    return {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(spec, cell):
    out = run(spec, cell, None)
    assert out["correct"] and out["attempted"] >= 2
    assert set(compared(out).values()) == {0}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(spec, cell):
    out = run(spec, cell, control.Lowered)
    c = compared(out)
    assert not out["correct"]
    assert c["output_bad_floats"] > 1000 and c["archive_bad_floats"] > 1000


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_every_fault_is_not_correct(spec, cell, fault):
    out = run(spec, cell, control.FAULTS[fault])
    assert not out["correct"], compared(out)


def test_half_of_a_batch_of_one(tmp_path):
    spec = small_spec(tmp_path, {**SMALL, "members": 1})
    assert not run(spec, "float_bf16.single123m", control.HalfBatch)["correct"]


def test_a_run_reports_its_cells_metrics_and_no_others(spec):
    # on the CPU codec_mem_mib is not measured, and no device op is traced
    assert set(run(spec, "float_bf16.batch128", None)["metrics"]) == {
        "roundtrip_p95_ms", "setup_s"}
    assert set(run(spec, "sparse_fp64.b3x1m", None)["metrics"]) == {
        "compress_gbps", "decompress_gbps", "roundtrip_p95_ms", "setup_s"}
    out = run(spec, "float_bf16.batch128", None, seed=7, seconds=0, trace=True)
    assert out["correct"] and set(out["metrics"]) == {"api_host_ms.roundtrip"}
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
