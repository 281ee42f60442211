"""The port's profiling hooks (``dietgpu_fork_torch.utils.profiling``) on the
CPU: the trace is written, the timer calls its function repeats + 1 times,
and the fence takes nested CPU outputs."""

import json
import math

import pytest
import torch

from dietgpu_fork_torch.utils import profiling
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "traces"
    with profiling.trace(str(log_dir)) as path:
        torch.ones(64).cumsum(0)
    files = list(log_dir.iterdir())
    assert [str(p) for p in files] == [path]
    assert "traceEvents" in json.loads(files[0].read_text())


def test_trace_is_written_when_the_body_raises(tmp_path):
    with pytest.raises(RuntimeError, match="body"):
        with profiling.trace(str(tmp_path)):
            raise RuntimeError("body")
    assert len(list(tmp_path.iterdir())) == 1


def test_trace_raises_and_makes_no_file_when_the_profiler_cannot_start(
        tmp_path, monkeypatch):
    def refuse(self):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    with pytest.raises(RuntimeError, match="no profiler"):
        with profiling.trace(str(tmp_path)):
            pass
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("level", [1, 2, 3])
def test_trace_takes_the_jax_host_tracer_level(tmp_path, level):
    with profiling.trace(str(tmp_path), host_tracer_level=level) as path:
        torch.ones(8) + 1
    assert [str(p) for p in tmp_path.iterdir()] == [path]


def test_two_traces_write_two_files(tmp_path):
    for _ in range(2):
        with profiling.trace(str(tmp_path)):
            torch.ones(8) + 1
    assert len(list(tmp_path.iterdir())) == 2


@pytest.mark.parametrize("repeats", [1, 5])
def test_timed_calls_fn_repeats_plus_one_times(repeats):
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(4) * 2

    ms = profiling.timed(fn, repeats=repeats)
    assert len(calls) == repeats + 1
    assert math.isfinite(ms) and ms > 0


@pytest.mark.parametrize(
    "x",
    [torch.ones(2), (torch.ones(2), [torch.zeros(1), (torch.ones(3),)]),
     {"a": [torch.ones(1)], "b": 3}, [], None, 7],
)
def test_fence_accepts_nested_cpu_outputs(x):
    assert profiling.fence(x) is None
