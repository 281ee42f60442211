"""Profiling hooks: a ``torch.profiler`` trace around a block (the
reference's profilerStart/Stop, ``utils/DeviceUtils.cpp:48-54``) and a
fenced best-of-N wall timer.

A port of the JAX package's ``utils/profiling.py``. Usage::

    from dietgpu_fork_torch.utils.profiling import trace, timed

    with trace("traces") as path:   # a Chrome trace written to path
        out = compress_data(...)

    ms = timed(lambda: compress_data(...))   # fenced, best-of-N ms

Unlike the JAX package's ``trace``, which turns into a no-op when the
profiler cannot start, this one raises.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str, *, host_tracer_level: int = 2):
    """Profile the body on the host and, where CUDA is available, on the
    card; write a Chrome trace into a new file of ``log_dir`` (made if
    missing) when the body ends, even by an exception. Yields the file's
    path. Raises if the profiler cannot start, and then makes no file.
    ``host_tracer_level`` is taken and unused, as in the JAX package, whose
    trace passes it nowhere either."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    path = None
    try:
        os.makedirs(log_dir, exist_ok=True)
        fd, path = tempfile.mkstemp(prefix="trace.", suffix=".json",
                                    dir=log_dir)
        os.close(fd)
        yield path
    finally:
        prof.stop()
        if path is not None:
            prof.export_chrome_trace(path)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def fence(x) -> None:
    """Wait until the work that makes ``x`` is done, as seen from the host:
    synchronise each CUDA device that holds a tensor of ``x`` (a tensor, or
    tuples, lists and dicts of them, nested); CPU tensors are done already."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def timed(fn: Callable[[], object], *, repeats: int = 5) -> float:
    """Best-of-N fenced wall time of ``fn`` in milliseconds, after one
    fenced warm-up call (dispatch overhead included): fn runs repeats + 1
    times."""
    fence(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fence(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3
