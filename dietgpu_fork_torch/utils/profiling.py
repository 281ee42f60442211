"""Profiling hooks: a ``torch.profiler`` trace around a block (the
reference's profilerStart/Stop, ``utils/DeviceUtils.cpp:48-54``), a fenced
best-of-N wall timer, and the spans the port records inside itself.

A port of the JAX package's ``utils/profiling.py``, with ``span`` added.
Usage::

    from dietgpu_fork_torch.utils.profiling import trace, timed

    with trace("traces") as path:   # a Chrome trace written to path
        out = compress_data(...)

    ms = timed(lambda: compress_data(...))   # fenced, best-of-N ms

Unlike the JAX package's ``trace``, which turns into a no-op when the
profiler cannot start, this one raises.

Spans. ``span(name)`` (and the decorator ``spanned(name)``) is a
``torch.profiler.record_function`` while a profiler runs on the calling
thread, and a shared no-op context otherwise: a running profiler is the one
switch, and this module is the one place in the port that reads it. The
spans land in the profiler's trace beside the device events, on the same
clock; nothing is counted in memory, a count is the number of spans of a
name in a trace. Names are ``<family>:<where>``:

* ``api:<function>``: the public entries of ``api/codec.py``
  (``compress_data``, ``compress_data_split_size``,
  ``compress_data_simple``, ``decompress_data``,
  ``decompress_data_split_size``, ``decompress_data_simple``,
  ``decompress_data_device``);
* ``model:<module>.<function>``: the model entries
  ``float_codec.float_compress_padded``, ``float_codec.float_compress_core``,
  ``float_codec.float_decompress_core``,
  ``sparse.sparse_float_compress_padded``,
  ``sparse.sparse_float_decompress_core``;
* ``kernel:<wrapper>``: each public kernel wrapper of
  ``runtime/cuda_kernels.py``, by its function name;
* ``parallel:<function>``: the compressed collectives of
  ``parallel/collectives.py`` (``compressed_all_gather``,
  ``compressed_reduce_scatter``, ``compressed_all_reduce``,
  ``compressed_ppermute``);
* ``stage:<module>.<stage>``: the stages of the paths, where they run:
  ``api.pack_rows``, ``api.outputs``, ``api.status``;
  ``float_codec.split``, ``ans.table``, ``ans.encode``, ``ans.runs``,
  ``float_codec.assemble`` (compress); ``float_codec.header``,
  ``ans.parse``, ``ans.decode``, ``float_codec.join``,
  ``float_codec.verify`` (decompress); ``sparse.bitmap``, ``sparse.ranks``,
  ``sparse.compact``, ``sparse.assemble``, ``sparse.header``,
  ``sparse.expand`` (the sparse codec); ``parallel.encode``,
  ``parallel.sizes``, ``parallel.transfer``, ``parallel.decode``,
  ``parallel.output`` (the compressed collectives);
* ``sync:<module>.<site>``: each statement that blocks the host on the
  device on a CUDA tensor (a read to the host, or a copy of host data to
  the device):

  - ``api.row_sizes``: ``_pack_byte_rows``, the members' byte counts;
  - ``api.float_counts``: ``compress_data``, the members' float counts;
  - ``api.histogram``: ``compress_data``, caller histograms to the device;
  - ``api.split_sizes``: ``pack_split_rows``, the split sizes and offsets;
  - ``api.simple_sizes``: ``compress_data_simple`` and
    ``decompress_data_simple``, the sizes read to the host;
  - ``api.caps``: ``_decode_rows``, the output capacities;
  - ``api.status``: ``_checksum_status``, success and both checksums;
  - ``api.sizes``: ``decompress_data`` and ``decompress_data_split_size``,
    the sizes and success read to the host;
  - ``api.concat_runs``: ``_ragged_concat``, the merge's runs and seams;
  - ``float_codec.count_check``: ``float_compress_core``, the float counts
    checked against the rows;
  - ``float_codec.merge_refs``: ``float_compress_core``, the merge's fixed
    sources;
  - ``float_codec.float_type``: ``archive_float_type``, member 0's float
    header (``dtype=None``);
  - ``sparse.count_check``: ``sparse_float_compress_core``, the same check;
  - ``sparse.merge_refs``: ``sparse_float_compress_core``, the merge's
    sources;
  - ``sparse.merge_strides``: ``sparse_float_compress_core``, the sources'
    strides;
  - ``ans.run_refs``: ``ans_encode_sections``, the runs' source indices;
  - ``ans.layout``: ``read_layout``, the archives' ANS magics (``native=None``
    on decompress, under ``float_codec.header`` or ``sparse.header`` for
    floats);
  - ``parallel.sizes``: ``_gather_chunked`` and ``_permute_chunked``, the
    gathered size headers, with the rank's own flag, read to the host;
  - ``table.target``: ``normalize_probs_batched``, 2^prob_bits as float32;
  - ``table.normalize_round``: ``normalize_probs_batched``, each test of
    the loop that takes the excess off (its rounds + 1 a table build).
    Both on the plain path only (CPU tensors, ``plain=True``): on a CUDA
    tensor K17 builds the table with no read to the host.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from typing import Callable

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler span named ``name`` while a profiler runs on this thread,
    else a shared no-op context (one check, nothing built)."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return decorate


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
