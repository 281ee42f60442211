"""The spans the port records inside itself (``utils/profiling.span``) on
the CPU: the names a round trip emits and how they nest, nothing built with
the profiler off, the same bytes either way, and the names the benchmark
reads."""

import contextlib
import json
import re
from pathlib import Path

import pytest
import torch

import dietgpu_fork_torch.api.codec as C
from dietgpu_fork_torch.utils import profiling
from tests.test_torch_threads import one_torch_thread  # noqa: F401

PKG = Path(profiling.__file__).resolve().parent.parent

DENSE_COMPRESS = {
    "api:compress_data", "model:float_codec.float_compress_padded",
    "model:float_codec.float_compress_core", "stage:api.pack_rows",
    "stage:float_codec.split", "stage:ans.encode", "stage:ans.table",
    "stage:ans.runs", "stage:float_codec.assemble", "sync:api.row_sizes",
    "sync:api.float_counts", "sync:float_codec.count_check", "sync:table.target",
    "sync:table.normalize_round", "sync:ans.run_refs", "sync:float_codec.merge_refs",
}
DENSE_DECOMPRESS = {
    "api:decompress_data", "model:float_codec.float_decompress_core",
    "stage:float_codec.header", "sync:ans.layout", "stage:ans.parse",
    "stage:ans.decode", "stage:api.outputs", "sync:api.caps", "sync:api.sizes",
}
SPARSE_COMPRESS = (DENSE_COMPRESS - {"model:float_codec.float_compress_padded"}) | {
    "model:sparse.sparse_float_compress_padded", "stage:sparse.bitmap",
    "stage:sparse.ranks", "stage:sparse.compact", "stage:sparse.assemble",
    "sync:sparse.count_check", "sync:sparse.merge_refs", "sync:sparse.merge_strides",
}
SPARSE_DECOMPRESS = DENSE_DECOMPRESS | {
    "model:sparse.sparse_float_decompress_core", "stage:sparse.header",
    "stage:sparse.ranks", "stage:sparse.expand", "stage:float_codec.join",
    "stage:float_codec.verify", "stage:api.status", "sync:api.status",
}
# (dtype, sparse, checksum, the spans of compress, of decompress)
CASES = {
    "bf16_dense": (torch.bfloat16, False, False, DENSE_COMPRESS, DENSE_DECOMPRESS),
    "fp64_sparse_checksum": (torch.float64, True, True, SPARSE_COMPRESS,
                             SPARSE_DECOMPRESS),
}


def _batch(dtype, sparse):
    g = torch.Generator().manual_seed(5)
    ts = [torch.randn(n, generator=g).to(dtype) for n in (5000, 1, 70000)]
    if sparse:
        for t in ts:
            t[::2] = 0
    return ts


def _roundtrip(case):
    dtype, sparse, checksum, _, _ = CASES[case]
    ts = _batch(dtype, sparse)
    comp, sizes, _ = C.compress_data(True, ts, checksum, 10, sparse)
    outs, _, success, status, _ = C.decompress_data(
        True, comp, [t.numel() for t in ts], dtype, checksum, 10, sparse)
    assert bool(success.all()) and status.ok
    assert all(torch.equal(o, t) for o, t in zip(outs, ts))
    return comp, sizes, outs


def _traced(tmp_path, case):
    with profiling.trace(str(tmp_path)) as path:
        out = _roundtrip(case)
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return out, spans


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_round_trip_emits_each_paths_spans(tmp_path, case):
    _, spans = _traced(tmp_path, case)
    want_c, want_d = CASES[case][3:]
    api = {s["name"]: s for s in spans if s["name"].startswith("api:")}
    assert set(api) == {"api:compress_data", "api:decompress_data"}
    got = {d: {s["name"] for s in spans if _inside(s, api["api:" + d + "_data"])}
           for d in ("compress", "decompress")}
    assert got == {"compress": want_c, "decompress": want_d}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_api_model_stage(tmp_path, case):
    _, spans = _traced(tmp_path, case)
    by = {f: [s for s in spans if s["name"].startswith(f + ":")]
          for f in ("api", "model", "stage", "sync")}
    for s in by["model"] + by["stage"] + by["sync"]:
        assert any(_inside(s, a) for a in by["api"]), s["name"]
    for s in by["stage"]:
        in_model = any(_inside(s, m) for m in by["model"])
        # the API's stages run outside the models, every other stage inside
        assert in_model == (not s["name"].startswith("stage:api.")), s["name"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_layout_is_read_under_the_models_header(tmp_path, case):
    _, spans = _traced(tmp_path, case)
    header = "stage:sparse.header" if CASES[case][1] else "stage:float_codec.header"
    reads = [s for s in spans if s["name"] == "sync:ans.layout"]
    assert len(reads) == 1
    assert any(_inside(reads[0], s) for s in spans if s["name"] == header)


def test_the_table_build_tests_its_loop_once_a_round(tmp_path):
    _, spans = _traced(tmp_path, "bf16_dense")
    tables = [s for s in spans if s["name"] == "stage:ans.table"]
    rounds = [s for s in spans if s["name"] == "sync:table.normalize_round"]
    assert len(tables) == 1 and len(rounds) >= 1
    assert all(_inside(r, tables[0]) for r in rounds)


@pytest.mark.parametrize("case", sorted(CASES))
def test_with_the_profiler_off_no_span_is_built(monkeypatch, case):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with the profiler off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    _roundtrip(case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_same_bytes_with_the_profiler_on_and_off(tmp_path, case):
    (comp_on, sizes_on, outs_on), _ = _traced(tmp_path, case)
    comp, sizes, outs = _roundtrip(case)
    assert torch.equal(comp_on, comp) and torch.equal(sizes_on, sizes)
    assert len(outs_on) == len(outs)
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(outs_on, outs))


def test_span_is_one_shared_no_op_with_the_profiler_off():
    assert profiling.span("a:b") is profiling.span("c:d")
    with profiling.span("a:b"):
        pass


def test_spanned_keeps_the_function_and_records_its_span():
    @profiling.spanned("stage:test.fn")
    def fn(x, y=1):
        """doc"""
        return x + y

    assert fn.__name__ == "fn" and fn.__doc__ == "doc" and fn(1, y=2) == 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        fn(1)
    assert "stage:test.fn" in {e.key for e in p.key_averages()}


@contextlib.contextmanager
def _span_names():
    """The names ``span`` is asked for while open, with nothing recorded."""
    names = []

    def note(name):
        names.append(name)
        return contextlib.nullcontext()

    real, profiling.span = profiling.span, note
    try:
        yield names
    finally:
        profiling.span = real


def test_model_and_kernel_spans_carry_the_benchmarks_names():
    import importlib

    from bench_torch import rooflines, tracing

    entries = [(m, a, s) for m, a, s in tracing.MODEL_ENTRIES]
    entries += [(tracing.KERNELS_MODULE, w, "kernel:" + w) for w in rooflines.WRAPPERS]
    for module, attr, want in entries:
        fn = getattr(importlib.import_module(module), attr)
        with _span_names() as names:
            with pytest.raises((TypeError, ValueError)):
                fn()  # the span opens, then the call fails on its arguments
        assert names == [want], (module, attr)


def _sources(sub=""):
    return sorted((PKG / sub).rglob("*.py"))


def test_the_profilers_state_is_read_in_one_place():
    readers = {p.relative_to(PKG).as_posix() for p in _sources()
               if re.search(r"_profiler_enabled|record_function", p.read_text())}
    assert readers == {"utils/profiling.py"}
    # the parallel layer records its spans through the same helper
    assert [p.name for p in _sources("parallel") if "span" in p.read_text()] == [
        "collectives.py"]
    assert "from ..utils.profiling import span, spanned" in (
        PKG / "parallel" / "collectives.py").read_text()


def test_every_sync_site_is_listed_in_the_helpers_docstring():
    used = set()
    for p in _sources():
        used |= set(re.findall(r'span\("sync:([\w.]+)"\)', p.read_text()))
    listed = set(re.findall(r"``([a-z_]+\.[a-z_]+)``:", profiling.__doc__))
    assert used and used == listed
