"""The port's torch-tensor API (plain versions on the CPU) against the JAX
package's API: each non-sparse case of tests/test_api.py, with the JAX
API's output at the same ``native=`` as the expected bytes and matrix
shape, decoding each other's archives. The split-size, device-resident
and temp-memory cases are in tests/test_torch_api_split.py."""

import ml_dtypes
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.api import codec as J
from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_torch.api import codec as C
from dietgpu_fork_torch.core.constants import FLOAT_ALIGN_MIN, FloatType
from dietgpu_fork_torch.models import ans as TA
from dietgpu_fork_torch.core.interop import (
    bytes_from_numpy,
    bytes_to_numpy,
    floats_from_words,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DTYPES = ["float16", "bfloat16", "float32", "float64"]
_TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32, "float64": torch.float64}


def normal(rng, n, dtype):
    """(numpy array for the JAX API, torch tensor with the same bits)."""
    x = rng.normal(0, 1, n)
    a = (x.astype(np.float32).astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
         else x.astype(dtype))
    u = {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize]
    return a, floats_from_words(a.view(u), _TORCH[dtype])


def same_bits(t: torch.Tensor, a: np.ndarray) -> bool:
    return np.array_equal(bytes_to_numpy(t.contiguous().view(torch.uint8)),
                          np.asarray(a).view(np.uint8).reshape(-1))


def assert_same_archives(comp, sizes, jcomp, jsizes):
    assert tuple(comp.shape) == tuple(np.asarray(jcomp).shape)
    assert np.array_equal(bytes_to_numpy(comp), np.asarray(jcomp))
    assert sizes.tolist() == np.asarray(jsizes).astype(np.int64).tolist()


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_float_compress_roundtrip(rng, dtype, native):
    pairs = [normal(rng, n, dtype) for n in (1000, 100, 4097)]
    ts = [t for _, t in pairs]
    comp, sizes, temp = C.compress_data(True, ts, checksum=True, native=native)
    jcomp, jsizes, jtemp = J.compress_data(True, [a for a, _ in pairs],
                                           checksum=True, native=native)
    assert_same_archives(comp, sizes, jcomp, jsizes)
    assert temp == jtemp > 0
    assert tuple(comp.shape) == C.max_float_compressed_output_size(ts)
    outs, out_sizes, success, status, dtemp = C.decompress_data(
        True, comp, [t.numel() for t in ts], dtype=ts[0].dtype, checksum=True)
    assert status.ok and bool(success.all())
    assert out_sizes.tolist() == [1000, 100, 4097]
    for t, o in zip(ts, outs):
        assert o.dtype == t.dtype and torch.equal(o.view(torch.uint8), t.view(torch.uint8))
    # the JAX API decodes the port's archives and the port the JAX API's
    jouts, *_, jdtemp = J.decompress_data(True, bytes_to_numpy(comp),
                                          [t.numel() for t in ts],
                                          dtype=pairs[0][0].dtype, checksum=True)
    assert dtemp == jdtemp
    for (a, _), o in zip(pairs, jouts):
        assert np.array_equal(o.view(np.uint8), a.view(np.uint8))
    outs, *_ = C.decompress_data(True, bytes_from_numpy(np.asarray(jcomp)),
                                 [t.numel() for t in ts], checksum=True)
    for t, o in zip(ts, outs):
        assert torch.equal(o.view(torch.uint8), t.view(torch.uint8))


@pytest.mark.parametrize("native", [False, True])
def test_raw_ans_roundtrip(rng, native):
    arrs = [rng.integers(0, 256, n, dtype=np.uint8) for n in (100, 65536)]
    ts = [torch.from_numpy(a.copy()) for a in arrs]
    comp, sizes, temp = C.compress_data(False, ts, checksum=True, native=native)
    jcomp, jsizes, jtemp = J.compress_data(False, arrs, checksum=True,
                                           native=native)
    assert_same_archives(comp, sizes, jcomp, jsizes)
    assert temp == jtemp and tuple(comp.shape) == C.max_any_compressed_output_size(ts)
    outs, _, success, status, dtemp = C.decompress_data(
        False, comp, [t.numel() for t in ts], checksum=True)
    assert status.ok and bool(success.all())
    assert dtemp == J.decompress_data(False, np.asarray(jcomp), [100, 65536])[4]
    for t, o in zip(ts, outs):
        assert torch.equal(o, t)


def test_compressed_archives_match_oracle(rng):
    a, t = normal(rng, 3000, "float32")
    arcs = C.compress_data_simple(True, [t], checksum=False, native=False)
    expect = R.float_compress(a.view(np.uint32), JFT.FLOAT32)
    assert np.array_equal(bytes_to_numpy(arcs[0]), expect)


def test_native_archives_match_oracle_and_autodetect(rng):
    pairs = [normal(rng, 3000, "float32"), normal(rng, 17000, "float32")]
    ts = [t for _, t in pairs]
    arcs = C.compress_data_simple(True, ts, checksum=True, native=True)
    for (a, _), arc in zip(pairs, arcs):
        expect = R.float_compress(a.view(np.uint32), JFT.FLOAT32,
                                  use_checksum=True, native=True)
        assert np.array_equal(bytes_to_numpy(arc), expect)
    outs, _, success, status, _ = C.decompress_data(
        True, arcs, [t.numel() for t in ts], dtype=torch.float32, checksum=True)
    assert status.ok and bool(success.all())
    for t, o in zip(ts, outs):
        assert torch.equal(o, t)
    # raw-ANS auto-detect, and the layout mix guard
    bs = [t.view(torch.uint8) for t in ts]
    comp_n, _, _ = C.compress_data(False, bs, native=True)
    assert C.detect_native_layout(False, comp_n)
    outs, _, success, _, _ = C.decompress_data(False, comp_n, [b.numel() for b in bs])
    assert bool(success.all())
    for b, o in zip(bs, outs):
        assert torch.equal(o, b)
    comp_c, _, _ = C.compress_data(False, bs, native=False)
    assert not C.detect_native_layout(False, comp_c)
    mixed = torch.cat([comp_n[:1], comp_c[1:]])
    with pytest.raises(ValueError, match="mixes"):
        C.decompress_data(False, mixed, [b.numel() for b in bs])


def test_default_layout_is_classic_on_the_cpu(rng):
    _, t = normal(rng, 5000, "bfloat16")
    comp, _, _ = C.compress_data(True, [t])
    assert not C.detect_native_layout(True, comp, float_type=FloatType.BFLOAT16)
    comp, _, _ = C.compress_data(False, [t.view(torch.uint8)])
    assert not C.detect_native_layout(False, comp)


def _layout_batch(rng, kind, layout):
    """(compress_as_float, sparse, capacities, archive matrix): two members
    of one kind of archive (bf16 "dense" v1, "dense_v2" with a v2 member,
    "sparse" bf16, "raw" ANS), native, classic, native with member 1
    overwritten by random bytes ("garbage"), or member 0 native and member
    1 classic ("mixed")."""
    flt, sparse = kind != "raw", kind == "sparse"
    sizes = (FLOAT_ALIGN_MIN + 100, 300) if kind == "dense_v2" else (3000, 700)
    ts = [normal(rng, n, "bfloat16")[1] for n in sizes]
    for t in ts if sparse else []:
        t[::2] = 0
    if not flt:
        ts = [t.view(torch.uint8) for t in ts]
    comp = {native: C.compress_data(flt, ts, sparse=sparse, native=native)[0]
            for native in (True, False)}
    m = comp[layout != "classic"].clone()
    if layout == "mixed":
        m[1] = comp[False][1]
    if layout == "garbage":
        m[1] = torch.from_numpy(rng.integers(0, 256, m.shape[1], dtype=np.uint8))
    return flt, sparse, [t.numel() for t in ts], m


# the model entry that reads the layout of each kind of archive
_LAYOUT_READER = {"dense": "float_decompress_core",
                  "dense_v2": "float_decompress_core",
                  "sparse": "sparse_float_decompress_core",
                  "raw": "ans_decode_padded"}


@pytest.mark.parametrize("kind,layout", [
    ("dense", "native"), ("dense", "classic"), ("dense", "garbage"),
    ("dense", "mixed"), ("dense_v2", "native"), ("dense_v2", "mixed"),
    ("sparse", "native"), ("sparse", "classic"), ("sparse", "garbage"),
    ("sparse", "mixed"), ("raw", "native"), ("raw", "classic"),
    ("raw", "garbage"), ("raw", "mixed"),
])
def test_decompress_takes_the_layout_detect_native_layout_reads(
        rng, monkeypatch, kind, layout):
    """decompress_data(native=None) decodes in the layout that
    detect_native_layout and the JAX package's read, a garbage member not
    voting; a batch that mixes layouts raises from the model's read,
    before any decode."""
    flt, sparse, caps, m = _layout_batch(rng, kind, layout)
    taken = []
    decode = TA._ans_decode

    def spy(*args, **kwargs):
        taken.append(args[5])  # native
        return decode(*args, **kwargs)

    monkeypatch.setattr(TA, "_ans_decode", spy)
    dtype = torch.bfloat16 if flt else None
    jft = JFT.BFLOAT16 if flt else None
    if layout == "mixed":
        with pytest.raises(ValueError, match="mixes") as e:
            C.decompress_data(flt, m, caps, dtype, sparse=sparse)
        names = [entry.name for entry in e.traceback]
        assert names[-1] == "read_layout" and _LAYOUT_READER[kind] in names
        assert taken == []
        with pytest.raises(ValueError, match="mixes"):
            C.detect_native_layout(flt, m, sparse)
        with pytest.raises(ValueError, match="mixes"):
            J.detect_native_layout(flt, bytes_to_numpy(m), sparse, jft)
        return
    want = layout != "classic"
    _, _, success, _, _ = C.decompress_data(flt, m, caps, dtype, sparse=sparse)
    assert set(taken) == {want}
    assert success.tolist() == [True, layout != "garbage"]
    assert C.detect_native_layout(flt, m, sparse) == want
    assert J.detect_native_layout(flt, bytes_to_numpy(m), sparse, jft) == want


def test_simple_roundtrip_and_shrinkage(rng):
    # compression actually shrinks on N(0,1) data (float_test.py:86-92)
    a, t = normal(rng, 1 << 16, "bfloat16")
    arcs = C.compress_data_simple(True, [t])
    jarcs = J.compress_data_simple(True, [a])
    assert np.array_equal(bytes_to_numpy(arcs[0]), jarcs[0])
    assert arcs[0].numel() < t.numel() * 2
    outs = C.decompress_data_simple(True, arcs)
    assert outs[0].dtype == torch.bfloat16
    assert torch.equal(outs[0].view(torch.int16), t.view(torch.int16))


def test_empty_tensor_header_only():
    t = torch.zeros(0, dtype=torch.float16)
    arcs = C.compress_data_simple(True, [t])
    assert np.array_equal(bytes_to_numpy(arcs[0]),
                          J.compress_data_simple(True, [np.zeros(0, np.float16)])[0])
    outs = C.decompress_data_simple(True, arcs)
    assert outs[0].numel() == 0 and outs[0].dtype == torch.float16


def test_truncated_to_reported_size_still_decodes(rng):
    # ans_test.py:21-26 truncates archives to the reported size before decode
    _, t = normal(rng, 5000, "float16")
    arcs = C.compress_data_simple(True, [t], checksum=True)
    outs = C.decompress_data_simple(True, arcs, checksum=True)
    assert torch.equal(outs[0].view(torch.int16), t.view(torch.int16))


@pytest.mark.parametrize("native", [False, True])
def test_checksum_mismatch_raises(rng, native):
    _, t = normal(rng, 2000, "float32")
    arcs = C.compress_data_simple(True, [t], checksum=True, native=native)
    arcs[0][40] ^= 0xFF
    with pytest.raises(RuntimeError, match="checksum"):
        C.decompress_data(True, arcs, [2000], dtype=t.dtype, checksum=True)
    raw = C.compress_data_simple(False, [t.view(torch.uint8)], checksum=True,
                                 native=native)
    raw[0][raw[0].numel() // 2] ^= 0x01  # a stream byte
    with pytest.raises(RuntimeError, match="checksum"):
        C.decompress_data(False, raw, [8000], checksum=True)


@pytest.mark.parametrize("native", [False, True])
def test_caller_supplied_histogram_matches_default(rng, native):
    arrs = [rng.integers(0, 100, n, dtype=np.uint8) for n in (5000, 12000)]
    ts = [torch.from_numpy(a.copy()) for a in arrs]
    hist = np.stack([np.bincount(a, minlength=256) for a in arrs]).astype(np.uint32)
    base, base_bytes, _ = C.compress_data(False, ts, native=native)
    given, given_bytes, _ = C.compress_data(False, ts, histogram=hist,
                                            native=native)
    assert torch.equal(base, given) and torch.equal(base_bytes, given_bytes)
    jgiven, jbytes, _ = J.compress_data(False, arrs, histogram=hist,
                                        native=native)
    assert_same_archives(given, given_bytes, jgiven, jbytes)
    with pytest.raises(ValueError):
        C.compress_data(True, [torch.zeros(8)], histogram=hist)


def test_sparse_and_bad_inputs_raise():
    t = torch.zeros(8)
    # the sparse codec takes what the dense one takes, and refuses the same
    with pytest.raises(ValueError, match="unsupported float dtype"):
        C.compress_data(True, [t.to(torch.int32)], sparse=True)
    with pytest.raises(ValueError, match="dtype"):
        C.compress_data(True, [t, t.to(torch.float16)], sparse=True)
    with pytest.raises(ValueError, match="empty"):
        C.compress_data(True, [], sparse=True)
    with pytest.raises(ValueError, match="empty"):
        C.compress_data(True, [])
    with pytest.raises(ValueError, match="dtype"):
        C.compress_data(True, [t, t.to(torch.float16)])
    with pytest.raises(ValueError):
        C.float_type_of(torch.int32)
    assert C.float_type_of(torch.bfloat16) == FloatType.BFLOAT16
    assert C.dtype_of(FloatType.FLOAT64) == torch.float64
