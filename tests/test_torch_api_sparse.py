"""The port's API with ``sparse=True`` (plain versions on the CPU) against
the JAX package's API and the NumPy oracle: archive bytes and matrix
shapes for the four float types in both layouts, the simple entry points
with mixed member sizes, the device-resident decompress, layout detection,
a corrupted dense part refused by its checksum, and the sparse size
helpers."""

import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.api import codec as J
from dietgpu_fork_tpu.core import constants as JC
from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_torch.api import codec as C
from dietgpu_fork_torch.core import constants as TC
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import (
    bytes_from_numpy,
    bytes_to_numpy,
    floats_from_words,
)
from tests.test_torch_api import DTYPES, _TORCH, assert_same_archives, normal
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def sparse_normal(rng, n, dtype, zeros):
    """(numpy array for the JAX API, torch tensor with the same bits), a
    share ``zeros`` of the values exact +0.0."""
    a, _ = normal(rng, n, dtype)
    a[rng.random(n) < zeros] = 0
    u = {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize]
    return a, floats_from_words(a.view(u), _TORCH[dtype])


def same_floats(o: torch.Tensor, t: torch.Tensor) -> bool:
    return o.dtype == t.dtype and torch.equal(o.view(torch.uint8),
                                              t.view(torch.uint8))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_compress_data_equals_jax_api(rng, dtype, native):
    pairs = [sparse_normal(rng, n, dtype, z)
             for n, z in ((1000, 0.5), (100, 0.0), (4097, 0.9), (64, 1.0))]
    ts = [t for _, t in pairs]
    caps = [t.numel() for t in ts]
    comp, sizes, temp = C.compress_data(True, ts, checksum=True, sparse=True,
                                        native=native)
    jcomp, jsizes, jtemp = J.compress_data(True, [a for a, _ in pairs],
                                           checksum=True, sparse=True,
                                           native=native)
    assert_same_archives(comp, sizes, jcomp, jsizes)
    assert temp == jtemp > 0
    assert comp.shape[1] == C.max_sparse_float_compressed_size(
        C.float_type_of(ts[0]), max(caps))
    outs, out_sizes, success, status, dtemp = C.decompress_data(
        True, comp, caps, dtype=ts[0].dtype, checksum=True, sparse=True)
    assert status.ok and bool(success.all()) and out_sizes.tolist() == caps
    assert all(same_floats(o, t) for o, t in zip(outs, ts))
    # the JAX API decodes the port's archives and the port the JAX API's
    jouts, *_, jdtemp = J.decompress_data(
        True, bytes_to_numpy(comp), caps, dtype=pairs[0][0].dtype,
        checksum=True, sparse=True)
    assert dtemp == jdtemp
    for (a, _), o in zip(pairs, jouts):
        assert np.array_equal(o.view(np.uint8), a.view(np.uint8))
    # with no dtype, the type comes from the dense header past the bitmap
    outs, *_ = C.decompress_data(True, bytes_from_numpy(np.asarray(jcomp)),
                                 caps, checksum=True, sparse=True)
    assert all(same_floats(o, t) for o, t in zip(outs, ts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_simple_mixed_sizes(rng, dtype):
    # tests/test_api.py:240-280: the dense header's offset differs per
    # member, so decompress_data_simple computes it per member
    pairs = [sparse_normal(rng, n, dtype, 0.5) for n in (10000, 257, 40000)]
    ts = [t for _, t in pairs]
    arcs = C.compress_data_simple(True, ts, sparse=True)
    jarcs = J.compress_data_simple(True, [a for a, _ in pairs], sparse=True)
    for (a, _), arc, jarc in zip(pairs, arcs, jarcs):
        assert np.array_equal(bytes_to_numpy(arc), jarc)
        u = np.uint32 if dtype == "float32" else np.uint16
        expect = R.sparse_float_compress(a.view(u), JFT[dtype.upper()])
        assert np.array_equal(bytes_to_numpy(arc), expect)
    outs = C.decompress_data_simple(True, arcs, sparse=True)
    assert all(same_floats(o, t) for o, t in zip(outs, ts))
    jouts = J.decompress_data_simple(True, [bytes_to_numpy(a) for a in arcs],
                                     sparse=True)
    for (a, _), o in zip(pairs, jouts):
        assert np.array_equal(o.view(np.uint8), a.view(np.uint8))


def test_sparse_decompress_data_device(rng):
    pairs = [sparse_normal(rng, n, "float32", 0.5) for n in (5000, 12345)]
    ts = [t for _, t in pairs]
    comp, _, _ = C.compress_data(True, ts, sparse=True)
    words, nsz, succ = C.decompress_data_device(
        True, comp, out_capacity=12345, dtype=torch.float32, sparse=True)
    assert isinstance(words, torch.Tensor) and words.shape == (2, 12345)
    assert nsz.tolist() == [5000, 12345] and bool(succ.all())
    host = words.view(torch.uint8)
    for i, t in enumerate(ts):
        assert torch.equal(host[i, : t.numel() * 4], t.view(torch.uint8))
        assert not bool(host[i, t.numel() * 4:].any())  # zero padding


def test_sparse_detect_native_layout(rng):
    ts = [sparse_normal(rng, n, "float16", 0.5)[1] for n in (3000, 70000)]
    comp_n, _, _ = C.compress_data(True, ts, sparse=True, native=True)
    comp_c, _, _ = C.compress_data(True, ts, sparse=True, native=False)
    assert C.detect_native_layout(True, comp_n, sparse=True)
    assert not C.detect_native_layout(True, comp_c, sparse=True,
                                      float_type=FloatType.FLOAT16)
    jn = J.detect_native_layout(True, bytes_to_numpy(comp_n), True,
                                JFT.FLOAT16)
    assert jn
    mixed = torch.cat([comp_n[:1], comp_c[1:]])
    with pytest.raises(ValueError, match="mixes"):
        C.decompress_data(True, mixed, [3000, 70000], sparse=True)


@pytest.mark.parametrize("native", [False, True])
def test_sparse_checksum_mismatch_raises(rng, native):
    _, t = sparse_normal(rng, 2000, "float32", 0.5)
    arcs = C.compress_data_simple(True, [t], checksum=True, sparse=True,
                                  native=native)
    dense = 16 + TC.sparse_bitmap_bytes(2000)
    arcs[0][dense + 40] ^= 0xFF  # a raw-section byte of the dense part
    with pytest.raises(RuntimeError, match="checksum"):
        C.decompress_data(True, arcs, [2000], dtype=t.dtype, checksum=True,
                          sparse=True)


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 127, 128, 4097, 1 << 20])
def test_sparse_size_helpers_equal_jax(size):
    assert TC.SPARSE_HEADER_BYTES == JC.SPARSE_HEADER_BYTES
    assert TC.sparse_bitmap_bytes(size) == JC.sparse_bitmap_bytes(size)
    for ft in (1, 2, 3, 4):
        assert C.max_sparse_float_compressed_size(FloatType(ft), size) == (
            J.max_sparse_float_compressed_size(JFT(ft), size))
