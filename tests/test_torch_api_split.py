"""The port's split-size and device-resident API entries and its
temp-memory estimates (plain versions on the CPU) against the JAX
package's API: the split-size cases of tests/test_api.py, the JAX API's
archives as the expected bytes, one contiguous output tensor per call."""

import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.api import codec as J
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.runtime import stack_memory as JSM
from dietgpu_fork_torch.api import codec as C
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import bytes_to_numpy
from dietgpu_fork_torch.runtime import stack_memory as TSM
from tests.test_torch_api import assert_same_archives, normal, same_bits
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("native", [None, True])
def test_split_size_float(rng, native):
    splits = [1000, 777, 4096]
    a, x = normal(rng, sum(splits), "float32")
    comp, sizes, temp = C.compress_data_split_size(True, x, splits, native=native)
    jcomp, jsizes, jtemp = J.compress_data_split_size(True, a, splits,
                                                      native=native)
    assert_same_archives(comp, sizes, jcomp, jsizes)
    assert temp == jtemp
    out, out_sizes, success, status, _ = C.decompress_data_split_size(
        True, comp, splits, dtype=x.dtype)
    assert bool(success.all()) and out_sizes.tolist() == splits
    assert torch.equal(out, x)


def test_split_size_native_autodetect(rng):
    splits = [1000, 777, 4096]
    _, x = normal(rng, sum(splits), "float32")
    comp, _, _ = C.compress_data_split_size(True, x, splits, native=True)
    out, _, success, _, _ = C.decompress_data_split_size(True, comp, splits)
    assert bool(success.all()) and torch.equal(out, x)
    xb = torch.from_numpy(rng.integers(0, 256, 10000, dtype=np.uint8))
    comp, _, _ = C.compress_data_split_size(False, xb, [400, 9600], native=True)
    out, _, success, _, _ = C.decompress_data_split_size(False, comp, [400, 9600])
    assert bool(success.all()) and torch.equal(out, xb)


@pytest.mark.parametrize("dtype,splits", [
    ("float16", [1001, 3, 777, 4096]),  # odd counts: seam words
    ("bfloat16", [5, 1, 9000]),
    ("float32", [1000, 777, 4096]),
    ("float64", [513, 2048]),
])
def test_split_size_decompress_is_one_tensor(rng, dtype, splits):
    """decompress_data_split_size returns ONE contiguous tensor on the
    archives' device (DietGpu.cpp:685-825), float64 as a real float64."""
    a, x = normal(rng, sum(splits), dtype)
    comp, _, _ = C.compress_data_split_size(True, x, splits)
    jcomp, _, _ = J.compress_data_split_size(True, a, splits)
    assert np.array_equal(bytes_to_numpy(comp), np.asarray(jcomp))
    out, _, success, _, _ = C.decompress_data_split_size(True, comp, splits,
                                                         dtype=x.dtype)
    assert bool(success.all()) and out.device == x.device
    assert out.dtype == x.dtype and out.is_contiguous() and out.shape == x.shape
    assert same_bits(out, a)


def test_split_size_raw_one_tensor_and_size_mismatch(rng):
    xb = rng.integers(0, 256, 10003, dtype=np.uint8)
    comp, _, _ = C.compress_data_split_size(False, torch.from_numpy(xb),
                                            [400, 8192, 1411])
    jcomp, _, _ = J.compress_data_split_size(False, xb, [400, 8192, 1411])
    assert np.array_equal(bytes_to_numpy(comp), np.asarray(jcomp))
    out, _, success, _, _ = C.decompress_data_split_size(False, comp,
                                                         [400, 8192, 1411])
    assert bool(success.all()) and np.array_equal(bytes_to_numpy(out), xb)
    with pytest.raises(RuntimeError, match="decoded size"):
        C.decompress_data_split_size(False, comp, [400, 8192, 1412])


def test_split_size_raw_alignment_enforced(rng):
    x = torch.from_numpy(rng.integers(0, 256, 1000, dtype=np.uint8))
    with pytest.raises(ValueError, match="4-byte aligned"):
        C.compress_data_split_size(False, x, [3, 997])
    comp, _, _ = C.compress_data_split_size(False, x, [400, 600])
    with pytest.raises(ValueError, match="4-byte aligned"):
        C.decompress_data_split_size(False, comp, [3, 997])
    out, _, success, _, _ = C.decompress_data_split_size(False, comp, [400, 600])
    assert bool(success.all()) and torch.equal(out, x)


def test_decompress_data_device_keeps_rows_on_device(rng):
    pairs = [normal(rng, n, "float32") for n in (5000, 12345)]
    ts = [t for _, t in pairs]
    comp, _, _ = C.compress_data(True, ts)
    words, nsz, succ = C.decompress_data_device(True, comp, out_capacity=12345,
                                                dtype=torch.float32)
    jwords, jnsz, _ = J.decompress_data_device(
        True, bytes_to_numpy(comp), out_capacity=12345, dtype=np.float32)
    assert words.device == comp.device and nsz.device == comp.device
    assert nsz.tolist() == [5000, 12345] and bool(succ.all())
    assert np.array_equal(words.numpy().view(np.uint32), np.asarray(jwords))
    host = words.view(torch.uint8)
    for i, t in enumerate(ts):
        assert torch.equal(host[i, : 4 * t.numel()], t.view(torch.uint8))
        assert not host[i, 4 * t.numel():].any()  # zero padding


@pytest.mark.parametrize("case", [
    (128, 512 * 1024, None), (1, 1 << 20, FloatType.FLOAT64),
    (7, 4097, FloatType.BFLOAT16), (3, 1000, FloatType.FLOAT32),
])
def test_temp_memory_equals_jax(case):
    B, n, ft = case
    for pb in (9, 10, 11):
        assert TSM.ans_decode_temp_size(B, pb) == JSM.ans_decode_temp_size(B, pb)
    assert TSM.ans_encode_temp_size(B, n) == JSM.ans_encode_temp_size(B, n)
    assert (TSM.ans_encode_temp_size(B, n, True)
            == JSM.ans_encode_temp_size(B, n, True))
    if ft is not None:
        jft = JFT(int(ft))
        assert (TSM.float_compress_temp_size(B, n, ft)
                == JSM.float_compress_temp_size(B, n, jft))
        assert (TSM.float_decompress_temp_size(B, n, ft, 10)
                == JSM.float_decompress_temp_size(B, n, jft, 10))
    est = TSM.StackMemoryEstimator()
    est.alloc(1000)   # -> 1024 (256 B aligned)
    est.alloc(2000)   # -> 2048
    est.free()
    est.alloc(500)    # -> 512
    assert est.high == 3072 and est.cur == 1536
