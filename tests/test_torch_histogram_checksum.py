"""K8's plain version (byte histogram + XOR checksum) and the port's
checksums vs the JAX package's histogram_batched, histogram_packed,
checksum_batched and checksum_packed, and vs its MXU histogram kernels run
in interpret mode (``DIETTPU_INTERPRET=1``), exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.ops import checksum as JC
from dietgpu_fork_tpu.ops import histogram as JH
from dietgpu_fork_torch.core.interop import bytes_from_numpy, rows_from_numpy
from dietgpu_fork_torch.ops import checksum as TC
from dietgpu_fork_torch.ops import histogram as TH
from dietgpu_fork_torch.ops.bitops import to_u32
from tests.conftest import make_exponential_bytes
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# (row bytes, member sizes): the oracle edge sizes, a size past the row
# (clipped) and multi-block rows
CASES = [
    (4100, [0, 1, 4095, 4096, 4097]),
    (3 * 4096 + 7, [3 * 4096 + 7, 2 * 4096 + 1, 5, 0]),
    (64, [64, 70, 17, 63]),
]


def _rows(seed, S, sizes, skewed):
    rng = np.random.default_rng(seed)
    if skewed:
        x = make_exponential_bytes(rng, len(sizes) * S, lam=8.0).reshape(-1, S)
    else:
        x = rng.integers(0, 256, (len(sizes), S), dtype=np.uint8)
    return x, np.array(sizes, np.int32)


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("S,sizes", CASES)
def test_histogram_batched_and_checksum_equal_jax(S, sizes, skewed):
    x, n = _rows(S, S, sizes, skewed)
    hist, csum = TH.byte_hist(bytes_from_numpy(x), torch.from_numpy(n))
    jn = jnp.asarray(np.minimum(n, S))
    want_h = JH.histogram_batched(jnp.asarray(x), jn)
    assert hist.dtype == torch.int32 and csum.dtype == torch.int32
    assert np.array_equal(hist.numpy(), np.asarray(want_h).astype(np.int32))
    assert np.array_equal(TH.histogram_batched(bytes_from_numpy(x), torch.from_numpy(n)),
                          hist)
    want_c = np.asarray(JC.checksum_batched(jnp.asarray(x), jn))
    assert np.array_equal(csum.numpy(), want_c.astype(np.int32))
    assert np.array_equal(TC.checksum_batched(bytes_from_numpy(x), torch.from_numpy(n)),
                          torch.from_numpy(want_c.astype(np.int64)))


@pytest.mark.parametrize("S,sizes", [c for c in CASES if c[0] % 4 == 0])
def test_histogram_and_checksum_packed_equal_jax(S, sizes):
    x, n = _rows(S + 1, S, sizes, True)
    x32 = x.view(np.uint32)
    jn = jnp.asarray(np.minimum(n, S))
    got = TH.histogram_packed(rows_from_numpy(x32), torch.from_numpy(n))
    want = JH.histogram_packed(jnp.asarray(x32), jn)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    got_c = TC.checksum_packed(to_u32(rows_from_numpy(x32)), torch.from_numpy(n))
    want_c = JC.checksum_packed(jnp.asarray(x32), jn)
    assert np.array_equal(got_c.numpy(), np.asarray(want_c).astype(np.int64))


@pytest.mark.parametrize("case", chip_smoke.HIST_EDGE_CASES)
def test_histogram_on_k8_edge_inputs_equals_jax(case):
    """chip_smoke.py's K8 edge inputs: rows of one byte value counted to
    65535, 65536 and 65537 bytes and two tiles, and a ragged batch of N(0,1)
    bf16 bytes with sizes and a row width that are no multiple of 16 (the
    last size past the row, clipped)."""
    rows, sizes = chip_smoke.hist_edge_inputs(case, torch.device("cpu"))
    x, n = rows.numpy(), sizes.numpy()
    jn = jnp.asarray(np.minimum(n, x.shape[1]))
    hist, csum = TH.byte_hist_plain(rows, sizes)
    want_h = np.asarray(JH.histogram_batched(jnp.asarray(x), jn)).astype(np.int32)
    want_c = np.asarray(JC.checksum_batched(jnp.asarray(x), jn)).astype(np.int32)
    assert np.array_equal(hist.numpy(), want_h)
    assert np.array_equal(csum.numpy(), want_c)
    if case == "ragged":
        assert x.shape[1] % 16 and (n % 16).any() and n[-1] > x.shape[1]
    else:
        assert (hist.numpy() > 0).sum(axis=1).tolist() == [1] * len(n)
        assert hist[:, int(case, 16)].tolist() == n.tolist()
    assert all(torch.equal(p, q)
               for p, q in zip(TH.byte_hist(rows, sizes), (hist, csum)))


def test_histograms_equal_the_mxu_kernels_in_interpret_mode(monkeypatch):
    """The Pallas kernels that K8 replaces, _hist_kernel and
    _hist_kernel_packed, in interpret mode on the CPU."""
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    from dietgpu_fork_tpu.ops.pallas.histogram_mxu import (
        histogram_mxu,
        histogram_mxu_packed,
    )

    S = 4096 + 512
    x, n = _rows(11, S, [S, 4097, 1, 0], True)
    got = TH.histogram_batched(bytes_from_numpy(x), torch.from_numpy(n))
    want = histogram_mxu(jnp.asarray(x), jnp.asarray(n))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    x32 = x.view(np.uint32)
    got = TH.histogram_packed(rows_from_numpy(x32), torch.from_numpy(n))
    want = histogram_mxu_packed(jnp.asarray(x32), jnp.asarray(n))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def test_byte_hist_dispatch_is_plain_on_cpu():
    x, n = _rows(3, 1000, [1000, 3], True)
    a = TH.byte_hist(bytes_from_numpy(x), torch.from_numpy(n))
    b = TH.byte_hist_plain(bytes_from_numpy(x), torch.from_numpy(n))
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_histogram_rejects_bad_arguments():
    x = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):
        TH.byte_hist(x.to(torch.int32), torch.zeros(2))
    with pytest.raises(TypeError):
        TH.byte_hist(x, torch.zeros(3))
    with pytest.raises(TypeError):
        TH.histogram_packed(x, torch.zeros(2))
    with pytest.raises(TypeError):
        TC.checksum_batched(x.to(torch.int32), torch.zeros(2))
