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


# K8's checksum-only form (``checksum_rows``). Row widths in bytes of the
# rows it reads in place: a 16-bit decode's words32 rows at out_floats 13
# (4 ceil(13 / 2) = 28, no multiple of 16), fp32's 4E and fp64's 8E words
# at E = 4 (64 and 128), and a raw ANS output row at capacity 45, a view
# 48 bytes apart.
CSUM_WIDTHS = {"16bit": (28, 28), "fp32": (64, 64), "fp64": (128, 128),
               "raw": (45, 48)}
CSUM_SIZES = (0, 1, 15, 16, 17, "full")


class _K8Route:
    """Stands in for ``cuda_kernels.byte_hist``: holds the checksum-only
    call's arguments to its contract, records the call and answers with
    the plain fold; the histogram form goes to the plain version."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        if len(args) == 2:
            return TH.byte_hist_plain(*args)
        rows, sizes, hist = args
        assert hist is False and rows.dtype == torch.uint8
        assert sizes.dtype == torch.int64
        assert int(sizes.min()) >= 0 and int(sizes.max()) <= rows.shape[1]
        self.calls.append((rows.data_ptr(), rows.stride()))
        return None, TC.checksum_batched(rows, sizes)


@pytest.fixture
def k8_route(monkeypatch):
    """Sends ``checksum_rows`` down its kernel route on the CPU."""
    from dietgpu_fork_torch.runtime import cuda_kernels as K

    route = _K8Route()
    monkeypatch.setattr(TH, "use_kernels", lambda t: True)
    monkeypatch.setattr(K, "byte_hist", route)
    return route


def _csum_rows(seed, width):
    W, stride = CSUM_WIDTHS[width]
    x = np.random.default_rng(seed).integers(0, 256, (3, stride), dtype=np.uint8)
    return bytes_from_numpy(x)[:, :W], W


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("size", CSUM_SIZES)
@pytest.mark.parametrize("width", list(CSUM_WIDTHS))
def test_checksum_rows_equals_the_folds(request, width, size, route):
    rows, W = _csum_rows(len(width), width)
    s = W if size == "full" else size
    sizes = torch.tensor([s, W + 9, min(s, 3)], dtype=torch.int64)
    if route == "kernel":
        k8 = request.getfixturevalue("k8_route")
    got = TH.checksum_rows(rows, sizes)
    assert got.dtype == torch.int64
    assert torch.equal(got, TC.checksum_batched(rows, sizes))
    if W % 4 == 0:
        assert torch.equal(got, TC.checksum_packed(
            to_u32(rows.contiguous().view(torch.int32)), sizes))
    if route == "kernel":
        # one launch, on the rows in place: no copy, no padding
        assert k8.calls == [(rows.data_ptr(), rows.stride())]


@pytest.mark.parametrize("plain", [True, False])
@pytest.mark.parametrize("ft", [1, 2, 3, 4])
def test_failed_member_checksums_to_zero(ft, plain):
    from dietgpu_fork_torch.core.constants import FloatType
    from dietgpu_fork_torch.models import float_codec as FC
    from tests.conftest import make_float_words

    n = 300
    rng = np.random.default_rng(ft)
    ftype = FloatType(ft)
    words = [make_float_words(rng, ftype, n) for _ in range(2)]
    ws = words[0].itemsize
    x = np.zeros((2, -(-n * ws // 16) * 4), np.uint32)
    for i, w in enumerate(words):
        x[i].view(np.uint8)[: n * ws] = w.view(np.uint8)
    n_t = torch.full((2,), n, dtype=torch.int32)
    comp, _ = FC.float_compress_core(rows_from_numpy(x), n_t, ftype,
                                     use_checksum=True, plain=plain)
    caps = torch.tensor([n, n - 1])  # member 1 does not fit: it fails
    words32, ok, _, ca, cg = FC.float_decompress_core(
        comp, torch.zeros(2, dtype=torch.int64), n, ftype, capacities=caps,
        verify_checksum=True, plain=plain)
    assert ok.tolist() == [True, False]
    assert not bool(words32[1].any())
    assert int(cg[0]) == int(ca[0]) and int(cg[1]) == 0


def _raise_k8(*args):
    raise AssertionError("a plain path reached the kernel wrappers")


def _verified_decode(kind, plain):
    """One verified decode (or, for ``ans_hist``, an encode given its
    histogram with the checksum on) of a small batch on the CPU."""
    from dietgpu_fork_torch.core.constants import FloatType
    from dietgpu_fork_torch.models import ans as A
    from dietgpu_fork_torch.models import float_codec as FC
    from dietgpu_fork_torch.models import sparse as SP

    rng = np.random.default_rng(5)
    if kind == "ans_hist":
        x = bytes_from_numpy(make_exponential_bytes(rng, 2 * 3000, 8.0).reshape(2, -1))
        sizes = torch.tensor([3000, 1001], dtype=torch.int32)
        hist = TH.byte_hist_plain(x, sizes)[0]
        return A.ans_encode_padded(x, sizes, 10, True, hist=hist, plain=plain)
    x = torch.from_numpy(rng.normal(0, 1, (2, 1000)).astype(np.float32))
    x[:, ::3] = 0
    d = x.view(torch.int32)
    n = torch.tensor([1000, 777], dtype=torch.int32)
    if kind == "float":
        comp, _ = FC.float_compress_core(d, n, FloatType.FLOAT32, 10, True,
                                         plain=True)
        return FC.float_decompress_core(
            comp, torch.zeros(2, dtype=torch.int64), 1000, FloatType.FLOAT32,
            10, verify_checksum=True, plain=plain)
    comp, _ = SP.sparse_float_compress_padded(d, n, FloatType.FLOAT32, 10, True,
                                              plain=True)
    return SP.sparse_float_decompress_core(
        comp.view(torch.int32), 1000, FloatType.FLOAT32, 10,
        verify_checksum=True, plain=plain)


@pytest.mark.parametrize("kind", ["float", "sparse", "ans_hist"])
def test_plain_checksums_never_reach_the_kernels(monkeypatch, kind):
    """plain=True keeps the torch fold even where ``checksum_rows`` would
    take the kernel; plain=False takes it, one call a batch."""
    from dietgpu_fork_torch.runtime import cuda_kernels as K

    want = _verified_decode(kind, True)
    monkeypatch.setattr(TH, "use_kernels", lambda t: True)
    monkeypatch.setattr(K, "byte_hist", _raise_k8)
    got = _verified_decode(kind, True)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    with pytest.raises(AssertionError, match="reached the kernel"):
        _verified_decode(kind, False)
    route = _K8Route()
    monkeypatch.setattr(K, "byte_hist", route)
    got = _verified_decode(kind, False)
    assert len(route.calls) == 1
    assert all(torch.equal(p, q) for p, q in zip(got, want))


@pytest.mark.parametrize("float_type", [None, "float16", "float32", "float64"])
@pytest.mark.parametrize("checksum", [True, False])
def test_a_verified_api_decompress_takes_one_k8_call(k8_route, float_type,
                                                     checksum):
    """decompress_data(..., checksum=True) checks a batch's decoded bytes
    with one call of K8's checksum-only form, dense, sparse or raw; with
    the checksum off it makes none."""
    from dietgpu_fork_torch.api import codec as C

    rng = np.random.default_rng(9)
    if float_type is None:
        ts = [torch.from_numpy(make_exponential_bytes(rng, n, 8.0)) for n in (999, 45)]
        calls = [(False, {})]
    else:
        ts = [torch.from_numpy(rng.normal(0, 1, n).astype(float_type))
              for n in (999, 45)]
        ts[0][::2] = 0
        calls = [(True, {}), (True, {"sparse": True})]
    sizes = [t.numel() for t in ts]
    for as_float, kw in calls:
        comp, _, _ = C.compress_data(as_float, ts, checksum=checksum, **kw)
        before = len(k8_route.calls)
        outs, _, ok, status, _ = C.decompress_data(
            as_float, comp, sizes, dtype=ts[0].dtype, checksum=checksum, **kw)
        assert bool(ok.all()) and all(torch.equal(o, t) for o, t in zip(outs, ts))
        assert len(k8_route.calls) - before == int(checksum)
        assert status.ok


def test_k8_checksum_form_is_positional_and_refuses_cpu_tensors():
    """The third argument of K8's wrapper, which drops the histogram, is
    positional only (a recorder that passes ``*args`` sees it), as in the
    plain version; the wrapper takes CUDA tensors only and builds nothing
    for a CPU call."""
    from dietgpu_fork_torch.runtime import cuda_kernels as K

    rows = torch.zeros((2, 45), dtype=torch.uint8)
    sizes = torch.tensor([45, 3], dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.byte_hist(rows, sizes, False)
    with pytest.raises(TypeError):
        K.byte_hist(rows, sizes, hist=False)
    with pytest.raises(TypeError):
        TH.byte_hist_plain(rows, sizes, hist=False)
    assert K._lib is None
    h, c = TH.byte_hist_plain(rows, sizes, False)
    assert h is None and c.dtype == torch.int64
    assert torch.equal(c, TH.byte_hist_plain(rows, sizes)[1].to(torch.int64))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32", "float64"])
def test_a_flipped_raw_byte_is_a_checksum_mismatch(dtype, sparse):
    """One flipped byte of an archive's raw section decodes (the ANS
    streams are intact) to bytes whose checksum differs from the stored
    one: ``decompress_data(..., checksum=True)`` reports a mismatch, not a
    failed decode."""
    from dietgpu_fork_torch.api import codec as C
    from dietgpu_fork_torch.core.constants import sparse_bitmap_bytes

    n = 2000
    x = np.random.default_rng(7).normal(0, 1, n)
    x[::2] = 0
    t = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
         if dtype == "bfloat16" else torch.from_numpy(x.astype(dtype)))
    comp, _, _ = C.compress_data(True, [t], checksum=True, sparse=sparse)
    dense = 16 + sparse_bitmap_bytes(n) if sparse else 0
    comp[0, dense + 40] ^= 0x5A  # a raw-section byte (header: 32 bytes)
    with pytest.raises(RuntimeError, match="checksum mismatch") as e:
        C.decompress_data(True, comp, [n], dtype=t.dtype, checksum=True,
                          sparse=sparse)
    assert "expected checksum" in str(e.value)
