"""K5's and K7's plain versions (fp32/fp64 split + histograms + checksum,
and the join) vs the JAX package's split_hist_packed and join_packed, bit
for bit: the portable strided-lane path, and the Pallas kernels in
interpret mode, whose cell-local deinterleave must give the same bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.ops import checksum as JC
from dietgpu_fork_tpu.ops import float_split as JS
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.ops import float_split as TS
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WIDE = [JFT.FLOAT32, JFT.FLOAT64]
# (row words, float counts): whole groups, partial words, empty members
CASES = [
    (64, [0, 1, 7, 13]),
    (2056, [1000, 999, 3, 257]),
]
# bytes per float of the two raw sections
SEC_BYTES = {JFT.FLOAT32: (2, 1), JFT.FLOAT64: (4, 2)}


def _rows(seed, B, W32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (B, W32), dtype=np.uint64).astype(np.uint32)


def _port_split(d, n, ft):
    return TS.split_wide_hist(rows_from_numpy(d), torch.tensor(n, dtype=torch.int32),
                              FloatType(int(ft)))


def _assert_split_equal(got, planes, secs, hists, csum):
    exp, sec1, sec2, hist, cs = got
    B = sec1.shape[0]
    assert np.array_equal(rows_to_numpy(exp), np.concatenate([np.asarray(p) for p in planes]))
    assert np.array_equal(rows_to_numpy(sec1), np.asarray(secs[0]))
    assert np.array_equal(rows_to_numpy(sec2), np.asarray(secs[1]))
    assert np.array_equal(hist.numpy(),
                          np.concatenate([np.asarray(h) for h in hists]).astype(np.int32))
    assert hist.shape == (len(planes) * B, 256)
    assert np.array_equal(cs.numpy(), np.asarray(csum).astype(np.int32))


@pytest.mark.parametrize("ft", WIDE)
@pytest.mark.parametrize("W32,ns", CASES)
def test_split_wide_hist_equals_jax(ft, W32, ns):
    d = _rows(W32 + int(ft), len(ns), W32)
    n = np.array(ns, np.int32)
    planes, raw, hists, csum = JS.split_hist_packed(jnp.asarray(d), jnp.asarray(n), ft)
    secs = [JC.mask_packed_bytes(s, jnp.asarray(n * bp))
            for s, bp in zip(raw, SEC_BYTES[ft])]
    _assert_split_equal(_port_split(d, n, ft), planes, secs, hists, csum)


@pytest.mark.parametrize("ft", WIDE)
def test_split_wide_hist_equals_jax_pallas_interpret(ft, monkeypatch):
    """The Pallas split's cell-local lane deinterleave lands every byte
    where the portable strided one does; its raw sections are tail-masked
    in the kernel."""
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    W32, ns = 2056, [1000, 999, 3, 257]
    d = _rows(7 + int(ft), len(ns), W32)
    n = np.array(ns, np.int32)
    planes, secs, hists, csum = JS.split_hist_packed(jnp.asarray(d), jnp.asarray(n), ft)
    _assert_split_equal(_port_split(d, n, ft), planes, secs, hists, csum)


def _one_bin_rows(seed, B, W32):
    """fp64 floats in [1, 2) as u32 word pairs: every plane-0 byte (the
    exponent's top 8 bits) falls in one bin."""
    x = 1 + np.random.default_rng(seed).random((B, W32 // 2))
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("W32,ns", CASES)
def test_split_wide_hist_one_bin_fp64_equals_jax(W32, ns, interpret, monkeypatch):
    """fp64 data whose plane-0 bytes sit in one bin, the case that puts
    every lane's count on one shared address: the histograms and the rest
    of the split equal the JAX package's, portable and Pallas (interpret)."""
    if interpret:
        monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    ft = JFT.FLOAT64
    d = _one_bin_rows(40 + W32, len(ns), W32)
    n = np.array(ns, np.int32)
    planes, raw, hists, csum = JS.split_hist_packed(jnp.asarray(d), jnp.asarray(n), ft)
    secs = raw if interpret else [JC.mask_packed_bytes(s, jnp.asarray(n * bp))
                                  for s, bp in zip(raw, SEC_BYTES[ft])]
    got = _port_split(d, n, ft)
    _assert_split_equal(got, planes, secs, hists, csum)
    h0 = got[3][: len(ns)]  # plane 0
    assert ((h0 > 0).sum(dim=1) == torch.from_numpy((n > 0).astype(np.int64))).all()
    assert torch.equal(h0.sum(dim=1), torch.from_numpy(n.astype(np.int64)).to(h0.dtype))


@pytest.mark.parametrize("ft", WIDE)
@pytest.mark.parametrize("interpret", [False, True])
def test_join_wide_inverts_the_split_and_equals_jax(ft, interpret, monkeypatch):
    if interpret:
        monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    W32 = 1024
    d = _rows(20 + int(ft), 3, W32)
    n = torch.full((3,), W32 * 4 // (4 if ft == JFT.FLOAT32 else 8), dtype=torch.int32)
    exp, sec1, sec2, _, _ = TS.split_wide_hist_plain(rows_from_numpy(d), n,
                                                     FloatType(int(ft)))
    planes = list(exp.reshape(-1, 3, exp.shape[1]))
    back = TS.join_wide(planes, sec1, sec2, FloatType(int(ft)))
    assert np.array_equal(rows_to_numpy(back), d)
    want = JS.join_packed([jnp.asarray(rows_to_numpy(p)) for p in planes],
                          [jnp.asarray(rows_to_numpy(s)) for s in (sec1, sec2)], ft)
    assert np.array_equal(np.asarray(want), d)


@pytest.mark.parametrize("ft", WIDE)
def test_join_wide_reads_only_what_it_needs_of_wider_sections(ft):
    """Tensor mode takes section rows wider than it needs: the join reads
    the first 2E/E (fp32) or 4E/2E (fp64) words of each row."""
    W32 = 256
    d = _rows(30 + int(ft), 2, W32)
    P = 1 if ft == JFT.FLOAT32 else 2
    n = torch.full((2,), W32 * 4 // (4 * P), dtype=torch.int32)
    exp, sec1, sec2, _, _ = TS.split_wide_hist_plain(rows_from_numpy(d), n,
                                                     FloatType(int(ft)))
    wide1 = torch.cat([sec1, torch.full((2, 12), -1, dtype=torch.int32)], dim=1)
    wide2 = torch.cat([sec2, torch.full((2, 4), -1, dtype=torch.int32)], dim=1)
    planes = list(exp.reshape(P, 2, -1))
    back = TS.join_wide(planes, wide1, wide2, FloatType(int(ft)))
    assert np.array_equal(rows_to_numpy(back), d)


@pytest.mark.parametrize("ft", WIDE)
def test_wide_dispatch_is_plain_on_cpu(ft):
    d = rows_from_numpy(_rows(9, 3, 256))
    n = torch.tensor([64, 10, 0], dtype=torch.int32)
    a = TS.split_wide_hist(d, n, FloatType(int(ft)))
    b = TS.split_wide_hist_plain(d, n, FloatType(int(ft)))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    planes = list(a[0].reshape(-1, 3, a[0].shape[1]))
    assert torch.equal(TS.join_wide(planes, a[1], a[2], FloatType(int(ft))),
                       TS.join_wide_plain(planes, a[1], a[2], FloatType(int(ft))))


@pytest.mark.parametrize(
    "bad",
    [
        lambda d, n: (d.to(torch.int64), n, FloatType.FLOAT32),
        lambda d, n: (d[:, :-4], n, FloatType.FLOAT64),  # 12 words: not % 8
        lambda d, n: (d[:, :-2], n, FloatType.FLOAT32),  # 14 words: not % 4
        lambda d, n: (d, n.to(torch.int64), FloatType.FLOAT32),
        lambda d, n: (d, n, FloatType.BFLOAT16),
    ],
)
def test_split_wide_hist_rejects_bad_arguments(bad):
    d = rows_from_numpy(_rows(13, 2, 16))
    n = torch.tensor([4, 4], dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        TS.split_wide_hist(*bad(d, n))


@pytest.mark.parametrize(
    "bad",
    [
        lambda p, s1, s2: ([p[0]], s1, s2),  # one plane for fp64
        lambda p, s1, s2: (p, s1[:, :-1], s2),  # sec1 too narrow
        lambda p, s1, s2: (p, s1, s2.t()),  # rows not contiguous
        lambda p, s1, s2: (p, s1.to(torch.int64), s2),
    ],
)
def test_join_wide_rejects_bad_arguments(bad):
    d = rows_from_numpy(_rows(14, 2, 32))
    exp, sec1, sec2, _, _ = TS.split_wide_hist_plain(
        d, torch.tensor([16, 16], dtype=torch.int32), FloatType.FLOAT64)
    with pytest.raises((TypeError, ValueError)):
        TS.join_wide(*bad(list(exp.reshape(2, 2, -1)), sec1, sec2),
                     FloatType.FLOAT64)
