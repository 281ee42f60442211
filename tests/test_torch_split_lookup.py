"""The ops of the port with no TPU path, plain versions on the CPU, exact:
``split_packed`` (K1 and K5 without histogram) against the JAX package's
portable ``split_packed`` and its Pallas ``split_packed_tpu`` in interpret
mode, for four types and widths that leave partial cells; the lookups (K14)
against the JAX package's ``chunked_lookup`` and ``rowwise_lookup`` off the
TPU, clamping included; and the single-source runs merge (K3, the
counterpart of the v1 ``_merge_kernel``) against ``_runs_merge_tpu`` in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.ops.float_split import split_packed
from dietgpu_fork_tpu.ops.pallas.float_split_fused import split_packed_tpu
from dietgpu_fork_tpu.ops.pallas.lookup import chunked_lookup, rowwise_lookup
from dietgpu_fork_tpu.ops.pallas.merge import _runs_merge_tpu
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.ops import float_split as FS
from dietgpu_fork_torch.ops import lookup as TL
from dietgpu_fork_torch.ops.merge import runs_merge, runs_merge_plain
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FTYPES = [JFT.FLOAT16, JFT.BFLOAT16, JFT.FLOAT32, JFT.FLOAT64]
# u32 words a row: one group of floats, a partial cell, and a full cell
# (131072 words) plus a partial one
WIDTHS = [8, 1000, 131072 + 1016]


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _port_split(d32, ft, fn=FS.split_packed_plain):
    planes, secs = fn(rows_from_numpy(d32), FloatType(int(ft)))
    return [rows_to_numpy(p) for p in planes], [rows_to_numpy(s) for s in secs]


def _assert_lists_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("W", WIDTHS[:2])
@pytest.mark.parametrize("ft", FTYPES)
def test_split_packed_equals_jax_portable(rng, ft, W):
    d32 = _u32(rng, (3, W))
    got = _port_split(d32, ft)
    want = split_packed(jnp.asarray(d32), ft)
    _assert_lists_equal(got[0], want[0])
    _assert_lists_equal(got[1], want[1])
    # the dispatching entry takes the plain version for CPU tensors
    for g, w in zip(_port_split(d32, ft, FS.split_packed), got):
        _assert_lists_equal(g, w)


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("ft", FTYPES)
def test_split_packed_equals_jax_pallas(rng, ft, W, monkeypatch):
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    d32 = _u32(rng, (2, W))
    got = _port_split(d32, ft)
    want = split_packed_tpu(jnp.asarray(d32), ft)
    _assert_lists_equal(got[0], want[0])
    _assert_lists_equal(got[1], want[1])


@pytest.mark.parametrize("ft", FTYPES)
def test_split_packed_then_join_is_the_identity(rng, ft):
    d32 = _u32(rng, (2, 1000))
    planes, secs = FS.split_packed(rows_from_numpy(d32), FloatType(int(ft)))
    if ft in (JFT.FLOAT16, JFT.BFLOAT16):
        back = FS.join16_rows(planes[0], secs[0], ft == JFT.BFLOAT16)
    else:
        back = FS.join_wide(planes, *secs, FloatType(int(ft)))
    assert np.array_equal(rows_to_numpy(back), d32)


def test_split_packed_refuses_a_partial_group():
    d = torch.zeros((1, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        FS.split_packed(d, FloatType.FLOAT64)
    with pytest.raises(ValueError):
        FS.split_packed(d[:, :5].contiguous(), FloatType.BFLOAT16)


@pytest.mark.parametrize("B,H,N", [(1, 1024, 5000), (3, 1, 7), (2, 3000, 1),
                                   (2, 256, 0)])
def test_chunked_lookup_equals_jax(rng, B, H, N):
    tab = _u32(rng, (B, H))
    idx = rng.integers(-100, H + 100, (B, N)).astype(np.int32)
    got = TL.chunked_lookup(rows_from_numpy(tab), torch.from_numpy(idx))
    want = chunked_lookup(jnp.asarray(tab), jnp.asarray(idx))
    assert got.shape == (B, N)
    assert np.array_equal(rows_to_numpy(got), np.asarray(want))
    assert torch.equal(got, TL.chunked_lookup_plain(rows_from_numpy(tab),
                                                    torch.from_numpy(idx)))


@pytest.mark.parametrize("R,H,Kk", [(7, 5120, 128), (1, 1, 1), (5, 300, 33)])
def test_rowwise_lookup_equals_jax(rng, R, H, Kk):
    tab = _u32(rng, (R, H))
    idx = rng.integers(-100, H + 100, (R, Kk)).astype(np.int32)
    got = TL.rowwise_lookup(rows_from_numpy(tab), torch.from_numpy(idx))
    want = rowwise_lookup(jnp.asarray(tab), jnp.asarray(idx))
    assert np.array_equal(rows_to_numpy(got), np.asarray(want))
    assert torch.equal(got, TL.rowwise_lookup_plain(rows_from_numpy(tab),
                                                    torch.from_numpy(idx)))


def test_lookups_refuse_bad_shapes():
    t = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        TL.rowwise_lookup(t, torch.zeros((2, 129), dtype=torch.int32))
    with pytest.raises(ValueError):
        TL.chunked_lookup(t, torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        TL.chunked_lookup(t[:, :0].contiguous(), torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        TL.chunked_lookup(t, torch.zeros((2, 4), dtype=torch.int64))


def test_single_source_merge_equals_v1_pallas_merge(rng, monkeypatch):
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    src = _u32(rng, 20000)
    R, out_len = 300, 1 << 14
    lens = rng.integers(0, 90, R)
    lens[rng.random(R) < 0.2] = 0
    dst = np.cumsum(rng.integers(0, 6, R) + np.concatenate([[0], lens[:-1]]))
    keep = dst + lens <= out_len
    dst, lens = dst[keep], lens[keep]
    off = rng.integers(0, src.size - lens + 1)
    want = _runs_merge_tpu(jnp.asarray(src), jnp.asarray(dst, jnp.int32),
                           jnp.asarray(off, jnp.int32),
                           jnp.asarray(lens, jnp.int32), out_len=out_len)
    args = ([torch.from_numpy(src.view(np.int32))],
            torch.from_numpy(dst.astype(np.int64)),
            torch.zeros(dst.size, dtype=torch.int32),
            torch.from_numpy(off.astype(np.int64)),
            torch.from_numpy(lens.astype(np.int64)), out_len)
    got = runs_merge_plain(*args)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert torch.equal(runs_merge(*args), got)
