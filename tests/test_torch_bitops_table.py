"""Port vs JAX package: u32 helpers and the coding tables, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.ops import bitops as JB
from dietgpu_fork_tpu.ops import table as JT
from dietgpu_fork_torch.ops import bitops as TB
from dietgpu_fork_torch.ops import table as TT
from tests.test_torch_threads import one_torch_thread  # noqa: F401

EDGES = np.array(
    [0, 1, 2, 3, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
     0x80000001, 0xFFFFFFFE, 0xFFFFFFFF],
    dtype=np.uint32,
)


def _u32s(seed, n=4096):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EDGES, r])


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_umulhi_equals_jax():
    a = _u32s(1)
    b = np.roll(_u32s(2), 7)
    got = TB.umulhi(_t(a), _t(b)).numpy()
    want = np.asarray(JB.umulhi(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want.astype(np.int64))
    exact = (a.astype(object) * b.astype(object)) >> 32
    assert np.array_equal(got, np.array(exact, dtype=np.int64))


def test_clz32_equals_jax():
    x = _u32s(3)
    got = TB.clz32(_t(x)).numpy()
    want = np.asarray(JB.clz32(jnp.asarray(x)))
    assert np.array_equal(got, want.astype(np.int64))


def test_popcount32_equals_jax():
    from dietgpu_fork_tpu.ops.pallas.sparse_stream import popcount32

    x = _u32s(4)
    got = TB.popcount32(_t(x)).numpy()
    want = np.asarray(popcount32(jnp.asarray(x)))
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(got, np.unpackbits(x.view(np.uint8)).reshape(
        -1, 32).sum(axis=1))


def test_udiv_u43_by_u32_equals_jax():
    # the domain of the magic-constant division: a_hi < divisor <= 2^16
    # (the JAX 16-bit long division needs no more; pdf <= 2^11 in use)
    rng = np.random.default_rng(4)
    d = rng.integers(1, (1 << 16) + 1, 4096).astype(np.uint32)
    d[:4] = [1, 2, 2048, 1 << 16]
    a = (rng.integers(0, 1 << 62, 4096) % d.astype(np.int64)).astype(np.uint32)
    a[:4] = [0, 1, 2047, (1 << 16) - 1]
    got = TB.udiv_u43_by_u32(_t(a), _t(d)).numpy()
    want = np.asarray(JB.udiv_u43_by_u32(jnp.asarray(a), jnp.asarray(d)))
    assert np.array_equal(got, want.astype(np.int64))
    exact = (a.astype(object) << 32) // d.astype(object)
    assert np.array_equal(got, np.array(exact, dtype=np.int64))


def test_u32_carriers_round_trip():
    x = _u32s(5)
    i32 = TB.from_u32(_t(x))
    assert i32.dtype == torch.int32
    assert np.array_equal(TB.to_u32(i32).numpy(), x.astype(np.int64))
    assert np.array_equal(
        TB.to_i32(_t(x)).numpy(), x.view(np.int32).astype(np.int64)
    )


def _hists(kind, B=6, seed=0):
    """Histogram rows and totals exercising each normalisation branch."""
    rng = np.random.default_rng(seed)
    h = np.zeros((B, 256), np.uint32)
    if kind == "empty":
        pass
    elif kind == "single":
        h[np.arange(B), rng.integers(0, 256, B)] = rng.integers(1, 1 << 20, B)
    elif kind == "diff_pos":
        # many tiny counts: the truncating first pass undershoots the target
        for b in range(B):
            k = rng.integers(100, 256)
            h[b, rng.choice(256, k, replace=False)] = rng.integers(1, 4, k)
    elif kind == "diff_neg":
        # symbols of count 1 are bumped to 1 next to four equal huge ones:
        # the first pass overshoots the target, and the correction takes
        # from the huge ones in turn, ties broken by symbol id
        for b in range(B):
            h[b, rng.choice(256, 100, replace=False)] = 1
            h[b, rng.choice(256, 4, replace=False)] = 1 << 20
    else:  # random, incl. an empty member
        h = rng.integers(0, 5000, (B, 256)).astype(np.uint32)
        h[:, rng.random(256) < 0.3] = 0
        h[0] = 0
    return h, h.astype(np.int64).sum(axis=1).astype(np.int32)


@pytest.mark.parametrize("pb", [9, 10, 11])
@pytest.mark.parametrize("kind", ["empty", "single", "diff_pos", "diff_neg", "random"])
def test_normalize_probs_equals_jax(kind, pb):
    h, tot = _hists(kind, seed=pb)
    got = TT.normalize_probs_batched(_t(h), _t(tot), pb)
    want = JT.normalize_probs_batched(jnp.asarray(h), jnp.asarray(tot), pb)
    for name, g, w in zip(("pdf", "cdf", "magic", "shift"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64)), name
    pdf = got[0].numpy()
    assert np.all(pdf.sum(axis=1)[tot > 0] == 1 << pb)
    packed = TT.pack_encode_table(*[got[i] for i in (0, 1, 3)])
    want_packed = JT.pack_encode_table(want[0], want[1], want[3])
    assert np.array_equal(packed.numpy(), np.asarray(want_packed).astype(np.int64))


@pytest.mark.parametrize("pb", [9, 10, 11])
@pytest.mark.parametrize("kind", ["single", "diff_pos", "diff_neg", "random"])
def test_decode_table_equals_jax(kind, pb):
    h, tot = _hists(kind, seed=100 + pb)
    pdf = TT.normalize_probs_batched(_t(h), _t(tot), pb)[0]
    got = TT.build_decode_table_batched(pdf, pb)
    want = JT.build_decode_table_batched(
        jnp.asarray(pdf.numpy().astype(np.uint32)), pb
    )
    assert got.shape == (h.shape[0], 1 << pb)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
