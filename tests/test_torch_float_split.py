"""K1's plain version (split + histogram + checksum) vs the JAX package's
split_hist_packed and mask_packed_bytes, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.ops import checksum as JC
from dietgpu_fork_tpu.ops import float_split as JS
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.ops import float_split as TS
from dietgpu_fork_torch.ops.bitops import to_u32
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CASES = [
    (64, [0, 1, 7, 128]),
    (2050, [4100, 4099, 3, 1001]),
]


def _rows(seed, B, W32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (B, W32), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("ft", [JFT.BFLOAT16, JFT.FLOAT16])
@pytest.mark.parametrize("W32,ns", CASES)
def test_split16_hist_equals_jax(ft, W32, ns):
    d = _rows(W32, len(ns), W32)
    n = np.array(ns, np.int32)
    exp, raw, hist, csum = TS.split16_hist(
        rows_from_numpy(d), torch.from_numpy(n), ft == JFT.BFLOAT16
    )
    (jexp,), (jraw,), (jhist,), jcsum = JS.split_hist_packed(
        jnp.asarray(d), jnp.asarray(n), ft
    )
    jraw = JC.mask_packed_bytes(jraw, jnp.asarray(n))
    assert np.array_equal(rows_to_numpy(exp), np.asarray(jexp))
    assert np.array_equal(rows_to_numpy(raw), np.asarray(jraw))
    assert np.array_equal(hist.numpy(), np.asarray(jhist).astype(np.int32))
    assert np.array_equal(csum.numpy(), np.asarray(jcsum).astype(np.int32))


def test_split16_hist_dispatch_is_plain_on_cpu():
    d = rows_from_numpy(_rows(9, 3, 256))
    n = torch.tensor([512, 100, 0], dtype=torch.int32)
    a = TS.split16_hist(d, n, True)
    b = TS.split16_hist_plain(d, n, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("nbytes", [[0, 1, 2, 3], [4, 5, 63, 64], [17, 1000, 6, 0]])
def test_mask_packed_bytes_equals_jax(nbytes):
    d = _rows(11, 4, 16)
    nb = np.array(nbytes, np.int32)
    got = TS.mask_packed_bytes(to_u32(rows_from_numpy(d)), torch.from_numpy(nb))
    want = JC.mask_packed_bytes(jnp.asarray(d), jnp.asarray(nb))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("ft", [JFT.BFLOAT16, JFT.FLOAT16])
def test_join16_inverts_the_split(ft):
    d = _rows(12, 2, 512)
    n = torch.tensor([1024, 1024], dtype=torch.int32)
    bf16 = ft == JFT.BFLOAT16
    exp, raw, _, _ = TS.split16_hist_plain(rows_from_numpy(d), n, bf16)
    e = TS.unpack_bytes(to_u32(exp))
    r = TS.unpack_bytes(to_u32(raw))
    back = TS.join16(e, r, bf16)
    assert np.array_equal(back.numpy(), d.astype(np.int64))
    want = JS.join_packed([np.asarray(rows_to_numpy(exp))],
                          [np.asarray(rows_to_numpy(raw))], ft)
    assert np.array_equal(np.asarray(want), d)


@pytest.mark.parametrize(
    "bad",
    [
        lambda d, n: (d.to(torch.int64), n),
        lambda d, n: (d[:, :-1], n),
        lambda d, n: (d, n.to(torch.int64)),
        lambda d, n: (d, n[:1]),
        lambda d, n: (d.t(), n),
    ],
)
def test_split16_hist_rejects_bad_arguments(bad):
    d = rows_from_numpy(_rows(13, 2, 8))
    n = torch.tensor([4, 4], dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        TS.split16_hist(*bad(d, n), True)
