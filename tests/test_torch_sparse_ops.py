"""The port's sparse ops (plain versions on the CPU) against the JAX
package's Pallas kernels run in interpret mode (``DIETTPU_INTERPRET=1``),
on the prefix each JAX op defines: ``pack_bitmap_plain`` against
``pack_bitmap{16,32,64}_tpu`` with the tail mask of the JAX
``models/sparse.py:224-232``, ``compact_by_bitmap_plain`` against the
JAX ``compact_by_bitmap`` (pair 0, 1 and 2), and ``expand_by_bitmap_plain``
against the JAX ``expand_by_bitmap`` followed by ``mask_packed_bytes``.
Two ragged members of a 9000-float row, with counts among 1, 8192 and
9000 and half of the floats zero.

A file of its own, kept at op level: each interpret-mode trace takes
seconds (the whole-API interpret sparse test is marked slow)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.ops.checksum import mask_packed_bytes
from dietgpu_fork_tpu.ops.pallas import bitmap_pack as JBP
from dietgpu_fork_tpu.ops.pallas import sparse_stream as JSS
from dietgpu_fork_torch.core.constants import FLOAT_WORD_SIZE, FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.ops.bitmap_pack import bitmap_words, pack_bitmap_plain
from dietgpu_fork_torch.ops.sparse_stream import (
    compact_by_bitmap_plain,
    expand_by_bitmap_plain,
    word_ranks,
)
from tests.test_float_jax import pack_rows
from tests.test_sparse_jax import sparse_words
from tests.test_torch_threads import one_torch_thread  # noqa: F401

S = 9000
# (float type, the JAX ops' pair mode, its Pallas bitmap pack)
WIDTHS = [
    (FloatType.BFLOAT16, 0, JBP.pack_bitmap16_tpu),
    (FloatType.FLOAT32, 1, JBP.pack_bitmap32_tpu),
    (FloatType.FLOAT64, 2, JBP.pack_bitmap64_tpu),
]
COUNTS = [(9000, 1), (8192, 9000)]
_IDS = [ft.name for ft, _, _ in WIDTHS]


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")


def _inputs(rng, ft, counts):
    """(u32 rows of both members, the port's bitmap, its ranks, counts)."""
    jft = JFT(int(ft))
    d32 = pack_rows([sparse_words(rng, jft, c, 0.5) for c in counts], S, jft)
    n = torch.tensor(counts, dtype=torch.int32)
    bm = pack_bitmap_plain(rows_from_numpy(d32), n, ft)
    return d32, bm, word_ranks(bm, n), n


def _jax_bitmap_lsb(bm: torch.Tensor):
    return JSS.bitrev8_words(jnp.asarray(rows_to_numpy(bm)))


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("ft,pair,pack", WIDTHS, ids=_IDS)
def test_pack_bitmap_equals_pallas(rng, ft, pair, pack, counts):
    d32, bm, _, _ = _inputs(rng, ft, counts)
    # the JAX package's sparse.py:224-232
    jbm = pack(jnp.asarray(d32))[:, : -(-S // 32)]
    n = jnp.asarray(counts, jnp.int32)
    wpos = jnp.arange(jbm.shape[1], dtype=jnp.int32)[None, :]
    r = jnp.clip(n[:, None] - wpos * 32, 0, 32)
    fb = (r >> 3).astype(jnp.uint32)
    full = jnp.where(fb >= 4, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << (fb * 8)) - 1)
    part = ((jnp.uint32(0xFF) << (jnp.uint32(8) - (r & 7).astype(jnp.uint32)))
            & jnp.uint32(0xFF)) << (fb * 8)
    jbm = np.asarray(jbm & (full | jnp.where(r < 32, part, jnp.uint32(0))))
    got = rows_to_numpy(bm)
    assert got.shape == (2, bitmap_words(S))
    assert np.array_equal(got[:, : jbm.shape[1]], jbm)
    assert not got[:, jbm.shape[1]:].any()


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("ft,pair,pack", WIDTHS, ids=_IDS)
def test_compact_by_bitmap_equals_pallas(rng, ft, pair, pack, counts):
    d32, bm, ranks, _ = _inputs(rng, ft, counts)
    packed, nnz = compact_by_bitmap_plain(rows_from_numpy(d32), bm, ranks, ft)
    jc, jnnz = JSS.compact_by_bitmap(jnp.asarray(d32), _jax_bitmap_lsb(bm), S,
                                     pair=pair)
    width = -(-S * FLOAT_WORD_SIZE[ft] // 4)
    assert tuple(packed.shape) == (2, width)
    assert np.array_equal(rows_to_numpy(packed), np.asarray(jc)[:, :width])
    assert nnz.tolist() == np.asarray(jnnz).tolist()


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("ft,pair,pack", WIDTHS, ids=_IDS)
def test_expand_by_bitmap_equals_pallas(rng, ft, pair, pack, counts):
    d32, bm, ranks, n = _inputs(rng, ft, counts)
    nz32, _ = compact_by_bitmap_plain(rows_from_numpy(d32), bm, ranks, ft)
    out = expand_by_bitmap_plain(nz32, bm, ranks, n, S, ft)
    ws = FLOAT_WORD_SIZE[ft]
    width = -(-S * ws // 4)
    jw = JSS.expand_by_bitmap(jnp.asarray(rows_to_numpy(nz32)),
                              _jax_bitmap_lsb(bm), S, pair=pair)[:, :width]
    jw = mask_packed_bytes(jw, jnp.asarray(counts, jnp.int32) * ws)
    assert tuple(out.shape) == (2, width)
    assert np.array_equal(rows_to_numpy(out), np.asarray(jw))
    # and the expansion restores the rows
    assert np.array_equal(rows_to_numpy(out), d32[:, :width])
