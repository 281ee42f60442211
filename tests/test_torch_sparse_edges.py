"""K9's, K15's, K10's and K11's edge inputs, plain versions on the CPU,
exact: the inputs ``chip_smoke.py`` holds the kernels to on the card (its
``sparse_edge_inputs``). ``pack_bitmap_plain`` against a NumPy
``packbits`` oracle and, in interpret mode, the JAX package's
``pack_bitmap{16,32,64}_tpu`` with the tail mask of its
``models/sparse.py:224-232``; ``word_ranks_plain`` against a NumPy oracle
that unpacks the bitmap bit by bit; ``compact_by_bitmap_plain`` and
``expand_by_bitmap_plain`` against the JAX package's ``compact_by_bitmap``
/ ``expand_by_bitmap`` (+ ``mask_packed_bytes``) in interpret mode, on the
aligned case and on the ragged case cut to its first four members (each
interpret-mode trace takes seconds); the expansion with ranks past its
nonzero row against a NumPy oracle, since there the port clamps to the
row's last float and the JAX package reads zeros."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.ops.checksum import mask_packed_bytes
from dietgpu_fork_tpu.ops.pallas import bitmap_pack as JBP
from dietgpu_fork_tpu.ops.pallas import sparse_stream as JSS
from dietgpu_fork_torch.core.constants import FLOAT_WORD_SIZE, FloatType
from dietgpu_fork_torch.core.interop import rows_to_numpy
from dietgpu_fork_torch.ops.bitmap_pack import pack_bitmap, pack_bitmap_plain
from dietgpu_fork_torch.ops.sparse_stream import (
    compact_by_bitmap_plain,
    expand_by_bitmap_plain,
    word_ranks,
    word_ranks_plain,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TYPES = [FloatType.BFLOAT16, FloatType.FLOAT32, FloatType.FLOAT64]
_PAIR = {FloatType.BFLOAT16: 0, FloatType.FLOAT32: 1, FloatType.FLOAT64: 2}
_JAX_PACK = {FloatType.BFLOAT16: JBP.pack_bitmap16_tpu,
             FloatType.FLOAT32: JBP.pack_bitmap32_tpu,
             FloatType.FLOAT64: JBP.pack_bitmap64_tpu}


def _bits(bm32: torch.Tensor) -> np.ndarray:
    """bool[B, 32 BW]: float f's bit, bit 8k + 7 - i of byte k of word
    f // 32 for f = 32 w + 8 k + i."""
    b = rows_to_numpy(bm32).view(np.uint8)  # little-endian: byte k of each word
    return np.unpackbits(b, axis=1, bitorder="big").astype(bool)


def _oracle_ranks(bm32, n) -> np.ndarray:
    bits = _bits(bm32)
    f = np.arange(bits.shape[1])[None, :]
    live = bits & (f < n.numpy()[:, None])
    per_word = live.reshape(bits.shape[0], -1, 32).sum(axis=2)
    return np.pad(np.cumsum(per_word, axis=1), ((0, 0), (1, 0))).astype(np.int32)


def _words(items: np.ndarray) -> np.ndarray:
    """Float items (uint16/32/64 per float) -> their u32 row words."""
    return np.ascontiguousarray(items).view(np.uint32)


def _items(rows32: torch.Tensor, ft) -> np.ndarray:
    dt = {2: np.uint16, 4: np.uint32, 8: np.uint64}[FLOAT_WORD_SIZE[ft]]
    return np.ascontiguousarray(rows_to_numpy(rows32)).view(dt)


@pytest.mark.parametrize("ft", TYPES, ids=[t.name for t in TYPES])
@pytest.mark.parametrize("case", chip_smoke.SPARSE_EDGE_CASES)
def test_pack_bitmap_plain_equals_oracle(case, ft):
    """Each float's nonzero bit below n, MSB first per byte (NumPy
    ``packbits``), zero up to the row's bitmap words."""
    data32, n, _, _, _ = chip_smoke.sparse_edge_inputs(case, ft, "cpu")
    got = pack_bitmap_plain(data32, n, ft)
    items = _items(data32, ft)
    B, s_cap = items.shape
    bits = np.zeros((B, 32 * got.shape[1]), bool)
    bits[:, :s_cap] = (items != 0) & (np.arange(s_cap)[None] < n.numpy()[:, None])
    want = np.packbits(bits, axis=1, bitorder="big").view(np.uint32)
    assert np.array_equal(rows_to_numpy(got), want)
    # the dispatching entry takes the plain version for CPU tensors
    assert torch.equal(pack_bitmap(data32, n, ft), got)


@pytest.mark.parametrize("ft", TYPES, ids=[t.name for t in TYPES])
@pytest.mark.parametrize("case", chip_smoke.SPARSE_EDGE_CASES)
def test_word_ranks_plain_equals_oracle(case, ft):
    _, n, bm32, _, _ = chip_smoke.sparse_edge_inputs(case, ft, "cpu")
    got = word_ranks_plain(bm32, n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n.shape[0], bm32.shape[1] + 1)
    assert np.array_equal(got.numpy(), _oracle_ranks(bm32, n))
    # the dispatching entry takes the plain version for CPU tensors, and
    # any integer type of counts
    assert torch.equal(word_ranks(bm32, n.to(torch.int32)), got)


def test_edges_are_there():
    """The inputs hold the edges chip_smoke.py's phase claims."""
    data32, n, bm32, nz32, out_floats = chip_smoke.sparse_edge_inputs(
        "ragged", FloatType.BFLOAT16, "cpu")
    ranks = word_ranks_plain(bm32, n)
    nnz = ranks[:, -1].tolist()
    counts = n.tolist()
    assert 0 in counts and 0 in nnz
    assert any(c > 0 and c == z for c, z in zip(counts, nnz))
    assert max(counts) > 2 * chip_smoke.K.RANK_TILE_WORDS * 32  # 3 K15 tiles
    assert {c % 32 for c in counts} >= {1, 5, 8, 17, 31}
    assert int(ranks[3, 256]) % 2 == 1  # a bf16 run at an odd slot
    assert (4 * data32.shape[1]) % 16  # rows 1 on off 16 B boundaries
    _, _, _, nz_short, out_short = chip_smoke.sparse_edge_inputs(
        "overread", FloatType.BFLOAT16, "cpu")
    assert max(nnz) > 2 * nz_short.shape[1] and out_short < max(counts)


def _jax_pair(case, ft):
    """The case's inputs for the JAX comparison: the ragged case cut to its
    first four members and their capacity."""
    data32, n, bm32, nz32, out_floats = chip_smoke.sparse_edge_inputs(case, ft, "cpu")
    if case == "ragged":
        cap = int(n[:4].max())
        W = -(-cap * FLOAT_WORD_SIZE[ft] // 4)
        data32, n = data32[:4, :W].contiguous(), n[:4]
        bm32 = pack_bitmap_plain(data32, n, ft)
        nz32 = compact_by_bitmap_plain(data32, bm32, word_ranks_plain(bm32, n), ft)[0]
        out_floats = cap
    return data32, n, bm32, word_ranks_plain(bm32, n), nz32, out_floats


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")


def _jax_tail_mask(jbm, n):
    """The JAX package's models/sparse.py:224-232: the bits of floats at or
    past n cleared from MSB-first bitmap words."""
    wpos = jnp.arange(jbm.shape[1], dtype=jnp.int32)[None, :]
    r = jnp.clip(jnp.asarray(n, jnp.int32)[:, None] - wpos * 32, 0, 32)
    fb = (r >> 3).astype(jnp.uint32)
    full = jnp.where(fb >= 4, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << (fb * 8)) - 1)
    part = ((jnp.uint32(0xFF) << (jnp.uint32(8) - (r & 7).astype(jnp.uint32)))
            & jnp.uint32(0xFF)) << (fb * 8)
    return np.asarray(jbm & (full | jnp.where(r < 32, part, jnp.uint32(0))))


@pytest.mark.parametrize("ft", TYPES, ids=[t.name for t in TYPES])
@pytest.mark.parametrize("case", ["ragged", "aligned"])
def test_pack_bitmap_plain_equals_jax(interpret, case, ft):
    data32, n, bm32, _, _, _ = _jax_pair(case, ft)
    s_cap = 4 * data32.shape[1] // FLOAT_WORD_SIZE[ft]
    jbm = _JAX_PACK[ft](jnp.asarray(rows_to_numpy(data32)))[:, : -(-s_cap // 32)]
    jbm = _jax_tail_mask(jbm, n.numpy())
    got = rows_to_numpy(bm32)
    assert np.array_equal(got[:, : jbm.shape[1]], jbm)
    assert not got[:, jbm.shape[1]:].any()


@pytest.mark.parametrize("ft", TYPES, ids=[t.name for t in TYPES])
@pytest.mark.parametrize("case", ["ragged", "aligned"])
def test_compact_and_expand_plain_equal_jax(interpret, case, ft):
    data32, n, bm32, ranks, nz32, out_floats = _jax_pair(case, ft)
    ws = FLOAT_WORD_SIZE[ft]
    s_cap = 4 * data32.shape[1] // ws
    lsb = JSS.bitrev8_words(jnp.asarray(rows_to_numpy(bm32)))
    packed, nnz = compact_by_bitmap_plain(data32, bm32, ranks, ft)
    jc, jnnz = JSS.compact_by_bitmap(jnp.asarray(rows_to_numpy(data32)), lsb,
                                     s_cap, pair=_PAIR[ft])
    assert np.array_equal(rows_to_numpy(packed),
                          np.asarray(jc)[:, : packed.shape[1]])
    assert nnz.tolist() == np.asarray(jnnz).tolist()
    out = expand_by_bitmap_plain(nz32, bm32, ranks, n, out_floats, ft)
    width = -(-out_floats * ws // 4)
    jw = JSS.expand_by_bitmap(jnp.asarray(rows_to_numpy(nz32)), lsb, out_floats,
                              pair=_PAIR[ft])[:, :width]
    live = jnp.asarray(np.minimum(n.numpy(), out_floats).astype(np.int32))
    jw = mask_packed_bytes(jw, live * ws)
    assert tuple(out.shape) == (n.shape[0], width)
    assert np.array_equal(rows_to_numpy(out), np.asarray(jw))
    # and the expansion restores the rows
    assert np.array_equal(rows_to_numpy(out), rows_to_numpy(data32)[:, :width])


@pytest.mark.parametrize("ft", TYPES, ids=[t.name for t in TYPES])
def test_expand_past_the_nonzero_row_equals_oracle(ft):
    """Ranks past the nonzero row read its last float; floats at or past
    min(n, out_floats) are zero."""
    data32, n, bm32, nz32, out_floats = chip_smoke.sparse_edge_inputs(
        "overread", ft, "cpu")
    ranks = word_ranks_plain(bm32, n)
    out = expand_by_bitmap_plain(nz32, bm32, ranks, n, out_floats, ft)
    ws = FLOAT_WORD_SIZE[ft]
    slots = 4 * (-(-out_floats * ws // 4)) // ws
    nz = _items(nz32, ft)
    bits = _bits(bm32)[:, :slots]
    f = np.arange(slots)[None, :]
    live = bits & (f < np.minimum(n.numpy(), out_floats)[:, None])
    rank = np.minimum(np.cumsum(live, axis=1) - live, nz.shape[1] - 1)
    want = np.where(live, np.take_along_axis(nz, rank, axis=1), 0).astype(nz.dtype)
    assert np.array_equal(rows_to_numpy(out), _words(want))
    assert (np.cumsum(live, axis=1)[:, -1] > nz.shape[1]).any()
