"""K2's and K14 rowwise's edge inputs, plain versions on the CPU, exact: the
inputs ``chip_smoke.py`` holds the kernels to on the card (its
``encode_edge_bytes`` and ``EDGE_LOOKUPS``) through ``encode_rows_plain`` /
``encode_blocks_plain`` against the JAX package's ``encode_blocks_rows`` /
``encode_blocks``, states, streams (the zeros past each stream's words
included) and word counts bit for bit: ragged sizes with dead blocks in the
last row, uniform bytes, single-symbol members, and a block that emits more
than the classic cap of 2560 u16 under a row that stays below the row cap;
and the rowwise lookups against the JAX package's ``rowwise_lookup``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.ops.pallas.lookup import rowwise_lookup
from dietgpu_fork_tpu.ops.rans_encode import encode_blocks, encode_blocks_rows
from dietgpu_fork_torch.core.constants import MAX_BLOCK_WORDS32, MAX_ROW_WORDS32
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.ops import lookup as TL
from dietgpu_fork_torch.ops import rans_encode as TE
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LAYOUTS = {
    "rows": (TE.encode_rows_plain, TE.encode_rows, encode_blocks_rows,
             MAX_ROW_WORDS32),
    "classic": (TE.encode_blocks_plain, TE.encode_blocks, encode_blocks,
                MAX_BLOCK_WORDS32),
}


def _port_and_jax(case, pb, layout):
    plain, dispatch, jax_fn, cap32 = LAYOUTS[layout]
    args = chip_smoke.encode_edge_inputs(case, pb, "cpu")
    got = plain(*args, pb)
    # the dispatching entry takes the plain version for CPU tensors
    for g, d in zip(got, dispatch(*args, pb)):
        assert torch.equal(g, d)
    x32, sizes, packed, magic = (rows_to_numpy(a) for a in args)
    want = jax_fn(jnp.asarray(x32), jnp.asarray(sizes.view(np.int32)),
                  jnp.asarray(packed), jnp.asarray(magic), pb)
    # the JAX CPU path keeps one trailing dump column per classic block
    want = (np.asarray(want[0]), np.asarray(want[1])[:, :, :cap32],
            np.asarray(want[2]))
    return [rows_to_numpy(t) for t in got], want


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("pb", chip_smoke.EDGE_PROB_BITS)
@pytest.mark.parametrize("case", chip_smoke.EDGE_CASES)
def test_encode_edges_equal_jax(case, pb, layout):
    got, want = _port_and_jax(case, pb, layout)
    nb = chip_smoke.EDGE_NB
    B = len(chip_smoke.encode_edge_bytes(case)[1])
    nseg = nb if layout == "classic" else -(-nb // 4)
    assert got[1].shape == (B, nseg, LAYOUTS[layout][3])
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    if case == "single":
        assert not got[2].any() and not got[1].any()


def test_overflow_edge_passes_the_block_cap_under_the_row_cap():
    """At prob_bits 11 the all-values block emits more than 2560 u16: the
    classic stream keeps its first 2560 and counts them all, the row stream
    keeps every word of the row."""
    (_, rows, nw), _ = _port_and_jax("overflow", 11, "rows")
    (_, blocks, nw_c), _ = _port_and_jax("overflow", 11, "classic")
    assert np.array_equal(nw, nw_c)
    first, last = int(nw[0, 0]), int(nw[1, chip_smoke.EDGE_NB - 1])
    assert min(first, last) > 2 * MAX_BLOCK_WORDS32
    row_words = int(nw[0, :4].sum())
    assert row_words < 2 * MAX_ROW_WORDS32
    # zeros past the row's words; the classic stream is full to its cap
    assert not rows.view(np.uint16)[0, 0, row_words:].any()
    assert blocks.view(np.uint16)[0, 0].any()


@pytest.mark.parametrize("r,k,aligned", chip_smoke.EDGE_LOOKUPS)
def test_rowwise_lookup_edges_equal_jax(r, k, aligned):
    rng = np.random.default_rng(r * 1000 + k)
    tab = rng.integers(0, 1 << 32, (r, chip_smoke.EDGE_H),
                       dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(-50, chip_smoke.EDGE_H + 50, (r, k)).astype(np.int32)
    t_idx = torch.from_numpy(idx)
    if not aligned:
        flat = torch.zeros(r * k + 1, dtype=torch.int32)
        flat[1:].view(r, k).copy_(t_idx)
        t_idx = flat[1:].view(r, k)
    got = TL.rowwise_lookup(rows_from_numpy(tab), t_idx)
    want = rowwise_lookup(jnp.asarray(tab), jnp.asarray(idx))
    assert np.array_equal(rows_to_numpy(got), np.asarray(want))
