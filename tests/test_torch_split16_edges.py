"""K1's edge inputs, plain versions on the CPU, exact: the inputs
``chip_smoke.py`` holds the kernel to on the card (its
``split16_edge_inputs``: rows of W32 = 2 (mod 4) words, counts inside a
word and a 16 B chunk, around K1's tile and at the row's capacity, N(0,1)
and one-bin data, bf16 and fp16). ``split16_hist_plain`` against the JAX
package's ``split_hist_packed`` + ``mask_packed_bytes``, ``split16_plain``
against its ``split_packed``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.ops import checksum as JC
from dietgpu_fork_tpu.ops import float_split as JS
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import rows_to_numpy
from dietgpu_fork_torch.ops import float_split as TS
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TYPES = [FloatType.BFLOAT16, FloatType.FLOAT16]
CPU = torch.device("cpu")
TILE_FLOATS = 16384  # K1's tile: 4096 pairs of input words


@pytest.mark.parametrize("one_bin", [False, True])
@pytest.mark.parametrize("ft", TYPES, ids=[t.name for t in TYPES])
def test_split16_hist_plain_on_edge_inputs_equals_jax(ft, one_bin):
    data32, n = chip_smoke.split16_edge_inputs(ft, one_bin, CPU)
    exp, raw, hist, csum = TS.split16_hist_plain(data32, n, ft == FloatType.BFLOAT16)
    d, nn = rows_to_numpy(data32), n.numpy()
    planes, secs, hists, jcsum = JS.split_hist_packed(
        jnp.asarray(d), jnp.asarray(nn), JFT(int(ft)))
    assert np.array_equal(rows_to_numpy(exp), np.asarray(planes[0]))
    assert np.array_equal(rows_to_numpy(raw),
                          np.asarray(JC.mask_packed_bytes(secs[0], jnp.asarray(nn))))
    assert np.array_equal(hist.numpy(), np.asarray(hists[0]))
    assert np.array_equal(csum.numpy(), np.asarray(jcsum).astype(np.int32))
    if one_bin:  # every exponent byte below the counts in one bin
        assert ((hist > 0).sum(dim=1) <= 1).all() and hist.sum() == n.sum()


@pytest.mark.parametrize("ft", TYPES, ids=[t.name for t in TYPES])
def test_split16_plain_on_edge_inputs_equals_jax(ft):
    data32, _ = chip_smoke.split16_edge_inputs(ft, False, CPU)
    bf16 = ft == FloatType.BFLOAT16
    exp, raw = TS.split16_plain(data32, bf16)
    planes, secs = JS.split_packed(jnp.asarray(rows_to_numpy(data32)), JFT(int(ft)))
    assert np.array_equal(rows_to_numpy(exp), np.asarray(planes[0]))
    assert np.array_equal(rows_to_numpy(raw), np.asarray(secs[0]))
    # the dispatching entry takes the plain version for CPU tensors
    assert all(torch.equal(a, b) for a, b in zip(TS.split16(data32, bf16), (exp, raw)))


def test_edges_are_there():
    """The inputs hold the edges chip_smoke.py's phase claims."""
    data32, n = chip_smoke.split16_edge_inputs(FloatType.BFLOAT16, False, CPU)
    W32 = data32.shape[1]
    assert W32 % 4 == 2  # odd rows start 8 B past a 16 B boundary
    counts = n.tolist()
    assert {0, 1, 3, TILE_FLOATS - 1, TILE_FLOATS, TILE_FLOATS + 1,
            2 * W32 - 1, 2 * W32} <= set(counts)
    assert {c % 8 for c in counts} >= {1, 3, 5, 7}  # inside a 16 B chunk
    assert any(c > 2 * TILE_FLOATS and c % TILE_FLOATS for c in counts)
