"""K2's plain version (row-stream rANS encode) vs the JAX package's
encode_blocks_rows, and K4's plain version (decode + 16-bit join) vs its
decode_blocks_rows followed by join_packed, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.ops.float_split import join_packed
from dietgpu_fork_tpu.ops.rans_decode import decode_blocks_rows
from dietgpu_fork_tpu.ops.rans_encode import encode_blocks_rows
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.ops import rans_decode as TD
from dietgpu_fork_torch.ops import rans_encode as TE
from dietgpu_fork_torch.ops.bitops import from_u32
from dietgpu_fork_torch.ops.table import (
    build_decode_table_batched,
    normalize_probs_batched,
    pack_encode_table,
)
from tests.conftest import make_exponential_bytes
from tests.test_torch_threads import one_torch_thread  # noqa: F401

NB = 6  # a full row and a partial one
SIZES = {
    "edges": [0, 1, 4095, 4097],
    "multi_block": [6 * 4096, 4096, 2 * 4096 + 17, 5 * 4096 + 3],
}


def _encode_inputs(case, pb):
    """Skewed byte rows (zero past each size) and their coding tables."""
    rng = np.random.default_rng(len(case) * 16 + pb)
    sizes = np.array(SIZES[case], np.int32)
    x = np.zeros((len(sizes), NB * 4096), np.uint8)
    hist = np.zeros((len(sizes), 256), np.int64)
    for b, s in enumerate(sizes):
        x[b, :s] = make_exponential_bytes(rng, int(s), lam=8.0)
        hist[b] = np.bincount(x[b, :s], minlength=256)
    pdf, cdf, magic, shift = normalize_probs_batched(
        torch.from_numpy(hist), torch.from_numpy(sizes.astype(np.int64)), pb
    )
    packed = from_u32(pack_encode_table(pdf, cdf, shift))
    return x, sizes, pdf, packed, from_u32(magic)


@pytest.mark.parametrize("pb", [9, 10, 11])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_encode_rows_equals_jax(case, pb):
    x, sizes, _, packed, magic = _encode_inputs(case, pb)
    x32 = x.view(np.uint32)
    states, streams, num_words = TE.encode_rows(
        rows_from_numpy(x32), torch.from_numpy(sizes), packed, magic, pb
    )
    js, jstreams, jnw = encode_blocks_rows(
        jnp.asarray(x32), jnp.asarray(sizes),
        jnp.asarray(rows_to_numpy(packed)), jnp.asarray(rows_to_numpy(magic)),
        pb,
    )
    assert np.array_equal(rows_to_numpy(states), np.asarray(js))
    assert np.array_equal(rows_to_numpy(streams), np.asarray(jstreams))
    assert np.array_equal(num_words.numpy(), np.asarray(jnw))


_JAX_DECODED = {}


def _jax_decode(case, pb, *args):
    """decode_blocks_rows of the JAX package, once per input (both joins
    of a case reuse it)."""
    if (case, pb) not in _JAX_DECODED:
        dec = decode_blocks_rows(*[jnp.asarray(a) for a in args], pb)
        _JAX_DECODED[case, pb] = np.asarray(dec).reshape(args[0].shape[0], -1)
    return _JAX_DECODED[case, pb]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("pb", [9, 11])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_decode_join16_equals_jax(case, pb, bf16):
    x, sizes, pdf, packed, magic = _encode_inputs(case, pb)
    B = len(sizes)
    states, streams, num_words = TE.encode_rows_plain(
        rows_from_numpy(x.view(np.uint32)), torch.from_numpy(sizes), packed,
        magic, pb,
    )
    staged = F.pad(streams, (0, TD.ROW_STREAM_CAP - streams.shape[2]))
    blk = np.arange(NB) * 4096
    uncomp = np.clip(sizes[:, None] - blk[None, :], 0, 4096).astype(np.int32)
    lut = from_u32(build_decode_table_batched(pdf, pb))
    rng = np.random.default_rng(pb)
    raw = rng.integers(0, 256, (B, NB * 4096)).astype(np.uint8)
    raw[np.arange(NB * 4096)[None, :] >= sizes[:, None]] = 0
    raw32 = raw.view(np.uint32).reshape(B, NB, 1024)

    got = TD.decode_join16(
        staged, num_words, torch.from_numpy(uncomp), states, lut,
        rows_from_numpy(raw32), pb, bf16,
    )
    assert got.shape == (B, NB, 2048)

    dec = _jax_decode(case, pb, rows_to_numpy(staged), num_words.numpy(),
                      uncomp, rows_to_numpy(states), rows_to_numpy(lut))
    assert np.array_equal(dec.view(np.uint8), x)  # the ANS round trip
    ft = JFT.BFLOAT16 if bf16 else JFT.FLOAT16
    want = join_packed([dec], [raw32.reshape(B, NB * 1024)], ft)
    assert np.array_equal(rows_to_numpy(got).reshape(B, -1), np.asarray(want))


def test_encode_rows_rejects_bad_arguments():
    x, sizes, _, packed, magic = _encode_inputs("edges", 10)
    x32 = rows_from_numpy(x.view(np.uint32))
    n = torch.from_numpy(sizes)
    with pytest.raises(ValueError):
        TE.encode_rows(x32[:, :1000].contiguous(), n, packed, magic, 10)
    with pytest.raises(TypeError):
        TE.encode_rows(x32, n.to(torch.int64), packed, magic, 10)
    with pytest.raises(ValueError):
        TE.encode_rows(x32, n, packed, magic, 12)
