"""K6's plain version (row-stream rANS decode to packed bytes) vs the JAX
package's decode_blocks_rows, bit for bit; the port's ans_decode_core on
oracle-built ANS archives at offsets in their rows; and the 16-bit decode
as the join of the same walk's bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.ops.rans_decode import decode_blocks_rows
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models.ans import ans_decode_core
from dietgpu_fork_torch.ops import rans_decode as TD
from dietgpu_fork_torch.ops import rans_encode as TE
from dietgpu_fork_torch.ops.bitops import from_u32, to_u32
from dietgpu_fork_torch.ops.float_split import join16, unpack_bytes
from dietgpu_fork_torch.ops.table import build_decode_table_batched
from tests.conftest import make_exponential_bytes
from tests.test_torch_rans import NB, SIZES, _encode_inputs
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _decode_inputs(case, pb):
    """Row streams encoded by K2's plain version, staged as the decoder
    takes them, with their tables."""
    x, sizes, pdf, packed, magic = _encode_inputs(case, pb)
    states, streams, num_words = TE.encode_rows_plain(
        rows_from_numpy(x.view(np.uint32)), torch.from_numpy(sizes), packed,
        magic, pb,
    )
    staged = F.pad(streams, (0, TD.ROW_STREAM_CAP - streams.shape[2]))
    blk = np.arange(NB) * 4096
    uncomp = np.clip(sizes[:, None] - blk[None, :], 0, 4096).astype(np.int32)
    lut = from_u32(build_decode_table_batched(pdf, pb))
    args = (staged, num_words, torch.from_numpy(uncomp), states, lut)
    return x, sizes, args


@pytest.mark.parametrize("pb", [9, 10, 11])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_decode_rows_equals_jax(case, pb):
    x, sizes, args = _decode_inputs(case, pb)
    got = TD.decode_rows(*args, pb)
    assert got.shape == (len(sizes), NB, 1024)
    staged, comp_w, uncomp_w, states, lut = args
    want = decode_blocks_rows(
        jnp.asarray(rows_to_numpy(staged)), jnp.asarray(comp_w.numpy()),
        jnp.asarray(uncomp_w.numpy()), jnp.asarray(rows_to_numpy(states)),
        jnp.asarray(rows_to_numpy(lut)), pb)
    assert np.array_equal(rows_to_numpy(got), np.asarray(want))
    # the ANS round trip, zero past each member's size
    assert np.array_equal(rows_to_numpy(got).reshape(len(sizes), -1).view(np.uint8), x)


@pytest.mark.parametrize("bf16", [True, False])
def test_decode_join16_is_join16_of_decoded_bytes(bf16):
    x, sizes, args = _decode_inputs("multi_block", 10)
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (len(sizes), NB * 4096)).astype(np.uint8)
    raw32 = rows_from_numpy(raw.view(np.uint32).reshape(len(sizes), NB, 1024))
    sym = unpack_bytes(to_u32(TD.decode_rows_plain(*args, 10)))
    keep = torch.from_numpy(np.arange(NB * 4096)[None, :] < sizes[:, None])
    want = join16(sym.reshape(len(sizes), -1),
                  torch.where(keep, unpack_bytes(to_u32(raw32)).reshape(len(sizes), -1), 0),
                  bf16)
    got = TD.decode_join16_plain(*args, raw32, 10, bf16)
    assert torch.equal(to_u32(got).reshape(len(sizes), -1), want)


def test_decode_rows_dispatch_is_plain_on_cpu():
    _, _, args = _decode_inputs("edges", 11)
    assert torch.equal(TD.decode_rows(*args, 11), TD.decode_rows_plain(*args, 11))


def _archive_rows(rng, sizes, offsets, pb):
    """Oracle ANS archives of skewed bytes, each at its word offset in its
    row."""
    data = [make_exponential_bytes(rng, s, lam=6.0) for s in sizes]
    arcs = [R.ans_encode_native(d, prob_bits=pb) for d in data]
    CW = max(o + -(-a.size // 4) for o, a in zip(offsets, arcs)) + 8
    rows = np.zeros((len(sizes), CW * 4), np.uint8)
    for i, (o, a) in enumerate(zip(offsets, arcs)):
        rows[i, 4 * o: 4 * o + a.size] = a
    return data, rows.view(np.uint32)


@pytest.mark.parametrize("pb", [9, 11])
def test_ans_decode_core_decodes_oracle_archives(rng, pb):
    sizes = [0, 1, 4097, 5 * 4096 + 3, 9000]
    offsets = [0, 3, 128, 17, 64]
    data, rows = _archive_rows(rng, sizes, offsets, pb)
    cap = max(sizes)
    out, ok, n, _ = ans_decode_core(rows_from_numpy(rows), torch.tensor(offsets),
                                    cap, pb)
    assert ok.all() and n.tolist() == sizes
    assert out.shape == (len(sizes), -(-cap // 4))
    got = rows_to_numpy(out).view(np.uint8)
    for i, d in enumerate(data):
        assert np.array_equal(got[i, : d.size], d) and not got[i, d.size:].any()


def test_ans_decode_core_failed_members_come_back_zero(rng):
    sizes = [5000, 4096, 300]
    data, rows = _archive_rows(rng, sizes, [0, 0, 0], 10)
    rows = rows.copy()
    rows[0, 0] ^= 1  # wrong magic
    caps = torch.tensor([5000, 4095, 300])  # the second is over capacity
    out, ok, n, _ = ans_decode_core(rows_from_numpy(rows), torch.zeros(3), 5000,
                                    10, capacities=caps)
    assert ok.tolist() == [False, False, True]
    got = rows_to_numpy(out).view(np.uint8)
    assert not got[0].any() and not got[1].any()
    assert np.array_equal(got[2, :300], data[2]) and not got[2, 300:].any()


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: (a[0][:, :1], *a[1:]),  # rows of the wrong count
        lambda a: (a[0], a[1].to(torch.int64), *a[2:]),
        lambda a: (*a[:3], a[3][:, :, :16], a[4]),
        lambda a: (*a[:4], a[4][:, :100]),
    ],
)
def test_decode_rows_rejects_bad_arguments(bad):
    _, _, args = _decode_inputs("edges", 10)
    with pytest.raises((TypeError, ValueError)):
        TD.decode_rows(*bad(args), 10)
