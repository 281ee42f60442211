"""The port's fp32 and fp64 float codec end to end (plain versions on the
CPU) vs the JAX package and the NumPy oracle: byte-identical archives in v1
and v2 containers, exact round trips, cross-decoding both ways, the golden
digests of chip_smoke.py, and corrupt archives failing without raising."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import float_codec as JF
from dietgpu_fork_torch.core.constants import FLOAT_ALIGN_MIN, FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import float_codec as TF
from tests.conftest import make_float_words
from tests.test_torch_float_codec import (
    SIZES,
    V2_SIZES,
    assert_round_trip,
    port_compress,
    port_decompress,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WIDE = [JFT.FLOAT32, JFT.FLOAT64]

jax_enc = jax.jit(
    JF.float_compress_core,
    static_argnames=("float_type", "prob_bits", "use_checksum", "native"),
)
jax_dec = jax.jit(
    JF.float_decompress_core,
    static_argnames=("out_floats", "float_type", "prob_bits",
                     "verify_checksum", "native"),
)


def assert_equals_oracle(out, cb, words, ft, pb=10, cks=False):
    for i, w in enumerate(words):
        arc = R.float_compress(w, ft, prob_bits=pb, use_checksum=cks, native=True)
        assert cb[i] == arc.size, i
        u8 = out.view(np.uint8)[i]
        assert np.array_equal(u8[: arc.size], arc) and not u8[arc.size:].any(), i


@pytest.mark.parametrize("ft", WIDE)
def test_ragged_batch_equals_jax_and_cross_decodes(rng, ft):
    words = [make_float_words(rng, ft, n) for n in SIZES]
    d32, out, cb = port_compress(words, ft)
    jout, jcb = jax_enc(jnp.asarray(d32), jnp.asarray(SIZES, jnp.int32),
                        float_type=ft, prob_bits=10, native=True)
    assert np.array_equal(cb, np.asarray(jcb).astype(np.int64))
    assert np.array_equal(out, np.asarray(jout))

    cap = max(SIZES)
    # the port decodes the JAX package's archives, to the JAX width
    jw, js, *_ = jax_dec(jnp.asarray(out), jnp.zeros(len(SIZES), jnp.int32),
                         out_floats=cap, float_type=ft, prob_bits=10,
                         native=True)
    got, succ, n, _ = port_decompress(np.asarray(jout), cap, ft)
    assert np.array_equal(n, SIZES)
    assert got.shape == np.asarray(jw).shape
    assert_round_trip(got, succ, words)
    # the JAX package decodes the port's archives
    assert_round_trip(np.asarray(jw), np.asarray(js), words)


@pytest.mark.parametrize("n", SIZES + V2_SIZES)
@pytest.mark.parametrize("ft", WIDE)
def test_single_member_equals_oracle(rng, ft, n):
    w = make_float_words(rng, ft, n)
    _, out, cb = port_compress([w], ft)
    assert_equals_oracle(out, cb, [w], ft)
    # the oracle decodes the port's archive; the port round-trips it
    back, hdr = R.float_decompress(out.view(np.uint8)[0, : cb[0]])
    assert np.array_equal(back.view(np.uint8), w.view(np.uint8))
    assert hdr.aligned == (n >= FLOAT_ALIGN_MIN)
    got, succ, _, _ = port_decompress(out, max(n, 1), ft)
    assert_round_trip(got, succ, [w])


@pytest.mark.parametrize("ft", WIDE)
def test_v1_and_v2_members_in_one_batch(rng, ft):
    words = [make_float_words(rng, ft, n)
             for n in (FLOAT_ALIGN_MIN + 100, FLOAT_ALIGN_MIN - 64, 3)]
    _, out, cb = port_compress(words, ft, cks=True)
    assert_equals_oracle(out, cb, words, ft, cks=True)
    got, succ, _, csum = port_decompress(out, FLOAT_ALIGN_MIN + 100, ft)
    assert_round_trip(got, succ, words)
    assert [int(c) for c in csum] == [R.checksum(w.view(np.uint8)) for w in words]


@pytest.mark.parametrize("pb", [9, 11])
@pytest.mark.parametrize("cks", [False, True])
@pytest.mark.parametrize("ft", WIDE)
def test_prob_bits_and_checksum_equal_oracle(rng, ft, pb, cks):
    words = [make_float_words(rng, ft, n) for n in (9000, 1, 300)]
    _, out, cb = port_compress(words, ft, pb=pb, cks=cks)
    assert_equals_oracle(out, cb, words, ft, pb=pb, cks=cks)
    got, succ, _, _ = port_decompress(out, 9000, ft, pb=pb)
    assert_round_trip(got, succ, words)


@pytest.mark.parametrize("ft", WIDE)
def test_archive_at_an_offset_in_its_row(rng, ft):
    words = [make_float_words(rng, ft, n) for n in (5000, 70)]
    _, out, _ = port_compress(words, ft)
    shifted = np.zeros((2, out.shape[1] + 256), np.uint32)
    shifted[0, 128:128 + out.shape[1]] = out[0]
    shifted[1, 256:] = out[1]
    got, succ, _, _ = port_decompress(shifted, 5000, ft,
                                      base=torch.tensor([128, 256]))
    assert_round_trip(got, succ, words)


@pytest.mark.parametrize("ft", WIDE)
def test_per_member_capacities(rng, ft):
    words = [make_float_words(rng, ft, n) for n in (3000, 5000, 4097)]
    _, out, _ = port_compress(words, ft)
    w, s, n, _, _ = TF.float_decompress_core(
        rows_from_numpy(out), torch.zeros(3, dtype=torch.int64), 5000,
        FloatType(int(ft)), capacities=torch.tensor([3000, 4999, 5000]),
    )
    assert s.tolist() == [True, False, True]
    assert n.tolist() == [3000, 5000, 4097]
    got = rows_to_numpy(w)
    assert not got[1].any()
    assert_round_trip(got[[0, 2]], s.numpy()[[0, 2]], [words[0], words[2]])


def _corrupt64(out, nf, how):
    """Break member 0's fp64 archive (v1 container, nf floats)."""
    out = out.copy()
    first = 8 + nf + (nf + 7) // 8 * 4  # first ANS header word
    second = first + out[0, 4] // 4
    if how == "second_magic":
        out[0, second] ^= 0x10000
    elif how == "word4_past_row":
        out[0, 4] = 4 * out.shape[1]
    elif how == "word4_negative":
        out[0, 4] = 0xFFFFFFF0
    elif how == "word4_into_first":
        out[0, 4] -= 16
    return out


@pytest.mark.parametrize(
    "how", ["second_magic", "word4_past_row", "word4_negative", "word4_into_first"])
def test_corrupt_fp64_archive_fails_without_raising(rng, how):
    ft = JFT.FLOAT64
    words = [make_float_words(rng, ft, n) for n in (9000, 4097)]
    _, out, _ = port_compress(words, ft)
    bad = _corrupt64(out, 9000, how)
    assert (bad != out).any()
    got, succ, _, _ = port_decompress(bad, 9000, ft)
    assert not succ[0] and not got[0].any()
    assert succ[1]
    assert np.array_equal(got.view(np.uint8)[1, : words[1].nbytes],
                          words[1].view(np.uint8))


@pytest.mark.parametrize("ft", [FloatType.FLOAT32, FloatType.FLOAT64])
def test_golden_digest_equals_oracle_and_port(ft):
    w, rows = chip_smoke.golden_input(ft)
    arc = R.float_compress(w, JFT(int(ft)), prob_bits=10, native=True)
    want = chip_smoke.GOLDEN_V2_SHA256[ft]
    assert hashlib.sha256(arc.tobytes()).hexdigest() == want
    out, cb = TF.float_compress_core(
        rows_from_numpy(rows), torch.tensor([w.size]), ft, 10
    )
    assert int(cb[0]) == arc.size
    assert chip_smoke.archive_sha256(out[0], int(cb[0])) == want


@pytest.mark.parametrize("ft", [FloatType.FLOAT32, FloatType.FLOAT64])
def test_float_counts_out_of_range_raise(ft):
    d = torch.zeros((1, 8), dtype=torch.int32)  # 8 fp32 or 4 fp64 floats
    cap = 8 if ft == FloatType.FLOAT32 else 4
    for n in (-1, cap + 1):
        with pytest.raises(ValueError):
            TF.float_compress_core(d, torch.tensor([n]), ft)


@pytest.mark.parametrize("ft", WIDE)
def test_input_rows_at_an_unaligned_address(rng, ft):
    """A view that starts 4 B into its storage compresses as its copy."""
    words = [make_float_words(rng, ft, 5000)]
    d32, out, cb = port_compress(words, ft)
    store = torch.zeros((1, d32.shape[1] + 1), dtype=torch.int32)
    store[:, 1:] = rows_from_numpy(d32)
    view = store[:, 1:]
    assert view.data_ptr() % 16 and view.is_contiguous()
    out2, cb2 = TF.float_compress_core(view, torch.tensor([5000]), FloatType(int(ft)))
    assert int(cb2[0]) == cb[0] and np.array_equal(rows_to_numpy(out2), out)


@pytest.mark.parametrize("W32,ft", [(5, FloatType.FLOAT32), (9, FloatType.FLOAT64),
                                    (12, FloatType.FLOAT64)])
def test_rows_are_padded_as_the_jax_package_pads_them(rng, W32, ft):
    """Rows that are not a multiple of 4 (fp32) or 8 (fp64) words are
    padded, which fixes the capacity and the archive row width."""
    ws = 4 if ft == FloatType.FLOAT32 else 8
    n = W32 * 4 // ws
    w = make_float_words(rng, JFT(int(ft)), n)
    d32 = np.zeros((1, W32), np.uint32)
    d32.view(np.uint8)[0, : w.nbytes] = w.view(np.uint8)
    out, cb = TF.float_compress_core(rows_from_numpy(d32), torch.tensor([n]), ft)
    jout, jcb = jax_enc(jnp.asarray(d32), jnp.asarray([n], jnp.int32),
                        float_type=JFT(int(ft)), prob_bits=10, native=True)
    assert int(cb[0]) == int(np.asarray(jcb)[0])
    assert np.array_equal(rows_to_numpy(out), np.asarray(jout))
