"""The port's 16-bit float codec end to end (plain versions on the CPU) vs
the JAX package and the NumPy oracle: byte-identical archives in v1 and v2
containers, exact round trips, cross-decoding both ways, and corrupt
archives failing without raising."""

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
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FT16 = [JFT.BFLOAT16, JFT.FLOAT16]
SIZES = [0, 1, 4095, 4096, 4097, 5 * 4096 + 3]
V2_SIZES = [FLOAT_ALIGN_MIN + 100, FLOAT_ALIGN_MIN + 4097]

jax_enc = jax.jit(
    JF.float_compress_core,
    static_argnames=("float_type", "prob_bits", "use_checksum", "native"),
)
jax_dec = jax.jit(
    JF.float_decompress_core,
    static_argnames=("out_floats", "float_type", "prob_bits",
                     "verify_checksum", "native"),
)


def port_compress(words_list, ft, pb=10, cks=False, cap=None):
    cap = cap or max(max(w.size for w in words_list), 1)
    d32 = chip_smoke.pack_rows(words_list, cap)
    n = torch.tensor([w.size for w in words_list], dtype=torch.int32)
    out, cb = TF.float_compress_core(
        rows_from_numpy(d32), n, FloatType(int(ft)), pb, use_checksum=cks
    )
    return d32, rows_to_numpy(out), cb.numpy()


def port_decompress(comp32, out_floats, ft, pb=10, base=None):
    B = comp32.shape[0]
    base = torch.zeros(B, dtype=torch.int64) if base is None else base
    w, s, n, ca, _ = TF.float_decompress_core(
        rows_from_numpy(comp32), base, out_floats, FloatType(int(ft)), pb
    )
    return rows_to_numpy(w), s.numpy(), n.numpy(), ca.numpy()


def assert_round_trip(out32, succ, words_list):
    assert succ.all()
    u8 = out32.view(np.uint8)
    for i, w in enumerate(words_list):
        assert np.array_equal(u8[i, : w.nbytes], w.view(np.uint8)), i
        assert not u8[i, w.nbytes:].any(), i


@pytest.mark.parametrize("ft", FT16)
def test_ragged_batch_equals_jax_and_cross_decodes(rng, ft):
    words = [make_float_words(rng, ft, n) for n in SIZES]
    d32, out, cb = port_compress(words, ft)
    jout, jcb = jax_enc(jnp.asarray(d32), jnp.asarray(SIZES, jnp.int32),
                        float_type=ft, prob_bits=10, native=True)
    assert np.array_equal(cb, np.asarray(jcb).astype(np.int64))
    assert np.array_equal(out, np.asarray(jout))

    cap = max(SIZES)
    # the port decodes the JAX package's archives
    got, succ, n, _ = port_decompress(np.asarray(jout), cap, ft)
    assert np.array_equal(n, SIZES)
    assert_round_trip(got, succ, words)
    # the JAX package decodes the port's archives
    jw, js, *_ = jax_dec(jnp.asarray(out), jnp.zeros(len(SIZES), jnp.int32),
                         out_floats=cap, float_type=ft, prob_bits=10,
                         native=True)
    assert_round_trip(np.asarray(jw), np.asarray(js), words)


@pytest.mark.parametrize("n", SIZES + V2_SIZES)
@pytest.mark.parametrize("ft", FT16)
def test_single_member_equals_oracle(rng, ft, n):
    w = make_float_words(rng, ft, n)
    _, out, cb = port_compress([w], ft)
    arc = R.float_compress(w, ft, prob_bits=10, native=True)
    assert cb[0] == arc.size
    u8 = out.view(np.uint8)[0]
    assert np.array_equal(u8[: arc.size], arc) and not u8[arc.size:].any()
    # the oracle decodes the port's archive; the port round-trips it
    back, hdr = R.float_decompress(u8[: cb[0]])
    assert np.array_equal(back.view(np.uint8), w.view(np.uint8))
    assert hdr.aligned == (n >= FLOAT_ALIGN_MIN)
    got, succ, _, _ = port_decompress(out, max(n, 1), ft)
    assert_round_trip(got, succ, [w])


def test_v1_and_v2_members_in_one_batch(rng):
    ft = JFT.BFLOAT16
    words = [make_float_words(rng, ft, n)
             for n in (FLOAT_ALIGN_MIN + 100, FLOAT_ALIGN_MIN - 64, 3)]
    _, out, cb = port_compress(words, ft, cks=True)
    for i, w in enumerate(words):
        arc = R.float_compress(w, ft, prob_bits=10, use_checksum=True,
                               native=True)
        assert cb[i] == arc.size
        assert np.array_equal(out.view(np.uint8)[i, : arc.size], arc)
    got, succ, _, csum = port_decompress(out, FLOAT_ALIGN_MIN + 100, ft)
    assert_round_trip(got, succ, words)
    assert [int(c) for c in csum] == [R.checksum(w.view(np.uint8)) for w in words]


@pytest.mark.parametrize("pb", [9, 11])
@pytest.mark.parametrize("cks", [False, True])
def test_prob_bits_and_checksum_equal_oracle(rng, pb, cks):
    ft = JFT.FLOAT16
    words = [make_float_words(rng, ft, n) for n in (9000, 1, 300)]
    _, out, cb = port_compress(words, ft, pb=pb, cks=cks)
    for i, w in enumerate(words):
        arc = R.float_compress(w, ft, prob_bits=pb, use_checksum=cks,
                               native=True)
        assert cb[i] == arc.size
        assert np.array_equal(out.view(np.uint8)[i, : arc.size], arc)
    got, succ, _, _ = port_decompress(out, 9000, ft, pb=pb)
    assert_round_trip(got, succ, words)


def test_archive_at_an_offset_in_its_row(rng):
    ft = JFT.BFLOAT16
    words = [make_float_words(rng, ft, n) for n in (5000, 70)]
    _, out, _ = port_compress(words, ft)
    shifted = np.zeros((2, out.shape[1] + 256), np.uint32)
    shifted[0, 128:128 + out.shape[1]] = out[0]
    shifted[1, 256:] = out[1]
    got, succ, _, _ = port_decompress(shifted, 5000, ft,
                                      base=torch.tensor([128, 256]))
    assert_round_trip(got, succ, words)


def test_capacity_too_small_fails(rng):
    ft = JFT.BFLOAT16
    w = make_float_words(rng, ft, 5000)
    _, out, _ = port_compress([w], ft)
    got, succ, n, _ = port_decompress(out, 4096, ft)
    assert not succ[0] and n[0] == 5000 and not got.any()


def test_per_member_capacities(rng):
    ft = JFT.FLOAT16
    words = [make_float_words(rng, ft, n) for n in (3000, 5000, 4097)]
    _, out, _ = port_compress(words, ft)
    w, s, n, _, _ = TF.float_decompress_core(
        rows_from_numpy(out), torch.zeros(3, dtype=torch.int64), 5000,
        FloatType.FLOAT16, capacities=torch.tensor([3000, 4999, 5000]),
    )
    assert s.tolist() == [True, False, True]
    assert n.tolist() == [3000, 5000, 4097]
    got = rows_to_numpy(w)
    assert not got[1].any()
    assert_round_trip(got[[0, 2]], s.numpy()[[0, 2]], [words[0], words[2]])


def _corrupt(out, nf, how):
    """Break one member's archive (v1 container, n floats = nf)."""
    out = out.copy()
    ans = 8 + (nf + 15) // 16 * 4  # ANS header word of a v1 member
    nb = -(-nf // 4096)
    if how == "float_magic":
        out[0, 0] ^= 1
    elif how == "float_type":
        out[0, 2] = int(JFT.FLOAT16)
    elif how == "ans_magic":
        out[0, ans] ^= 0x10000
    elif how == "prob_bits":
        out[0, ans + 4] = 9
    elif how == "block_words_past_total":
        bw = ans + 136 + 32 * nb
        out[0, bw] = (out[0, bw] & 0xFFFF0000) | 0xFFF
    elif how == "block_uncomp":
        bw = ans + 136 + 32 * nb
        out[0, bw] -= 1 << 16
    elif how == "truncated":
        out = out[:, : ans + 136 + 32 * nb + 40]
    return out


@pytest.mark.parametrize(
    "how",
    ["float_magic", "float_type", "ans_magic", "prob_bits",
     "block_words_past_total", "block_uncomp", "truncated"],
)
def test_corrupt_archive_fails_without_raising(rng, how):
    ft = JFT.BFLOAT16
    words = [make_float_words(rng, ft, n) for n in (9000, 4097)]
    _, out, _ = port_compress(words, ft)
    bad = _corrupt(out, 9000, how)
    got, succ, _, _ = port_decompress(bad, 9000, ft)
    assert not succ[0] and not got[0].any()
    if how != "truncated":
        assert succ[1]
        assert np.array_equal(got.view(np.uint8)[1, : words[1].nbytes],
                              words[1].view(np.uint8))


def test_unported_options_raise():
    """Every option is ported now: the classic layout, verify_checksum and
    the sparse codec take a tiny input; what no codec takes still raises."""
    from dietgpu_fork_torch.api import codec as C

    d = torch.zeros((1, 8), dtype=torch.int32)
    n = torch.tensor([4], dtype=torch.int32)
    for ft in (FloatType.FLOAT32, FloatType.BFLOAT16):
        out, cb = TF.float_compress_core(d, n, ft, native=False)
        assert int(rows_to_numpy(out)[0, 0]) == (0xF00F << 16) | 1
        w, s, _, ca, cg = TF.float_decompress_core(
            out, torch.zeros(1), 4, ft, verify_checksum=True, native=False)
        assert bool(s[0]) and torch.equal(ca, cg) and not w.any()
    comp, _, _ = C.compress_data(True, [torch.zeros(4)], sparse=True)
    outs, _, ok, _, _ = C.decompress_data(True, comp, [4], torch.float32,
                                          sparse=True)
    assert bool(ok.all()) and torch.equal(outs[0], torch.zeros(4))
    with pytest.raises(ValueError, match="unsupported float dtype"):
        C.compress_data(True, [torch.zeros(4, dtype=torch.int64)], sparse=True)


@pytest.mark.parametrize("n", [-1, 17])
def test_float_counts_out_of_range_raise(n):
    d = torch.zeros((1, 8), dtype=torch.int32)  # room for 16 floats
    with pytest.raises(ValueError):
        TF.float_compress_core(d, torch.tensor([n]), FloatType.BFLOAT16)


def test_golden_digest_equals_oracle_and_port():
    w, rows = chip_smoke.golden_input()
    arc = R.float_compress(w, JFT.BFLOAT16, prob_bits=10, native=True)
    want = chip_smoke.GOLDEN_V2_SHA256[FloatType.BFLOAT16]
    assert hashlib.sha256(arc.tobytes()).hexdigest() == want
    out, cb = TF.float_compress_core(
        rows_from_numpy(rows), torch.tensor([w.size]), FloatType.BFLOAT16, 10
    )
    assert int(cb[0]) == arc.size
    assert chip_smoke.archive_sha256(out[0], int(cb[0])) == want
