"""The classic (0xD00D) layout in the port, plain versions on the CPU, exact:
K2's classic mode vs the JAX package's encode_blocks, K6's and K4's classic
modes vs its decode_blocks (and the 16-bit join), classic ANS archives vs
the NumPy oracle's ans_encode, classic float archives of the four types vs
the oracle and JAX float_compress_core(native=False), always in v1
containers, decoding both ways, and the classic golden digests of
chip_smoke.py."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import float_codec as JF
from dietgpu_fork_tpu.ops.float_split import join_packed
from dietgpu_fork_tpu.ops.rans_decode import decode_blocks
from dietgpu_fork_tpu.ops.rans_encode import encode_blocks
from dietgpu_fork_torch.core.constants import FLOAT_ALIGN_MIN, MAX_BLOCK_WORDS32, FloatType
from dietgpu_fork_torch.core.interop import (
    bytes_from_numpy,
    bytes_to_numpy,
    rows_from_numpy,
    rows_to_numpy,
)
from dietgpu_fork_torch.models import ans as TA
from dietgpu_fork_torch.models import float_codec as TF
from dietgpu_fork_torch.ops import rans_decode as TD
from dietgpu_fork_torch.ops import rans_encode as TE
from dietgpu_fork_torch.ops.bitops import from_u32
from dietgpu_fork_torch.ops.table import build_decode_table_batched
from tests.conftest import make_exponential_bytes, make_float_words
from tests.test_torch_rans import NB, SIZES, _encode_inputs
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FTYPES = [JFT.FLOAT16, JFT.BFLOAT16, JFT.FLOAT32, JFT.FLOAT64]
ANS_SIZES = [0, 1, 4095, 4096, 4097, 3 * 4096 + 5, 9 * 4096 + 100]

jax_fenc = jax.jit(
    JF.float_compress_core,
    static_argnames=("float_type", "prob_bits", "use_checksum", "native"),
)
jax_fdec = jax.jit(
    JF.float_decompress_core,
    static_argnames=("out_floats", "float_type", "prob_bits",
                     "verify_checksum", "native"),
)


def _classic_streams(case, pb):
    x, sizes, pdf, packed, magic = _encode_inputs(case, pb)
    states, streams, num_words = TE.encode_blocks(
        rows_from_numpy(x.view(np.uint32)), torch.from_numpy(sizes), packed,
        magic, pb,
    )
    return x, sizes, pdf, packed, magic, states, streams, num_words


@pytest.mark.parametrize("pb", [9, 10, 11])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_encode_blocks_equals_jax(case, pb):
    x, sizes, _, packed, magic, states, streams, num_words = _classic_streams(case, pb)
    assert streams.shape == (len(sizes), NB, MAX_BLOCK_WORDS32)
    js, jstreams, jnw = encode_blocks(
        jnp.asarray(x.view(np.uint32)), jnp.asarray(sizes),
        jnp.asarray(rows_to_numpy(packed)), jnp.asarray(rows_to_numpy(magic)),
        pb,
    )
    assert np.array_equal(rows_to_numpy(states), np.asarray(js))
    # the JAX CPU path keeps one trailing dump column per block
    assert np.array_equal(rows_to_numpy(streams),
                          np.asarray(jstreams)[:, :, :MAX_BLOCK_WORDS32])
    assert np.array_equal(num_words.numpy(), np.asarray(jnw))


def _staged(case, pb):
    x, sizes, pdf, _, _, states, streams, num_words = _classic_streams(case, pb)
    staged = F.pad(streams, (0, TD.BLOCK_STREAM_CAP - streams.shape[2]))
    blk = np.arange(NB) * 4096
    uncomp = np.clip(sizes[:, None] - blk[None, :], 0, 4096).astype(np.int32)
    lut = from_u32(build_decode_table_batched(pdf, pb))
    return x, sizes, (staged, num_words, torch.from_numpy(uncomp), states, lut)


@pytest.mark.parametrize("pb", [9, 11])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_decode_blocks_equals_jax(case, pb):
    x, sizes, args = _staged(case, pb)
    got = TD.decode_blocks(*args, pb)
    assert got.shape == (len(sizes), NB, 1024)
    staged, comp_w, uncomp_w, states, lut = args
    want = decode_blocks(
        jnp.asarray(rows_to_numpy(staged)), jnp.asarray(comp_w.numpy()),
        jnp.asarray(uncomp_w.numpy()), jnp.asarray(rows_to_numpy(states)),
        jnp.asarray(rows_to_numpy(lut)), pb)
    assert np.array_equal(rows_to_numpy(got), np.asarray(want))
    # the ANS round trip, zero past each member's size
    assert np.array_equal(rows_to_numpy(got).reshape(len(sizes), -1).view(np.uint8), x)


@pytest.mark.parametrize("bf16", [True, False])
def test_decode_join16_blocks_equals_jax_join(bf16):
    x, sizes, args = _staged("multi_block", 10)
    B = len(sizes)
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, (B, NB * 4096)).astype(np.uint8)
    raw[np.arange(NB * 4096)[None, :] >= sizes[:, None]] = 0
    raw32 = raw.view(np.uint32).reshape(B, NB, 1024)
    got = TD.decode_join16_blocks(*args, rows_from_numpy(raw32), 10, bf16)
    assert got.shape == (B, NB, 2048)
    ft = JFT.BFLOAT16 if bf16 else JFT.FLOAT16
    want = join_packed([jnp.asarray(x.view(np.uint32))],
                       [jnp.asarray(raw32.reshape(B, -1))], ft)
    assert np.array_equal(rows_to_numpy(got).reshape(B, -1), np.asarray(want))


@pytest.mark.parametrize("cks", [False, True])
@pytest.mark.parametrize("pb", [9, 10, 11])
def test_classic_ans_archives_equal_oracle(rng, pb, cks):
    data = [make_exponential_bytes(rng, n, lam=8.0) for n in ANS_SIZES]
    S = max(ANS_SIZES)
    buf = np.zeros((len(data), S), np.uint8)
    for i, d in enumerate(data):
        buf[i, : d.size] = d
    comp, cb = TA.ans_encode_padded(bytes_from_numpy(buf),
                                    torch.tensor(ANS_SIZES, dtype=torch.int32),
                                    pb, cks, native=False)
    got = bytes_to_numpy(comp)
    for i, d in enumerate(data):
        want = R.ans_encode(d, pb, cks)
        assert int(cb[i]) == want.size
        assert np.array_equal(got[i, : want.size], want) and not got[i, want.size:].any()
        back, hdr = R.ans_decode(got[i, : want.size])  # the oracle decodes it
        assert np.array_equal(back, d) and not hdr.native
    out, ok, n, csum = TA.ans_decode_padded(comp, S, pb, native=False)
    assert ok.all() and n.tolist() == ANS_SIZES
    for i, d in enumerate(data):
        assert np.array_equal(bytes_to_numpy(out[i, : d.size]), d)
        assert int(csum[i]) == (R.checksum(d) if cks else 0)


def _float_batch(rng, ft, sizes):
    words = [make_float_words(rng, ft, n) for n in sizes]
    return words, chip_smoke.pack_rows(words, max(max(sizes), 1))


def _assert_round_trip(out32, succ, words):
    assert np.all(succ)
    u8 = np.asarray(out32).view(np.uint8)
    for i, w in enumerate(words):
        assert np.array_equal(u8[i, : w.nbytes], w.view(np.uint8)), i
        assert not u8[i, w.nbytes:].any(), i


@pytest.mark.parametrize("ft", FTYPES)
def test_classic_float_archives_equal_jax_oracle_and_cross_decode(rng, ft):
    sizes = [0, 1, 4095, 4096, 4097, 2 * 4096 + 9]
    words, d32 = _float_batch(rng, ft, sizes)
    out, cb = TF.float_compress_core(rows_from_numpy(d32), torch.tensor(sizes),
                                     FloatType(int(ft)), 10, True, native=False)
    jout, jcb = jax_fenc(jnp.asarray(d32), jnp.asarray(sizes, jnp.int32),
                         float_type=ft, prob_bits=10, use_checksum=True,
                         native=False)
    out = rows_to_numpy(out)
    assert out.shape == np.asarray(jout).shape
    assert np.array_equal(out, np.asarray(jout))
    assert np.array_equal(cb.numpy(), np.asarray(jcb).astype(np.int64))
    for i, w in enumerate(words):
        arc = R.float_compress(w, ft, 10, True, native=False)
        assert np.array_equal(out.view(np.uint8)[i, : arc.size], arc)
    cap = max(sizes)
    base = torch.zeros(len(sizes), dtype=torch.int64)
    # the port decodes the JAX package's archives, checksum verified
    w, s, n, ca, cg = TF.float_decompress_core(
        rows_from_numpy(np.asarray(jout)), base, cap, FloatType(int(ft)), 10,
        verify_checksum=True, native=False)
    assert n.tolist() == sizes and torch.equal(ca, cg)
    _assert_round_trip(rows_to_numpy(w), s.numpy(), words)
    # the JAX package decodes the port's
    jw, js, *_ = jax_fdec(jnp.asarray(out), jnp.zeros(len(sizes), jnp.int32),
                          out_floats=cap, float_type=ft, prob_bits=10,
                          native=False)
    _assert_round_trip(jw, js, words)


def test_classic_float_archive_is_a_v1_container(rng):
    """Classic archives stay v1 at n >= FLOAT_ALIGN_MIN: v2 holds native
    members only (the JAX package's float_codec.py:148-150)."""
    n = FLOAT_ALIGN_MIN + 4097
    ft = JFT.BFLOAT16
    w = make_float_words(rng, ft, n)
    out, cb = TF.float_compress_core(rows_from_numpy(chip_smoke.pack_rows([w], n)),
                                     torch.tensor([n]), FloatType.BFLOAT16, 10,
                                     native=False)
    arc = R.float_compress(w, ft, 10, native=False)
    u8 = rows_to_numpy(out).view(np.uint8)[0]
    assert int(cb[0]) == arc.size and np.array_equal(u8[: arc.size], arc)
    back, hdr = R.float_decompress(arc)
    assert not hdr.aligned and np.array_equal(back.view(np.uint8), w.view(np.uint8))


def test_classic_decoder_refuses_native_archives_and_back(rng):
    ft = FloatType.FLOAT16
    words, d32 = _float_batch(rng, JFT.FLOAT16, [5000, 300])
    base = torch.zeros(2, dtype=torch.int64)
    for native in (False, True):
        out, _ = TF.float_compress_core(rows_from_numpy(d32), torch.tensor([5000, 300]),
                                        ft, native=native)
        _, s, *_ = TF.float_decompress_core(out, base, 5000, ft, native=not native)
        assert not s.any()


@pytest.mark.parametrize("key", sorted(chip_smoke.GOLDEN_SHA256))
def test_classic_golden_digests_equal_oracle_and_port(key):
    w, _ = chip_smoke.golden_input(chip_smoke.BF16)
    if key == "bf16_classic":
        arc = R.float_compress(w, JFT.BFLOAT16, 10, native=False)
    else:
        arc = R.ans_encode(w.view(np.uint8), 10, use_checksum=True)
    want = chip_smoke.GOLDEN_SHA256[key]
    assert hashlib.sha256(arc.tobytes()).hexdigest() == want
    row, nbytes = chip_smoke.golden_classic(torch.device("cpu"))[key]
    assert nbytes == arc.size and chip_smoke.bytes_sha256(row, nbytes) == want
