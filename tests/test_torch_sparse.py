"""The port's sparse float codec (plain versions on the CPU) against the
JAX package's ``models/sparse.py`` (its XLA path) and the NumPy oracle:
archives equal byte for byte and in row width, exact round trips, and each
package decoding the other's archives, for the four float types, both ANS
layouts, prob_bits 9 and 10, the checksum on and off, and shares of zeros
from 0 to 1 in ragged batches. Also the tails of a member, -0.0, corrupt
headers and a garbage buffer, and the golden sparse digests of
``chip_smoke.py``, one of them a member whose dense part is a v2
container."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import sparse as JS
from dietgpu_fork_torch.core.constants import FLOAT_WORD_SIZE, FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import sparse as TS
from dietgpu_fork_torch.models.float_codec import FLOAT_MAGIC_VERSION2
from dietgpu_fork_torch.ops.bitmap_pack import bitmap_words
from tests.test_float_jax import pack_rows
from tests.test_sparse_jax import sparse_words
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ALL_FT = [FloatType.FLOAT16, FloatType.BFLOAT16, FloatType.FLOAT32,
          FloatType.FLOAT64]
SIZES = (1, 1000, 4097, 8193)
ZEROS = (0.0, 0.5, 0.9, 1.0)

jenc = jax.jit(JS.sparse_float_compress_core, static_argnames=(
    "float_type", "prob_bits", "use_checksum", "native"))
jdec = jax.jit(JS.sparse_float_decompress_core, static_argnames=(
    "out_floats", "float_type", "prob_bits", "verify_checksum", "native"))


def port_compress(d32, sizes, ft, pb=10, cks=False, native=False):
    out, cb = TS.sparse_float_compress_core(
        rows_from_numpy(d32), torch.tensor(sizes, dtype=torch.int32), ft, pb,
        cks, native=native)
    return rows_to_numpy(out), cb


def port_decompress(out, cap, ft, pb=10, cks=False, native=False):
    return TS.sparse_float_decompress_core(
        rows_from_numpy(out), cap, ft, pb, verify_checksum=cks, native=native)


def decoded_exactly(words32: np.ndarray, words) -> bool:
    """Each row holds its member's bytes, then zeros."""
    u8 = words32.view(np.uint8)
    return all(np.array_equal(u8[i, : w.nbytes], w.view(np.uint8))
               and not u8[i, w.nbytes:].any() for i, w in enumerate(words))


@pytest.mark.parametrize("pb,cks", [(9, True), (10, False)])
@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("ft", ALL_FT)
def test_sparse_archives_equal_jax_and_oracle(rng, ft, native, pb, cks):
    jft = JFT(int(ft))
    # every size at every share of zeros: 16 ragged members
    words = [sparse_words(rng, jft, n, z) for n in SIZES for z in ZEROS]
    sizes = [w.size for w in words]
    S = max(SIZES)
    d32 = pack_rows(words, S, jft)
    out, cb = port_compress(d32, sizes, ft, pb, cks, native)
    jout, jcb = jenc(jnp.asarray(d32), jnp.asarray(sizes, jnp.int32),
                     float_type=jft, prob_bits=pb, use_checksum=cks,
                     native=native)
    jout = np.asarray(jout)
    assert out.shape == jout.shape and np.array_equal(out, jout)
    assert cb.tolist() == np.asarray(jcb).astype(np.int64).tolist()
    for i, w in enumerate(words):
        arc = R.sparse_float_compress(w, jft, prob_bits=pb, use_checksum=cks,
                                      native=native)
        assert int(cb[i]) == arc.size, f"member {i}"
        assert np.array_equal(out[i].view(np.uint8)[: arc.size], arc), f"member {i}"

    # the port decodes its archives and the JAX package's, the JAX package
    # decodes the port's
    ws = FLOAT_WORD_SIZE[ft]
    for rows in (out, jout):
        w32, ok, n, ca, cg = port_decompress(rows, S, ft, pb, cks, native)
        assert bool(ok.all()) and n.tolist() == sizes and torch.equal(ca, cg)
        assert tuple(w32.shape) == (len(words), -(-S * ws // 4))
        assert decoded_exactly(rows_to_numpy(w32), words)
    jw, jok, jn, jca, jcg = jdec(jnp.asarray(out), out_floats=S, float_type=jft,
                                 prob_bits=pb, verify_checksum=cks,
                                 native=native)
    assert np.all(np.asarray(jok)) and np.array_equal(np.asarray(jca),
                                                      np.asarray(jcg))
    assert np.asarray(jw).shape == tuple(w32.shape)
    assert decoded_exactly(np.asarray(jw), words)


@pytest.mark.parametrize("tail", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_sparse_tails_match_oracle(rng, tail):
    # the tails the reference's scan special-case mishandles
    # (tests/test_sparse_jax.py:63-85)
    ft = FloatType.FLOAT32
    w = sparse_words(rng, JFT.FLOAT32, 130, 0.5)
    w[-2:] = np.where(np.array(tail) == 0, 0, np.maximum(w[-2:], 1))
    out, cb = port_compress(pack_rows([w], 130, JFT.FLOAT32), [130], ft)
    arc = R.sparse_float_compress(w, JFT.FLOAT32, prob_bits=10)
    assert int(cb[0]) == arc.size
    assert np.array_equal(out[0].view(np.uint8)[: arc.size], arc)
    w32, ok, _, _, _ = port_decompress(out, 130, ft)
    assert bool(ok[0]) and decoded_exactly(rows_to_numpy(w32), [w])


_NEG_ZERO = {2: 0x8000, 4: 0x80000000, 8: 0x8000000000000000}


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("ft", ALL_FT)
def test_negative_zero_and_half_words_are_nonzero(rng, ft, native):
    """-0.0 is a nonzero word; an fp64 float with one zero u32 half is
    nonzero too."""
    jft = JFT(int(ft))
    ws = FLOAT_WORD_SIZE[ft]
    w = sparse_words(rng, jft, 300, 0.5)
    w[::7] = _NEG_ZERO[ws]
    if ws == 8:
        w[1::11] = 0x1          # hi half zero
        w[2::13] = 1 << 32      # lo half zero
    out, cb = port_compress(pack_rows([w], 300, jft), [300], ft, native=native)
    arc = R.sparse_float_compress(w, jft, prob_bits=10, native=native)
    assert np.array_equal(out[0].view(np.uint8)[: int(cb[0])], arc)
    # the bitmap marks exactly the nonzero words
    bm = out[0, 4: 4 + bitmap_words(300)].view(np.uint8)
    assert np.array_equal(np.unpackbits(bm)[:300].astype(bool), w != 0)
    w32, ok, _, _, _ = port_decompress(out, 300, ft, native=native)
    assert bool(ok[0]) and decoded_exactly(rows_to_numpy(w32), [w])


def test_garbage_and_corrupt_headers_fail_without_raising(rng):
    # tests/test_validation.py:146-154
    garbage = rng.integers(0, 256, 8192, dtype=np.uint8).reshape(1, -1)
    w32, ok, _, _, _ = port_decompress(garbage.view(np.uint32), 2048,
                                       FloatType.FLOAT32)
    assert not bool(ok[0]) and not bool(w32.any())
    # a valid archive whose magic-less float count is negative, too large
    # for the row, or above the capacity
    w = sparse_words(rng, JFT.FLOAT32, 3000, 0.5)
    out, _ = port_compress(pack_rows([w, w], 3000, JFT.FLOAT32), [3000, 3000],
                           FloatType.FLOAT32)
    for bad_n in (0xFFFFFFFF, 0x7FFFFFFF, 3001):
        bad = out.copy()
        bad[0, 0] = bad_n
        w32, ok, n, _, _ = port_decompress(bad, 3000, FloatType.FLOAT32)
        assert ok.tolist() == [False, True]
        assert not bool(w32[0].any())
        assert decoded_exactly(rows_to_numpy(w32)[1:], [w])
        jw, jok, *_ = jdec(jnp.asarray(bad), out_floats=3000,
                           float_type=JFT.FLOAT32, prob_bits=10)
        assert np.asarray(jok).tolist() == ok.tolist()


@pytest.mark.parametrize("key", sorted(chip_smoke.GOLDEN_SPARSE_SHA256))
def test_golden_sparse_archives_match_oracle(key):
    """Each GOLDEN_SPARSE_SHA256 digest is the oracle's archive of its
    input and the port's plain path; fp32 native holds nnz >= 2^20 nonzero
    floats, so its dense part is a v2 container (held to the oracle only:
    the JAX CPU path takes about 15 s at that size)."""
    ft, native, w = chip_smoke.golden_sparse_input(key)
    out, cb = port_compress(chip_smoke.pack_rows([w], w.size), [w.size], ft,
                            native=native)
    arc = R.sparse_float_compress(w, JFT(int(ft)), prob_bits=10, native=native)
    got = out[0].view(np.uint8)[: int(cb[0])]
    assert np.array_equal(got, arc)
    assert hashlib.sha256(arc.tobytes()).hexdigest() == (
        chip_smoke.GOLDEN_SPARSE_SHA256[key])
    dense_magic = int(out[0, 4 + bitmap_words(w.size)])
    assert (dense_magic == FLOAT_MAGIC_VERSION2) == (
        native and int((w != 0).sum()) >= 1 << 20)
    w32, ok, _, _, _ = port_decompress(out, w.size, ft, native=native)
    assert bool(ok[0]) and decoded_exactly(rows_to_numpy(w32), [w])


def test_fp32_native_golden_input_has_a_v2_dense_part():
    ft, native, w = chip_smoke.golden_sparse_input("fp32_native")
    assert ft == FloatType.FLOAT32 and native
    assert int((w != 0).sum()) >= 1 << 20
