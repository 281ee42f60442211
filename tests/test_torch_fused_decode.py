"""The decode formulations of the port's float codec on the CPU (plain
versions), exact: the two-pass decodes (``fused=False``: K6 then K13 for
16-bit types, K6 then K7 for fp32), which are not the default, equal the
default fused decode (K4, K12), the JAX package's portable decode and the
NumPy oracle in both layouts; fp64 has no fused decode; a corrupt archive
fails alike on every route; and the plain versions of K12 and K13 equal
the JAX package's ``join_packed``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import float_codec as JF
from dietgpu_fork_tpu.ops.float_split import join_packed
from dietgpu_fork_torch.core.constants import FLOAT_ALIGN_MIN, FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import ans as TA
from dietgpu_fork_torch.models import float_codec as TF
from dietgpu_fork_torch.ops import float_split as FS
from dietgpu_fork_torch.ops import rans_decode as TD
from dietgpu_fork_torch.ops.bitops import from_u32
from dietgpu_fork_torch.ops.table import build_decode_table_batched
from tests.conftest import make_exponential_bytes, make_float_words
from tests.test_torch_float_codec import assert_round_trip
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SIZES = [0, 1, 4095, 4096, 4097, 3 * 4096 + 5, 9 * 4096 + 100]
# the formulation that is not the default: two-pass, for 16-bit and fp32
OTHER = {JFT.FLOAT16: False, JFT.BFLOAT16: False, JFT.FLOAT32: False}

jax_dec = jax.jit(
    JF.float_decompress_core,
    static_argnames=("out_floats", "float_type", "prob_bits",
                     "verify_checksum", "native"),
)


def _archive(words, ft, native, cap=None):
    cap = cap or max(max(w.size for w in words), 1)
    n = torch.tensor([w.size for w in words], dtype=torch.int32)
    out, _ = TF.float_compress_core(
        rows_from_numpy(chip_smoke.pack_rows(words, cap)), n,
        FloatType(int(ft)), 10, native=native)
    return rows_to_numpy(out)


def _decode(out, cap, ft, native, fused=None):
    base = torch.zeros(out.shape[0], dtype=torch.int64)
    return TF.float_decompress_core(rows_from_numpy(out), base, cap,
                                    FloatType(int(ft)), 10, native=native,
                                    fused=fused)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ft", sorted(OTHER))
def test_other_formulation_equals_default_and_jax(rng, ft, native):
    words = [make_float_words(rng, ft, n) for n in SIZES]
    out = _archive(words, ft, native)
    cap = max(SIZES)
    got = _decode(out, cap, ft, native, OTHER[ft])
    _assert_same(got, _decode(out, cap, ft, native))
    w = rows_to_numpy(got[0])
    assert_round_trip(w, got[1].numpy(), words)
    assert got[2].tolist() == SIZES
    jw, js, jn, *_ = jax_dec(jnp.asarray(out), jnp.zeros(len(SIZES), jnp.int32),
                             out_floats=cap, float_type=ft, prob_bits=10,
                             native=native)
    jw = np.asarray(jw)
    # the JAX portable 16-bit decode is 2E words wide, the port's n/2
    k = min(w.shape[1], jw.shape[1])
    assert np.array_equal(w[:, :k], jw[:, :k])
    assert not w[:, k:].any() and not jw[:, k:].any()
    assert np.array_equal(got[1].numpy(), np.asarray(js))
    assert np.array_equal(got[2].numpy(), np.asarray(jn).astype(np.int64))


@pytest.mark.parametrize("ft", sorted(OTHER))
def test_other_formulation_of_a_v2_member_equals_oracle(rng, ft):
    n = FLOAT_ALIGN_MIN + 4097
    w = make_float_words(rng, ft, n)
    out = _archive([w], ft, True)
    back, hdr = R.float_decompress(out.view(np.uint8)[0])
    assert hdr.aligned and np.array_equal(back.view(np.uint8), w.view(np.uint8))
    got = _decode(out, n, ft, True, OTHER[ft])
    _assert_same(got, _decode(out, n, ft, True))
    assert_round_trip(rows_to_numpy(got[0]), got[1].numpy(), [w])


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ft", sorted(OTHER))
def test_formulations_plain_equal_default(rng, ft, native):
    """``plain=True`` on each route gives the default decode's words."""
    words = [make_float_words(rng, ft, n) for n in (4097, 300)]
    out = _archive(words, ft, native)
    want = _decode(out, 4097, ft, native)
    for fused in (True, False):
        base = torch.zeros(2, dtype=torch.int64)
        got = TF.float_decompress_core(rows_from_numpy(out), base, 4097,
                                       FloatType(int(ft)), 10, native=native,
                                       plain=True, fused=fused)
        _assert_same(got, want)


def test_fused_fp64_raises(rng):
    w = make_float_words(rng, JFT.FLOAT64, 100)
    out = _archive([w], JFT.FLOAT64, True)
    with pytest.raises(ValueError, match="fp64"):
        _decode(out, 100, JFT.FLOAT64, True, fused=True)
    _assert_same(_decode(out, 100, JFT.FLOAT64, True, fused=False),
                 _decode(out, 100, JFT.FLOAT64, True))


def _corrupt(out, ft, how):
    """Break member 0's archive (a v1 container of 4096 floats)."""
    out = out.copy()
    if how == "float_magic":
        out[0, 0] ^= 0x10000
    elif how == "float_type":
        out[0, 2] ^= 0x3
    elif how == "ans_magic":
        out[0, 8 + (3072 if ft == JFT.FLOAT32 else 1024)] ^= 0x10000
    elif how == "count":
        out[0, 1] = 0x7FFFFFFF
    elif how == "stream":
        out[0, -64:] ^= 0x5A5A5A5A
    return out


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("how", ["float_magic", "float_type", "ans_magic",
                                 "count", "stream"])
@pytest.mark.parametrize("ft", sorted(OTHER))
def test_corrupt_archive_fails_alike_on_every_route(rng, ft, how, native):
    words = [make_float_words(rng, ft, n) for n in (4096, 4097)]
    out = _archive(words, ft, native)
    bad = _corrupt(out, ft, how)
    assert (bad != out).any()
    got = _decode(bad, 4097, ft, native, OTHER[ft])
    _assert_same(got, _decode(bad, 4097, ft, native))
    if how != "stream":
        assert not bool(got[1][0]) and not bool(got[0][0].any())
    assert bool(got[1][1])


def _coded_planes(rng, sizes, native):
    """Exponent-like bytes of each size, ANS-coded and parsed as the
    decoders read them: (byte rows uint8[B, NB*4096], the archive rows
    int32[B, CW], ParsedANS, lut)."""
    NB = max(1, -(-max(sizes) // 4096))
    x = np.zeros((len(sizes), NB * 4096), np.uint8)
    for b, s in enumerate(sizes):
        x[b, :s] = make_exponential_bytes(rng, s, lam=4.0)
    cap = NB * 4096
    out, _ = TA.ans_encode_core(rows_from_numpy(x.view(np.uint32)),
                                torch.tensor(sizes, dtype=torch.int32), 10,
                                s_bytes=cap, native=native)
    p = TA._ans_parse(out, torch.zeros(len(sizes), dtype=torch.int64), cap,
                      None, 10, native)
    return x, out, p, from_u32(build_decode_table_batched(p.pdf, 10))


@pytest.mark.parametrize("native", [True, False])
def test_decode_join32_plain_equals_jax_join_packed(rng, native):
    """The in-place fp32 join (sections after the archives) and its staged
    form, each against the JAX package's join_packed."""
    sizes = [4 * 4096 + 77, 1, 4096, 0, 9000]
    x, arc, p, lut = _coded_planes(rng, sizes, native)
    B, NB = p.comp_w.shape
    sec1 = rng.integers(0, 1 << 32, (B, NB, 2048), dtype=np.uint64).astype(np.uint32)
    sec2 = rng.integers(0, 1 << 32, (B, NB, 1024), dtype=np.uint64).astype(np.uint32)
    words = torch.cat([arc.reshape(-1), rows_from_numpy(sec1).reshape(-1),
                       rows_from_numpy(sec2).reshape(-1)])
    b = torch.arange(B, dtype=torch.int64)
    o1 = arc.numel() + b * NB * 2048
    o2 = arc.numel() + sec1.size + b * NB * 1024
    got = TD.decode_at(words, p.seg_off, p.seg_len, p.comp_w, p.uncomp_w,
                       p.state_off, lut, 10, native, o1, o2)
    assert got.shape == (B, NB, 4096)
    want = np.asarray(join_packed(
        [jnp.asarray(x.view(np.uint32))],
        [jnp.asarray(sec1.reshape(B, -1)), jnp.asarray(sec2.reshape(B, -1))],
        JFT.FLOAT32))
    want = np.where(np.arange(NB * 4096)[None] < np.array(sizes)[:, None], want, 0)
    assert np.array_equal(rows_to_numpy(got).reshape(B, -1), want)
    cap = TD.ROW_STREAM_CAP if native else TD.BLOCK_STREAM_CAP
    streams = TD._stage(words, p.seg_off.reshape(-1), p.seg_len.reshape(-1),
                        cap).reshape(B, -1, cap)
    states = TD._stage(words, p.state_off, 32 * NB).reshape(B, NB, 32)
    fn = TD.decode_join32 if native else TD.decode_join32_blocks
    staged = fn(streams, p.comp_w, p.uncomp_w, states, lut,
                rows_from_numpy(sec1), rows_from_numpy(sec2), 10)
    assert torch.equal(staged, got)


@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("ft", [JFT.FLOAT16, JFT.BFLOAT16])
def test_join16_rows_plain_equals_jax_join_packed(rng, ft, extra):
    B, E = 3, 1025
    exp = rng.integers(0, 1 << 32, (B, E), dtype=np.uint64).astype(np.uint32)
    raw = rng.integers(0, 1 << 32, (B, E + extra), dtype=np.uint64).astype(np.uint32)
    bf16 = ft == JFT.BFLOAT16
    got = FS.join16_rows(rows_from_numpy(exp), rows_from_numpy(raw), bf16)
    assert got.shape == (B, 2 * E)
    want = join_packed([jnp.asarray(exp)], [jnp.asarray(raw[:, :E])], ft)
    assert np.array_equal(rows_to_numpy(got), np.asarray(want))
    assert torch.equal(got, FS.join16_rows_plain(rows_from_numpy(exp),
                                                 rows_from_numpy(raw), bf16))
