"""The rANS decode reading the archive in place (``ops.rans_decode.decode_at``,
K4 / K6 / K12's contract) against the staged form it replaced and the JAX
package's functions, bit for bit: both layouts, the three epilogues,
prob_bits 9-11, archives at word offsets that are not 16 B aligned, odd
stream lengths, ragged batches with dead members, and corrupted blockWords
and stream words, on which staged and in-place must give the same bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.ops.float_split import join_packed
from dietgpu_fork_tpu.ops.rans_decode import decode_blocks, decode_blocks_rows
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import ans as TA
from dietgpu_fork_torch.models import float_codec as TF
from dietgpu_fork_torch.ops import rans_decode as TD
from dietgpu_fork_torch.ops.bitops import from_u32
from dietgpu_fork_torch.ops.table import build_decode_table_batched
from tests.conftest import make_exponential_bytes, make_float_words
from tests.test_torch_threads import one_torch_thread  # noqa: F401

NB = 4
CAP = NB * 4096
SIZES = [0, 1, 4097, 3 * 4096 + 77]
# each member's archive sits at this word offset of its row: none of the
# nonzero ones is 16 B aligned
BASES = [0, 1, 2, 5]
EPILOGUES = ("bytes", "join16", "join32")


def _archives(rng, sizes, bases, native, pb, lam=4.0):
    """Exponent-like bytes of each size, ANS-coded by the port and placed at
    word offset bases[b] of row b: (bytes uint8[B, CAP], rows int32[B, CW])."""
    x = np.zeros((len(sizes), CAP), np.uint8)
    for b, s in enumerate(sizes):
        x[b, :s] = make_exponential_bytes(rng, s, lam=lam)
    out, cb = TA.ans_encode_core(rows_from_numpy(x.view(np.uint32)),
                                 torch.tensor(sizes, dtype=torch.int32), pb,
                                 s_bytes=CAP, native=native)
    arc = rows_to_numpy(out)
    rows = np.zeros((len(sizes), arc.shape[1] + max(bases) + 3), np.uint32)
    for b, o in enumerate(bases):
        rows[b, o: o + arc.shape[1]] = arc[b]
    return x, rows


def _sections(rng, B, epi):
    """Random raw sections of the epilogue (block-major, uint32)."""
    if epi == "join16":
        return [rng.integers(0, 1 << 32, (B, NB * 1024), dtype=np.uint64).astype(np.uint32)]
    if epi == "join32":
        return [rng.integers(0, 1 << 32, (B, NB * w), dtype=np.uint64).astype(np.uint32)
                for w in (2048, 1024)]
    return []


def _decode_both(rows, bases, native, pb, secs):
    """The in-place decode of every member (raw sections laid after the
    archive rows) and the staged form it replaced: the streams, states and
    sections staged start-aligned by the merge, then the staged walk."""
    comp32 = rows_from_numpy(rows)
    B = comp32.shape[0]
    p = TA._ans_parse(comp32, torch.tensor(bases), CAP, None, pb, native)
    lut = from_u32(build_decode_table_batched(p.pdf, pb))
    words = torch.cat([comp32.reshape(-1)]
                      + [rows_from_numpy(s).reshape(-1) for s in secs])
    offs, at = [], comp32.numel()
    for s in secs:
        offs.append(at + torch.arange(B, dtype=torch.int64) * s.shape[1])
        at += s.size
    offs += [None] * (2 - len(offs))
    got = TD.decode_at(words, p.seg_off, p.seg_len, p.comp_w, p.uncomp_w,
                       p.state_off, lut, pb, native, offs[0], offs[1], True)

    SW = TD.ROW_STREAM_CAP if native else TD.BLOCK_STREAM_CAP
    streams = TD._stage(words, p.seg_off.reshape(-1), p.seg_len.reshape(-1),
                        SW).reshape(B, -1, SW)
    states = TD._stage(words, p.state_off, 32 * NB).reshape(B, NB, 32)
    staged = [rows_from_numpy(s).reshape(B, NB, -1) for s in secs]
    args = (streams, p.comp_w, p.uncomp_w, states, lut)
    if not secs:
        fn = TD.decode_rows_plain if native else TD.decode_blocks_plain
        want = fn(*args, pb)
    elif len(secs) == 1:
        fn = TD.decode_join16_plain if native else TD.decode_join16_blocks_plain
        want = fn(*args, staged[0], pb, True)
    else:
        fn = TD.decode_join32_plain if native else TD.decode_join32_blocks_plain
        want = fn(*args, *staged, pb)
    return got, want, p, args


@pytest.mark.parametrize("pb", [9, 10, 11])
@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("native", [True, False])
def test_in_place_equals_staged_and_jax(rng, native, epi, pb):
    x, rows = _archives(rng, SIZES, BASES, native, pb)
    secs = _sections(rng, len(SIZES), epi)
    got, want, p, args = _decode_both(rows, BASES, native, pb, secs)
    assert torch.equal(got, want)
    assert bool(p.success.all())
    B = len(SIZES)
    keep = np.arange(CAP)[None] < np.array(SIZES)[:, None]
    if epi == "bytes":
        jfn = decode_blocks_rows if native else decode_blocks
        streams, comp_w, uncomp_w, states, lut = args
        ref = np.asarray(jfn(jnp.asarray(rows_to_numpy(streams)),
                             jnp.asarray(comp_w.numpy()),
                             jnp.asarray(uncomp_w.numpy()),
                             jnp.asarray(rows_to_numpy(states)),
                             jnp.asarray(rows_to_numpy(lut)), pb))
        assert np.array_equal(rows_to_numpy(got), ref)
        assert np.array_equal(rows_to_numpy(got).reshape(B, -1).view(np.uint8), x)
        return
    ft = JFT.BFLOAT16 if epi == "join16" else JFT.FLOAT32
    ref = np.asarray(join_packed([jnp.asarray(x.view(np.uint32))],
                                 [jnp.asarray(s) for s in secs], ft))
    if epi == "join16":  # two floats a word: zero the halves past each size
        halves = ref.reshape(B, -1).view(np.uint16).copy()
        halves[~keep] = 0
        ref = halves.view(np.uint32)
    else:
        ref = np.where(keep, ref, 0)
    assert np.array_equal(rows_to_numpy(got).reshape(B, -1), ref)


@pytest.mark.parametrize("native", [True, False])
def test_odd_stream_lengths_are_read(rng, native):
    """Streams of an odd number of u16 words end mid-word: the in-place read
    of the last word equals the staged one."""
    sizes = [37, 4096 + 3, 2 * 4096 + 1000, 5]
    x, rows = _archives(rng, sizes, [3, 0, 7, 2], native, 10, lam=9.0)
    got, want, p, _ = _decode_both(rows, [3, 0, 7, 2], native, 10, [])
    group = 4 if native else 1
    seg_words = p.comp_w.to(torch.int64).reshape(len(sizes), -1)
    seg_words = torch.nn.functional.pad(
        seg_words, (0, -seg_words.shape[1] % group)).reshape(len(sizes), -1, group).sum(-1)
    assert bool((seg_words % 2 == 1).any())
    assert torch.equal(got, want)
    assert np.array_equal(rows_to_numpy(got).reshape(len(sizes), -1).view(np.uint8), x)


def _corrupt(rows, bases, how):
    rows = rows.copy()
    b0 = bases[2]  # member 2, 4097 bytes: two blocks
    nb = 2
    bw_off = 136 + 32 * nb
    data_off = bw_off + 2 * nb
    if how == "magic":
        rows[2, b0] ^= 0x10000
    elif how == "blockwords_count":
        rows[2, b0 + bw_off] ^= 0x3  # block 0's u16 word count
    elif how == "blockwords_start":
        rows[2, b0 + bw_off + 3] += 8  # block 1's start
    elif how == "stream":
        rows[2, b0 + data_off: b0 + data_off + 40] ^= 0x5A5A5A5A
    elif how == "state":
        rows[2, b0 + 136 + 5] ^= 0x00FF00FF
    return rows


@pytest.mark.parametrize("how", ["magic", "blockwords_count", "blockwords_start",
                                 "stream", "state"])
@pytest.mark.parametrize("native", [True, False])
def test_corrupt_and_dead_members_staged_equals_in_place(rng, native, how):
    """A corrupted member and a ragged batch with dead ones (size 0, a
    failed header): staged and in-place give the same bytes, fused too."""
    x, rows = _archives(rng, SIZES, BASES, native, 10)
    bad = _corrupt(rows, BASES, how)
    assert (bad != rows).any()
    for epi in EPILOGUES:
        secs = _sections(rng, len(SIZES), epi)
        got, want, p, _ = _decode_both(bad, BASES, native, 10, secs)
        assert torch.equal(got, want), epi
        assert bool(p.success[3]) and bool(p.success[0])
        if how == "magic":
            assert not bool(p.success[2]) and not bool(got[2].any())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ft", [JFT.BFLOAT16, JFT.FLOAT32])
def test_float_decode_at_unaligned_base_equals_aligned(rng, ft, native, fused):
    """Float archives 1-3 words past a 16 B boundary of their rows decode
    (fused: raw sections read in place) to the aligned decode's words."""
    sizes = [4097, 300, 0]
    words = [make_float_words(rng, ft, n) for n in sizes]
    cap = max(sizes)
    ws = {JFT.BFLOAT16: 2, JFT.FLOAT32: 4}[ft]
    buf = np.zeros((len(sizes), -(-cap * ws // 4) * 4), np.uint8)
    for i, w in enumerate(words):
        buf[i, : w.nbytes] = w.view(np.uint8)
    n = torch.tensor(sizes, dtype=torch.int32)
    arc, _ = TF.float_compress_core(rows_from_numpy(buf.view(np.uint32)), n,
                                    FloatType(int(ft)), 10, native=native)
    want = TF.float_decompress_core(arc, torch.zeros(len(sizes), dtype=torch.int64),
                                    cap, FloatType(int(ft)), 10, native=native,
                                    fused=fused)
    shifts = [1, 2, 3]
    wide = torch.zeros((len(sizes), arc.shape[1] + 4), dtype=torch.int32)
    for i, s in enumerate(shifts):
        wide[i, s: s + arc.shape[1]] = arc[i]
    got = TF.float_decompress_core(wide, torch.tensor(shifts), cap,
                                   FloatType(int(ft)), 10, native=native,
                                   fused=fused)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[1].all())


def _parsed_args(rng, native=True):
    x, rows = _archives(rng, [5000, 10], [0, 1], native, 10)
    comp32 = rows_from_numpy(rows)
    p = TA._ans_parse(comp32, torch.tensor([0, 1]), CAP, None, 10, native)
    lut = from_u32(build_decode_table_batched(p.pdf, 10))
    return [comp32.reshape(-1), p.seg_off, p.seg_len, p.comp_w, p.uncomp_w,
            p.state_off, lut]


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: [a[0].to(torch.int64)] + a[1:],  # words not int32
        lambda a: [a[0][:0]] + a[1:],  # no words
        lambda a: a[:1] + [a[1].to(torch.int32)] + a[2:],  # seg_off not int64
        lambda a: a[:2] + [a[2][:, :0]] + a[3:],  # seg_len of the wrong width
        lambda a: a[:5] + [a[5][:1]] + a[6:],  # state_off of the wrong batch
        lambda a: a[:6] + [a[6][:, :100]],  # lut of the wrong size
    ],
)
def test_decode_at_rejects_bad_arguments(rng, bad):
    with pytest.raises((TypeError, ValueError)):
        TD.decode_at(*bad(_parsed_args(rng)), 10)


def test_decode_at_fp32_join_needs_sec1(rng):
    a = _parsed_args(rng)
    with pytest.raises(ValueError):
        TD.decode_at(*a, 10, True, None, a[5])


@pytest.mark.parametrize("native", [True, False])
def test_staged_form_refuses_rows_past_the_stream_cap(rng, native):
    """A staged tensor wider than the decode's stream cap cannot be read in
    place as it was staged: the staged form refuses it."""
    a = _parsed_args(rng, native)
    B, NB_ = a[3].shape
    cap = TD.ROW_STREAM_CAP if native else TD.BLOCK_STREAM_CAP
    nseg = -(-NB_ // 4) if native else NB_
    streams = torch.zeros((B, nseg, cap + 1), dtype=torch.int32)
    states = torch.zeros((B, NB_, 32), dtype=torch.int32)
    fn = TD.decode_rows if native else TD.decode_blocks
    with pytest.raises(ValueError, match="stream cap"):
        fn(streams, a[3], a[4], states, a[6], 10)
