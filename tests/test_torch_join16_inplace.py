"""K13's archive mode (``ops.float_split.join16_at``: the raw section read
from the archive in place, below a per-member count) and the 16-bit
two-pass decode built on it, on the CPU (plain versions) against the JAX
package, bit for bit: archives compressed by the JAX package, decoded by
its two-pass decode (staging merge, then join_packed, which is what its
CPU path runs) and by the port's ``float_decompress_core(fused=False)``,
in bf16 and fp16, v1 and v2 containers, native and classic, at word
offsets 1-3 in wider rows, with counts 0, 1, 2, 3, 5, 4095, 4097 and the
capacity, failed members, a header whose count runs past the row and
non-zero bytes past n in the raw section's last word; then both of K13's
modes on ``chip_smoke.py``'s K13 edge inputs against a NumPy gather
joined by the JAX package's join_packed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import float_codec as JF
from dietgpu_fork_tpu.ops import float_split as JS
from dietgpu_fork_torch.core.constants import FLOAT_ALIGN_MIN, FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import float_codec as TF
from dietgpu_fork_torch.ops import float_split as TS
from tests.conftest import make_float_words
from tests.test_torch_threads import one_torch_thread  # noqa: F401

HALF = [JFT.BFLOAT16, JFT.FLOAT16]
# counts 0, 1, 2 and 3 (inside a word), 5, around the 4096-float tile, and
# the capacity, whose plane rows are an odd number of words (3073)
CAP = 3 * 4096 + 2
SIZES = [0, 1, 2, 3, 5, 4095, 4097, CAP]
# each member's archive starts this many words into its row
SHIFTS = [1, 2, 3, 0, 3, 1, 2, 3]

jax_enc = jax.jit(
    JF.float_compress_core,
    static_argnames=("float_type", "prob_bits", "use_checksum", "native"),
)
jax_dec = jax.jit(
    JF.float_decompress_core,
    static_argnames=("out_floats", "float_type", "prob_bits",
                     "verify_checksum", "native"),
)


def _shifted(arc: np.ndarray, shifts) -> np.ndarray:
    """Each member's archive row placed shifts[b] words into a row 4 words
    wider, zeros around it."""
    rows = np.zeros((arc.shape[0], arc.shape[1] + 4), np.uint32)
    for b, s in enumerate(shifts):
        rows[b, s: s + arc.shape[1]] = arc[b]
    return rows


def _jax_archives(words, ft, native, cap, cks=False):
    d32 = chip_smoke.pack_rows(words, cap)
    out, _ = jax_enc(jnp.asarray(d32), jnp.asarray([w.size for w in words], jnp.int32),
                     float_type=ft, prob_bits=10, use_checksum=cks, native=native)
    return np.asarray(out)


def _decode(rows, shifts, cap, ft, native, capacities=None, cks=False,
            fused=False):
    tcap = None if capacities is None else torch.tensor(capacities, dtype=torch.int64)
    return TF.float_decompress_core(
        rows_from_numpy(rows), torch.tensor(shifts, dtype=torch.int64), cap,
        FloatType(int(ft)), 10, capacities=tcap, verify_checksum=cks,
        native=native, fused=fused)


def _both(rows, shifts, cap, ft, native, capacities=None, cks=False):
    """(JAX two-pass decode, the port's two-pass decode) of rows at word
    offsets shifts: each (words uint32, success, n, archive checksum,
    decoded checksum) as NumPy arrays. The JAX words are 2E wide, the
    port's ceil(cap / 2)."""
    jcap = None if capacities is None else jnp.asarray(capacities, jnp.int32)
    j = jax_dec(jnp.asarray(rows), jnp.asarray(shifts, jnp.int32), out_floats=cap,
                float_type=ft, prob_bits=10, verify_checksum=cks, native=native,
                capacities=jcap)
    t = _decode(rows, shifts, cap, ft, native, capacities, cks)
    assert t[0].is_contiguous() and t[0].shape[1] == -(-cap // 2)
    jn = [np.asarray(x) for x in j]
    tn = [rows_to_numpy(t[0])] + [x.numpy() for x in t[1:]]
    return jn, tn


def _assert_same(jn, tn):
    words_j, succ_j, n_j, ca_j, cg_j = jn
    words_t, succ_t, n_t, ca_t, cg_t = tn
    k = words_t.shape[1]
    assert words_j.shape[1] >= k
    assert np.array_equal(words_t, words_j[:, :k])
    assert not words_j[:, k:].any()
    assert np.array_equal(succ_t, succ_j)
    assert np.array_equal(n_t, n_j.astype(np.int64))
    assert np.array_equal(ca_t, ca_j.astype(np.int64))
    assert np.array_equal(cg_t, cg_j.astype(np.int64))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ft", HALF)
def test_two_pass_at_word_offsets_equals_jax(rng, ft, native):
    words = [make_float_words(rng, ft, n) for n in SIZES]
    rows = _shifted(_jax_archives(words, ft, native, CAP, cks=True), SHIFTS)
    jn, tn = _both(rows, SHIFTS, CAP, ft, native, cks=True)
    _assert_same(jn, tn)
    assert tn[1].all()
    u8 = tn[0].view(np.uint8)
    for b, w in enumerate(words):
        assert np.array_equal(u8[b, : w.nbytes], w.view(np.uint8)), b
        assert not u8[b, w.nbytes:].any(), b
    assert np.array_equal(tn[3], tn[4])  # the checksums agree
    # the default (fused) decode gives the same words
    fused = _decode(rows, SHIFTS, CAP, ft, native, fused=None)
    assert np.array_equal(rows_to_numpy(fused[0]), tn[0])


@pytest.mark.parametrize("ft", HALF)
def test_two_pass_v2_container_at_word_offset_equals_jax(rng, ft):
    """A v2 container (the raw section on a 512 B boundary of the archive)
    next to a v1 member, both 1-3 words off 16 B."""
    sizes = [FLOAT_ALIGN_MIN + 4097, 13]
    words = [make_float_words(rng, ft, n) for n in sizes]
    cap = max(sizes)
    rows = _shifted(_jax_archives(words, ft, True, cap), [3, 1])
    assert rows[0, 3] == TF.FLOAT_MAGIC_VERSION2 and rows[1, 1] == TF.FLOAT_MAGIC_VERSION
    jn, tn = _both(rows, [3, 1], cap, ft, True)
    _assert_same(jn, tn)
    assert tn[1].all()
    for b, w in enumerate(words):
        assert np.array_equal(tn[0][b].view(np.uint16)[: w.size], w), b


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ft", HALF)
def test_failed_members_decode_to_zeros(rng, ft, native):
    """A bad magic and a count above the member's capacity fail the member,
    whose words are all zero; the others are unchanged."""
    words = [make_float_words(rng, ft, n) for n in SIZES]
    rows = _shifted(_jax_archives(words, ft, native, CAP), SHIFTS)
    rows[1, SHIFTS[1]] ^= 0x10000  # member 1's magic
    capacities = [CAP] * len(SIZES)
    capacities[6] = SIZES[6] - 1  # member 6's count passes its capacity
    jn, tn = _both(rows, SHIFTS, CAP, ft, native, capacities=capacities)
    _assert_same(jn, tn)
    assert list(np.flatnonzero(~tn[1])) == [1, 6]
    assert not tn[0][[1, 6]].any()
    assert tn[0][7].any()


@pytest.mark.parametrize("ft", HALF)
def test_header_count_past_the_row_reads_nothing_outside(rng, ft):
    """The last member's header claims the largest count the decode takes,
    so its raw section would run past the end of the archive: it fails and
    decodes to zeros, and the port agrees with the JAX package."""
    words = [make_float_words(rng, ft, n) for n in SIZES]
    cap = 8 * CAP
    rows = _shifted(_jax_archives(words, ft, True, CAP), SHIFTS)
    rows[-1, SHIFTS[-1] + 1] = cap  # header word 1: n
    jn, tn = _both(rows, SHIFTS, cap, ft, True)
    _assert_same(jn, tn)
    assert not tn[1][-1] and not tn[0][-1].any()
    assert tn[1][:-1].all()


@pytest.mark.parametrize("ft", HALF)
def test_tail_bytes_past_the_count_decode_to_zeros(rng, ft):
    """Non-zero bytes past n in the raw section's last word, which the
    compressor never writes: the JAX two-pass decode joins them into the
    floats past n, the port's writes zeros there (K13 reads nothing at or
    past the count), as its fused decode does. Below n, the flags, counts
    and checksums agree with the JAX package's."""
    sizes = [5, 4099, 3]  # the raw section ends inside a word
    shifts = [1, 2, 3]
    words = [make_float_words(rng, ft, n) for n in sizes]
    cap = max(sizes) + 8  # room past every count
    rows = _shifted(_jax_archives(words, ft, True, cap, cks=True), shifts)
    for b, (s, n) in enumerate(zip(shifts, sizes)):
        rows[b, s + 8 + n // 4] |= np.uint32((0xEEEEEEEE << (8 * (n % 4))) & 0xFFFFFFFF)
    jn, tn = _both(rows, shifts, cap, ft, True, cks=True)
    k = tn[0].shape[1]
    j16 = jn[0][:, :k].view(np.uint16)
    keep = np.arange(2 * k)[None] < np.asarray(sizes)[:, None]
    assert np.array_equal(tn[0].view(np.uint16), np.where(keep, j16, 0))
    assert np.where(keep, 0, j16).any(axis=1).all()  # JAX kept the tails
    for j, t in zip(jn[1:], tn[1:]):
        assert np.array_equal(t, j.astype(t.dtype))
    assert tn[1].all() and np.array_equal(tn[3], tn[4])
    fused = _decode(rows, shifts, cap, ft, True, fused=True)
    assert np.array_equal(rows_to_numpy(fused[0]), tn[0])


@pytest.mark.parametrize("native", [True, False])
def test_two_pass_stages_nothing(rng, monkeypatch, native):
    """The 16-bit two-pass decode merges nothing: K13 reads the raw section
    from the archive in place."""
    words = [make_float_words(rng, JFT.BFLOAT16, n) for n in (4097, 5)]
    rows = _shifted(_jax_archives(words, JFT.BFLOAT16, native, 4097), [1, 3])

    def no_merge(*args, **kwargs):
        raise AssertionError("the 16-bit two-pass decode staged a section")

    monkeypatch.setattr(TF, "runs_merge", no_merge)
    monkeypatch.setattr(TF, "runs_merge_plain", no_merge)
    for plain in (False, True):
        got = TF.float_decompress_core(
            rows_from_numpy(rows), torch.tensor([1, 3], dtype=torch.int64), 4097,
            FloatType.BFLOAT16, 10, native=native, plain=plain, fused=False)
        assert bool(got[1].all())
        assert np.array_equal(rows_to_numpy(got[0])[0].view(np.uint16)[:4097], words[0])


def _gather(flat: np.ndarray, off: np.ndarray, width: int) -> np.ndarray:
    """uint32[B, width]: flat[clamp(off[b] + k)] (the archive mode's read)."""
    idx = np.clip(off[:, None] + np.arange(width)[None], 0, flat.size - 1)
    return flat[idx]


@pytest.mark.parametrize("ft", HALF)
def test_both_modes_on_edge_inputs_equal_jax(ft):
    """chip_smoke.py's K13 edge inputs: the plain split equals the JAX
    split; the raw sections laid in one archive at word phases 1-3, v1 and
    v2 offsets, the last cut by the archive's end, are read in place at
    counts around the tile, inside a word, 0 and past the row, equal to a
    NumPy gather of the clamped words joined by the JAX package's
    join_packed and cut at each count; the tensor mode on rows at changing
    word phases gives the input back."""
    jft = JFT(int(ft))
    tft = FloatType(int(ft))
    bf16 = jft == JFT.BFLOAT16
    cpu = torch.device("cpu")
    data32, count = chip_smoke.join16_edge_inputs(tft, cpu)
    plane, raw = TS.split16_plain(data32, bf16)
    d = rows_to_numpy(data32)
    jplanes, jraw = JS.split_packed(jnp.asarray(d), jft)
    assert np.array_equal(rows_to_numpy(plane), np.asarray(jplanes[0]))
    assert np.array_equal(rows_to_numpy(raw), np.asarray(jraw[0]))

    comp32, r_off = chip_smoke.join16_edge_archive(raw, cpu)
    off = r_off.numpy()
    assert set(off % 4) == {1, 2, 3}
    got = TS.join16_at(comp32, plane, r_off, count, tft)
    E = plane.shape[1]
    assert E % 2 == 1 and got.shape == (data32.shape[0], 2 * E)
    g = _gather(rows_to_numpy(comp32).reshape(-1), off, E)
    want = np.asarray(JS.join_packed([jnp.asarray(np.asarray(jplanes[0]))],
                                     [jnp.asarray(g)], jft))
    keep = np.arange(4 * E)[None] < count.numpy()[:, None]
    got16 = rows_to_numpy(got).view(np.uint16)
    assert np.array_equal(got16, np.where(keep, want.view(np.uint16), 0))
    # below each count the join gives the input back, but for the member
    # whose section the archive's end cuts
    assert np.array_equal(np.where(keep, d.view(np.uint16), 0)[:-1], got16[:-1])

    plane_v = chip_smoke._phased_rows(plane, E, 3)
    raw_v = chip_smoke._phased_rows(raw, E + 2, 1)
    assert plane_v.data_ptr() % 16 == 12 and not raw_v.is_contiguous()
    got_t = TS.join16_rows(plane_v, raw_v, bf16)
    assert torch.equal(got_t, data32)
    want_t = np.asarray(JS.join_packed([jnp.asarray(np.asarray(jplanes[0]))],
                                       [jnp.asarray(np.asarray(jraw[0]))], jft))
    assert np.array_equal(rows_to_numpy(got_t), want_t)


@pytest.mark.parametrize("count", [0, 1, 2, 3, 4, 7])
@pytest.mark.parametrize("ft", [FloatType.BFLOAT16, FloatType.FLOAT16])
def test_join16_at_cuts_inside_a_word(ft, count):
    """A count inside an output word zeroes its high half; the words past it
    are zero whatever the section holds there."""
    rng = np.random.default_rng(count)
    plane = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (1, 2),
                                          dtype=np.int64).astype(np.int32))
    comp32 = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (1, 9),
                                           dtype=np.int64).astype(np.int32))
    off = torch.tensor([5], dtype=torch.int64)
    got = TS.join16_at(comp32, plane, off, torch.tensor([count], dtype=torch.int64), ft)
    full = TS.join16_rows_plain(plane, comp32[:, 5:7], ft == FloatType.BFLOAT16)
    g16, f16 = got.view(torch.int16)[0], full.view(torch.int16)[0]
    assert torch.equal(g16[:count], f16[:count])
    assert not bool(g16[count:].any())


def test_join16_at_dispatch_is_plain_on_cpu():
    cpu = torch.device("cpu")
    data32, count = chip_smoke.join16_edge_inputs(FloatType.FLOAT16, cpu)
    plane, raw = TS.split16_plain(data32, False)
    comp32, r_off = chip_smoke.join16_edge_archive(raw, cpu)
    args = (comp32, plane, r_off, count, FloatType.FLOAT16)
    assert torch.equal(TS.join16_at(*args), TS.join16_at_plain(*args))


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: a[:4] + (FloatType.FLOAT32,),
        lambda a: (a[0].reshape(-1),) + a[1:],  # a 1-D archive
        lambda a: (a[0][:, :0],) + a[1:],  # an empty archive
        lambda a: (a[0], a[1][:, :0]) + a[2:],  # an empty plane
        lambda a: (a[0], a[1].to(torch.int64)) + a[2:],
        lambda a: a[:2] + (a[2].to(torch.int32),) + a[3:],  # int32 offsets
        lambda a: a[:2] + (a[2][:-1],) + a[3:],  # offsets of the wrong batch
        lambda a: a[:3] + (a[3].to(torch.int32),) + a[4:],  # an int32 count
    ],
)
def test_join16_at_rejects_bad_arguments(bad):
    d = torch.from_numpy(np.arange(32, dtype=np.int32).reshape(2, 16))
    plane, raw = TS.split16_plain(d, True)
    comp32 = raw.reshape(1, -1).contiguous()
    args = (comp32, plane, torch.tensor([0, 8], dtype=torch.int64),
            torch.tensor([32, 3], dtype=torch.int64), FloatType.BFLOAT16)
    TS.join16_at(*args)
    with pytest.raises((TypeError, ValueError)):
        TS.join16_at(*bad(args))
