"""K7's archive mode (``ops.float_split.join_wide_at``: the raw sections read
from the archive in place, below a per-member count) and the fp32/fp64
two-pass decode built on it, on the CPU (plain versions) against the JAX
package, bit for bit: archives compressed by the JAX package, decoded by
its two-pass decode (staging merge, then join_packed) and by the port's
``float_decompress_core(fused=False)``, in v1 and v2 containers, native
and classic, at word offsets 1-3 in wider rows, with counts 0, 1, 3, 5 and
not a multiple of 4, failed members, a header whose sections run past
the row and non-zero bytes past n in a section's last word; then the archive mode on ``chip_smoke.py``'s K5/K7 edge inputs
against a NumPy gather and the JAX package's join_packed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import float_codec as JF
from dietgpu_fork_tpu.ops import checksum as JC
from dietgpu_fork_tpu.ops import float_split as JS
from dietgpu_fork_torch.core.constants import FLOAT_ALIGN_MIN, FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import float_codec as TF
from dietgpu_fork_torch.ops import float_split as TS
from tests.conftest import make_float_words
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WIDE = [JFT.FLOAT32, JFT.FLOAT64]
# counts 0, 1, 3 and 5, one not a multiple of 4, and one at capacity
SIZES = [0, 1, 3, 5, 4099, 2 * 4096]
# each member's archive starts this many words into its row
SHIFTS = [1, 2, 3, 0, 3, 1]
SEC_BYTES = {JFT.FLOAT32: (2, 1), JFT.FLOAT64: (4, 2)}

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


def _both(rows, shifts, cap, ft, native, capacities=None, cks=False):
    """(JAX two-pass decode, the port's two-pass decode) of rows at word
    offsets shifts: each (words uint32, success, n, archive checksum,
    decoded checksum) as NumPy arrays."""
    B = rows.shape[0]
    jcap = None if capacities is None else jnp.asarray(capacities, jnp.int32)
    j = jax_dec(jnp.asarray(rows), jnp.asarray(shifts, jnp.int32), out_floats=cap,
                float_type=ft, prob_bits=10, verify_checksum=cks, native=native,
                capacities=jcap)
    tcap = None if capacities is None else torch.tensor(capacities, dtype=torch.int64)
    t = TF.float_decompress_core(
        rows_from_numpy(rows), torch.tensor(shifts, dtype=torch.int64)[:B], cap,
        FloatType(int(ft)), 10, capacities=tcap, verify_checksum=cks,
        native=native, fused=False)
    jn = [np.asarray(x) for x in j]
    tn = [rows_to_numpy(t[0])] + [x.numpy() for x in t[1:]]
    return jn, tn


def _assert_same(jn, tn):
    words_j, succ_j, n_j, ca_j, cg_j = jn
    words_t, succ_t, n_t, ca_t, cg_t = tn
    assert words_t.shape == words_j.shape
    assert np.array_equal(words_t, words_j)
    assert np.array_equal(succ_t, succ_j)
    assert np.array_equal(n_t, n_j.astype(np.int64))
    assert np.array_equal(ca_t, ca_j.astype(np.int64))
    assert np.array_equal(cg_t, cg_j.astype(np.int64))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ft", WIDE)
def test_two_pass_at_word_offsets_equals_jax(rng, ft, native):
    words = [make_float_words(rng, ft, n) for n in SIZES]
    cap = max(SIZES)
    rows = _shifted(_jax_archives(words, ft, native, cap, cks=True), SHIFTS)
    jn, tn = _both(rows, SHIFTS, cap, ft, native, cks=True)
    _assert_same(jn, tn)
    assert tn[1].all()
    u8 = tn[0].view(np.uint8)
    for b, w in enumerate(words):
        assert np.array_equal(u8[b, : w.nbytes], w.view(np.uint8)), b
        assert not u8[b, w.nbytes:].any(), b
    assert np.array_equal(tn[3], tn[4])  # the checksums agree


@pytest.mark.parametrize("ft", WIDE)
def test_two_pass_v2_container_at_word_offset_equals_jax(rng, ft):
    """A v2 container (sections on 512 B boundaries of the archive) next to
    a v1 member, both 1-3 words off 16 B."""
    sizes = [FLOAT_ALIGN_MIN + 4097, 13]
    words = [make_float_words(rng, ft, n) for n in sizes]
    cap = max(sizes)
    rows = _shifted(_jax_archives(words, ft, True, cap), [3, 1])
    assert rows[0, 3] == TF.FLOAT_MAGIC_VERSION2 and rows[1, 1] == TF.FLOAT_MAGIC_VERSION
    jn, tn = _both(rows, [3, 1], cap, ft, True)
    _assert_same(jn, tn)
    assert tn[1].all()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ft", WIDE)
def test_failed_members_decode_to_zeros(rng, ft, native):
    """A bad magic and a count above the member's capacity fail the member,
    whose words are all zero; the others are unchanged."""
    words = [make_float_words(rng, ft, n) for n in SIZES]
    cap = max(SIZES)
    rows = _shifted(_jax_archives(words, ft, native, cap), SHIFTS)
    rows[1, SHIFTS[1]] ^= 0x10000  # member 1's magic
    capacities = [cap] * len(SIZES)
    capacities[4] = SIZES[4] - 1  # member 4's count passes its capacity
    jn, tn = _both(rows, SHIFTS, cap, ft, native, capacities=capacities)
    _assert_same(jn, tn)
    assert list(np.flatnonzero(~tn[1])) == [1, 4]
    assert not tn[0][[1, 4]].any()
    assert tn[0][5].any()


@pytest.mark.parametrize("ft", WIDE)
def test_header_count_past_the_row_reads_nothing_outside(rng, ft):
    """The last member's header claims the largest count the decode takes,
    so its sections would run past the end of the archive: it fails and
    decodes to zeros, and the port agrees with the JAX package."""
    words = [make_float_words(rng, ft, n) for n in SIZES]
    cap = 8 * max(SIZES)
    rows = _shifted(_jax_archives(words, ft, True, max(SIZES)), SHIFTS)
    rows[-1, SHIFTS[-1] + 1] = cap  # header word 1: n
    jn, tn = _both(rows, SHIFTS, cap, ft, True)
    _assert_same(jn, tn)
    assert not tn[1][-1] and not tn[0][-1].any()
    assert tn[1][:-1].all()


@pytest.mark.parametrize("ft", WIDE)
def test_tail_bytes_past_the_count_decode_to_zeros(rng, ft):
    """Non-zero bytes past n in a section's last word, which the compressor
    never writes: the JAX two-pass decode joins them into the words past n,
    the port's writes zeros there (K7 reads nothing at or past the count),
    as its fused fp32 decode does. Below n, the flags, counts and checksums
    agree with the JAX package's."""
    sizes = [5, 4099, 3]  # odd: sec1 (fp32) and sec2 end inside a word
    shifts = [1, 2, 3]
    words = [make_float_words(rng, ft, n) for n in sizes]
    cap = max(sizes) + 8  # room past every count
    rows = _shifted(_jax_archives(words, ft, True, cap, cks=True), shifts)
    for b, (s, n) in enumerate(zip(shifts, sizes)):
        s1w, s2w = TF._section_word_counts(n, FloatType(int(ft)))
        if ft == JFT.FLOAT32:
            rows[b, s + 8 + s1w - 1] |= 0xABCD0000  # sec1: 2 B a float
            rows[b, s + 8 + s1w + s2w - 1] |= 0xEE000000  # sec2: 1 B a float
        else:
            rows[b, s + 8 + s1w + s2w - 1] |= 0xEEEE0000  # sec2: 2 B a float
    jn, tn = _both(rows, shifts, cap, ft, True, cks=True)
    wpf = 1 if ft == JFT.FLOAT32 else 2  # words a float
    keep = np.arange(tn[0].shape[1])[None] // wpf < np.asarray(sizes)[:, None]
    assert np.array_equal(tn[0], np.where(keep, jn[0], 0))
    assert np.where(keep, 0, jn[0]).any(axis=1).all()  # JAX kept the tails
    for j, t in zip(jn[1:], tn[1:]):
        assert np.array_equal(t, j.astype(t.dtype))
    assert tn[1].all() and np.array_equal(tn[3], tn[4])
    if ft == JFT.FLOAT32:
        fused = TF.float_decompress_core(
            rows_from_numpy(rows), torch.tensor(shifts, dtype=torch.int64), cap,
            FloatType.FLOAT32, 10, native=True, fused=True)
        assert np.array_equal(rows_to_numpy(fused[0]), tn[0])


def _gather(flat: np.ndarray, off: np.ndarray, width: int) -> np.ndarray:
    """uint32[B, width]: flat[clamp(off[b] + k)] (the archive mode's read)."""
    idx = np.clip(off[:, None] + np.arange(width)[None], 0, flat.size - 1)
    return flat[idx]


@pytest.mark.parametrize("one_bin", [False, True])
@pytest.mark.parametrize("ft", WIDE)
def test_archive_mode_on_edge_inputs_equals_jax(ft, one_bin):
    """chip_smoke.py's K5/K7 edge inputs: K5's plain version equals the JAX
    split (one-bin fp64 data pins plane 0's one-bin histogram); then the
    sections laid at every word phase of one archive, the last member's
    cut by its end, are read in place at counts around the tiles, 0 and past
    the row, equal to a NumPy gather of the clamped words joined by the JAX
    package's join_packed and cut at each count."""
    jft = JFT(int(ft))
    cpu = torch.device("cpu")
    data32, n, count = chip_smoke.wide_edge_inputs(FloatType(int(ft)), one_bin, cpu)
    exp, sec1, sec2, hist, csum = TS.split_wide_hist_plain(data32, n, FloatType(int(ft)))
    d = rows_to_numpy(data32)
    nn = n.numpy()
    planes, raw, hists, jcsum = JS.split_hist_packed(jnp.asarray(d), jnp.asarray(nn), jft)
    secs = [np.asarray(JC.mask_packed_bytes(s, jnp.asarray(nn * bp)))
            for s, bp in zip(raw, SEC_BYTES[jft])]
    assert np.array_equal(rows_to_numpy(exp), np.concatenate([np.asarray(p) for p in planes]))
    assert np.array_equal(rows_to_numpy(sec1), secs[0])
    assert np.array_equal(rows_to_numpy(sec2), secs[1])
    assert np.array_equal(hist.numpy(), np.concatenate([np.asarray(h) for h in hists]))
    assert np.array_equal(csum.numpy(), np.asarray(jcsum).astype(np.int32))
    B = d.shape[0]
    if one_bin and jft == JFT.FLOAT64:
        assert ((hist[:B] > 0).sum(dim=1) <= 1).all() and hist[:B].sum() > 0

    comp32, s1, s2 = chip_smoke.wide_edge_archive(sec1, sec2, cpu)
    tplanes = list(exp.reshape(-1, B, exp.shape[1]))
    got = TS.join_wide_at(comp32, tplanes, s1, s2, count, FloatType(int(ft)))
    E = exp.shape[1]
    flat = rows_to_numpy(comp32).reshape(-1)
    k1, k2 = (2, 1) if jft == JFT.FLOAT32 else (4, 2)
    g1, g2 = _gather(flat, s1.numpy(), k1 * E), _gather(flat, s2.numpy(), k2 * E)
    want = np.asarray(JS.join_packed([jnp.asarray(np.asarray(p)) for p in planes],
                                     [jnp.asarray(g1), jnp.asarray(g2)], jft))
    wpf = 1 if jft == JFT.FLOAT32 else 2  # words a float
    keep = np.arange(4 * E * wpf)[None] // wpf < count.numpy()[:, None]
    assert np.array_equal(rows_to_numpy(got), np.where(keep, want, 0))
    # below each count the join gives the input back, but for the member
    # whose sections the archive's end cuts
    assert np.array_equal(np.where(keep, d, 0)[:-1], rows_to_numpy(got)[:-1])


def test_archive_mode_dispatch_is_plain_on_cpu():
    cpu = torch.device("cpu")
    data32, n, count = chip_smoke.wide_edge_inputs(FloatType.FLOAT64, False, cpu)
    exp, sec1, sec2, _, _ = TS.split_wide_hist_plain(data32, n, FloatType.FLOAT64)
    comp32, s1, s2 = chip_smoke.wide_edge_archive(sec1, sec2, cpu)
    planes = list(exp.reshape(2, -1, exp.shape[1]))
    args = (comp32, planes, s1, s2, count, FloatType.FLOAT64)
    assert torch.equal(TS.join_wide_at(*args), TS.join_wide_at_plain(*args))


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: (a[0], a[1][:1]) + a[2:],  # one plane for fp64
        lambda a: (a[0].reshape(-1),) + a[1:],  # a 1-D archive
        lambda a: a[:2] + (a[2].to(torch.int32),) + a[3:],  # int32 offsets
        lambda a: a[:3] + (a[3][:-1],) + a[4:],  # offsets of the wrong batch
        lambda a: a[:4] + (a[4].to(torch.int32),) + a[5:],  # an int32 count
        lambda a: a[:5] + (FloatType.BFLOAT16,),
        lambda a: (a[0][:, :0],) + a[1:],  # an empty archive
    ],
)
def test_join_wide_at_rejects_bad_arguments(bad):
    d = torch.from_numpy(np.arange(32, dtype=np.int32).reshape(2, 16))
    exp, sec1, sec2, _, _ = TS.split_wide_hist_plain(
        d, torch.tensor([8, 8], dtype=torch.int32), FloatType.FLOAT64)
    comp32 = torch.cat([sec1.reshape(-1), sec2.reshape(-1)]).reshape(1, -1)
    off = torch.tensor([0, 8], dtype=torch.int64)
    args = (comp32, list(exp.reshape(2, 2, -1)), off, off + 16,
            torch.tensor([8, 3], dtype=torch.int64), FloatType.FLOAT64)
    TS.join_wide_at(*args)
    with pytest.raises((TypeError, ValueError)):
        TS.join_wide_at(*bad(args))
