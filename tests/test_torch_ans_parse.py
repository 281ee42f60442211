"""The ANS header parse, its checks and the decode table (K16's contract,
``models.ans.ans_parse_plain``) against a scalar model of the contract, one
member at a time in Python integers, and against the composition it is
made of (``_ans_parse``, ``_expect_sizes``, ``build_decode_table_batched``),
field by field: both layouts, prob_bits 9-11, each failure rule on one
member of a ragged batch whose archives sit at word offsets of their rows,
and the decode table of a pdf that sums below 2^prob_bits or is all zero.
Then the dispatch (a CPU tensor never reaches K16) and K16's wrapper
refusing bad arguments before it builds anything (its refusal of CPU
tensors is in ``test_torch_import.py``)."""

import bisect
import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_torch.core.interop import rows_from_numpy
from dietgpu_fork_torch.models import ans as TA
from dietgpu_fork_torch.ops.bitops import from_u32
from dietgpu_fork_torch.ops.table import build_decode_table_batched
from dietgpu_fork_torch.runtime import cuda_kernels as K
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CAP = chip_smoke.PARSE_EDGE_NB * 4096
SIZES = list(chip_smoke.PARSE_EDGE_SIZES)
BASES = list(chip_smoke.PARSE_EDGE_BASES)
MAX_BLOCK_WORDS = 2 * 1280  # a block's worst case in u16 words


def _i32(w: int) -> int:
    return w - (1 << 32) if w >= 1 << 31 else w


def _data_words(nb: int) -> int:
    return 136 + 32 * nb + 4 * ((nb + 1) // 2)


def _scalar_model(rows, bases, out_capacity, caps, pb, native, expect_n):
    """The contract, one member at a time in Python integers."""
    B, CW = rows.shape
    nbk = max(1, -(-out_capacity // 4096))
    nseg = -(-nbk // 4) if native else nbk
    flat = rows.reshape(-1)
    magic = ((0xDB0D if native else 0xD00D) << 16) | 1
    f = {"seg_off": np.zeros((B, nseg), np.int64),
         "seg_len": np.zeros((B, nseg), np.int64),
         "comp_w": np.zeros((B, nbk), np.int64),
         "uncomp_w": np.zeros((B, nbk), np.int64),
         "state_off": np.zeros(B, np.int64), "pdf": np.zeros((B, 256), np.int64),
         "success": np.zeros(B, bool), "n": np.zeros(B, np.int64),
         "csum": np.zeros(B, np.int64), "lut": np.zeros((B, 1 << pb), np.int64)}
    for b in range(B):
        base = int(bases[b])

        def word(k):
            return int(rows[b, min(max(base + k, 0), CW - 1)])

        hdr = [word(k) for k in range(8)]
        nb_arch, n, total = _i32(hdr[1]), _i32(hdr[2]), _i32(hdr[3])
        valid = (hdr[0] == magic and (hdr[4] & 0xF) == pb and n >= 0
                 and total >= 0 and nb_arch == -(-n // 4096)
                 and base + _data_words(min(max(nb_arch, 0), 1 << 24))
                 + ((total + 1) >> 1) <= CW)
        if not valid:
            n = nb_arch = 0
        ok = valid and n <= (out_capacity if caps is None else int(caps[b]))
        live = min(nb_arch, nbk) if ok else 0
        abs_base = b * CW + base
        bw_at = abs_base + 136 + 32 * nb_arch
        cnt, fill, start = [0] * nbk, [0] * nbk, [0] * nbk
        for k in range(live):
            x = int(flat[min(max(bw_at + 2 * k, 0), flat.size - 1)])
            y = int(flat[min(max(bw_at + 2 * k + 1, 0), flat.size - 1)])
            cnt[k], fill[k], start[k] = x & 0xFFFF, x >> 16, _i32(y)
            ok = ok and (cnt[k] <= MAX_BLOCK_WORDS
                         and fill[k] == min(max(n - 4096 * k, 0), 4096)
                         and start[k] >= 0 and start[k] + cnt[k] <= total)
        if native:
            segs = [(start[4 * r], sum(cnt[4 * r: 4 * r + 4])) for r in range(nseg)]
            ok = ok and all(s + c <= total for s, c in segs)
        else:
            segs = list(zip(start, cnt))
        size_ok = expect_n is None or n == int(expect_n[b])
        for r, (s, c) in enumerate(segs):
            f["seg_off"][b, r] = abs_base + _data_words(nb_arch) + (s >> 1 if ok else 0)
            f["seg_len"][b, r] = (c + 1) >> 1 if ok and size_ok else 0
        if ok and size_ok:
            f["comp_w"][b], f["uncomp_w"][b] = cnt, fill
        f["success"][b] = ok and size_ok
        f["n"][b], f["csum"][b], f["state_off"][b] = n, hdr[5], abs_base + 136
        pdf = [(word(8 + k // 2) >> (16 * (k % 2))) & 0xFFFF for k in range(256)]
        f["pdf"][b] = pdf
        cum = list(itertools.accumulate(pdf))
        for slot in range(1 << pb):
            sym = min(bisect.bisect_right(cum, slot), 255)
            within = slot - (cum[sym] - pdf[sym])
            f["lut"][b, slot] = _i32(((within << 20) | (pdf[sym] << 8) | sym)
                                     & 0xFFFFFFFF)
    return f


def _composition(comp32, base, out_capacity, caps, pb, native, expect_n):
    """The parse as the decode ran it before K16: the three steps."""
    p = TA._ans_parse(comp32, base, out_capacity, caps, pb, native)
    if expect_n is not None:
        p = TA._expect_sizes(p, expect_n)
    return p, from_u32(build_decode_table_batched(p.pdf, pb))


@pytest.mark.parametrize("pb", chip_smoke.PARSE_EDGE_PROB_BITS)
@pytest.mark.parametrize("rule,native", chip_smoke.PARSE_EDGE_CASES)
def test_plain_parse_equals_the_scalar_model_and_the_composition(rule, native, pb):
    """On ``chip_smoke.py``'s K16 edge inputs, which the card holds K16 to
    the plain version on."""
    rows, out_capacity, caps, expect = chip_smoke.parse_edge_rows(rule, native, pb)
    comp32 = rows_from_numpy(rows)
    base = torch.tensor(BASES)
    got = TA.ans_parse_plain(comp32, base, out_capacity, caps, pb, native, expect)
    want = _scalar_model(rows, BASES, out_capacity, caps, pb, native, expect)
    dtypes = {"comp_w": torch.int32, "uncomp_w": torch.int32, "lut": torch.int32,
              "success": torch.bool}
    for name in TA.ParsedANS._fields:
        t = getattr(got, name)
        assert t.dtype == dtypes.get(name, torch.int64), name
        assert np.array_equal(t.numpy(), want[name]), name
    p, lut = _composition(comp32, base, out_capacity, caps, pb, native, expect)
    for name in TA.ParsedANS._fields[:-1]:
        assert torch.equal(getattr(got, name), getattr(p, name)), name
    assert torch.equal(got.lut, lut)
    # member 0 fails by each rule, and no other member with it
    passes = rule in chip_smoke.PARSE_EDGE_PASS
    assert got.success.tolist() == [passes, True, True, True]
    if not passes:
        assert not got.comp_w[0].any() and not got.seg_len[0].any()
    if rule == "expect_n":  # a size failure keeps the streams' starts
        ok = TA.ans_parse_plain(comp32, base, out_capacity, caps, pb, native)
        assert torch.equal(got.seg_off, ok.seg_off)


def test_dispatch_on_cpu_runs_the_plain_parse(monkeypatch):
    """A CPU tensor takes the plain version, whatever its integer types,
    and the decode takes the parse's table."""
    def refuse(*a):
        raise AssertionError("K16 launched on a CPU tensor")

    monkeypatch.setattr(K, "ans_parse", refuse)
    rows, out_capacity, caps, expect = chip_smoke.parse_edge_rows("expect_n", True, 10)
    comp32 = rows_from_numpy(rows)
    got = TA.ans_parse(comp32, torch.tensor(BASES, dtype=torch.int32),
                       out_capacity, caps, 10, True, expect.to(torch.int32))
    want = TA.ans_parse_plain(comp32, torch.tensor(BASES), out_capacity, caps,
                              10, True, expect)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out, ok, n, _ = TA.ans_decode_core(comp32, torch.tensor(BASES), CAP, 10)
    assert ok.tolist() == [True] * 4 and n.tolist() == SIZES


def _wrapper_args():
    comp32 = rows_from_numpy(chip_smoke.parse_edge_archives(True, 10))
    B = comp32.shape[0]
    i64 = torch.zeros(B, dtype=torch.int64)
    return [comp32, i64, CAP, i64, 10, True, i64]


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: [a[0].to(torch.int64)] + a[1:],  # comp32 not int32
        lambda a: [a[0][:, :0]] + a[1:],  # no words
        lambda a: [a[0].t()] + a[1:],  # not contiguous
        lambda a: a[:1] + [a[1].to(torch.int32)] + a[2:],  # base not int64
        lambda a: a[:1] + [a[1][:1]] + a[2:],  # base of the wrong batch
        lambda a: a[:3] + [a[3][:, None]] + a[4:],  # caps of the wrong shape
        lambda a: a[:4] + [12] + a[5:],  # prob_bits out of range
        lambda a: a[:6] + [a[6].to(torch.float64)],  # expect_n not int64
    ],
)
def test_wrapper_refuses_bad_arguments_before_it_builds(monkeypatch, bad):
    """K16's wrapper checks dtypes, shapes and layout before the build
    (its check for CUDA tensors stepped over, so the CPU can reach them)."""
    monkeypatch.setattr(K, "_cuda_only", lambda *ts: None)
    monkeypatch.setattr(K, "_lib", None)
    with pytest.raises((TypeError, ValueError)):
        K.ans_parse(*bad(_wrapper_args()))
    assert K._lib is None

