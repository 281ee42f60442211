"""The encode table build (K17's contract, ``ops.table.ans_table_plain``:
``normalize_probs_batched`` then ``pack_encode_table``) against a scalar
model of the contract, one member at a time in Python integers and numpy
float32, on ``chip_smoke.py``'s K17 edge batches at prob_bits 9-11, which
the card holds K17 to the plain version on. Then the dispatch (a CPU tensor
and ``plain=True`` never reach K17; a CUDA tensor reaches it once, with the
counts it takes) and K17's wrapper refusing bad arguments before it builds
anything (its refusal of CPU tensors is in ``test_torch_import.py``)."""

import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_torch.models import ans as TA
from dietgpu_fork_torch.ops import table as TT
from dietgpu_fork_torch.runtime import cuda_kernels as K
from tests.test_torch_threads import one_torch_thread  # noqa: F401

M32 = 0xFFFFFFFF


def _scalar_model(counts, total, pb):
    """The contract for one member: (packed, magic, pdf) as Python ints,
    and what the member did (diff, rounds of the excess loop, ties broken
    by symbol id in a round)."""
    T = 1 << pb
    c = [int(x) & M32 for x in counts]
    t = int(total) & M32
    stats = {"diff": 0, "rounds": 0, "ties": 0}
    if t == 0:
        return [0] * 256, [0] * 256, [0] * 256, stats
    ft, fT = np.float32(t), np.float32(T)
    q = [int(fT * (np.float32(x) / ft)) for x in c]
    q = [1 if x > 0 and v == 0 else v for x, v in zip(c, q)]
    diff = stats["diff"] = T - sum(q)
    if diff > 0:
        q = [v + diff // 256 + (s < diff % 256) for s, v in enumerate(q)]
    d = max(-diff, 0)
    while d > 0:
        live = sorted((v, s) for s, v in enumerate(q) if v > 1)
        it = min(d, len(live))
        if it < len(live) and live[it - 1][0] == live[it][0]:
            stats["ties"] += 1
        for _, s in live[:it]:
            q[s] -= 1
        d -= it
        stats["rounds"] += 1
    packed, magic, cdf = [], [], 0
    for v in q:
        shift = (v - 1).bit_length() if v > 0 else 0
        magic.append(((((1 << shift) - v) << 32) // v + 1) & M32 if v else 0)
        packed.append((v | cdf << 12 | shift << 23) & M32)
        cdf += v
    return packed, magic, q, stats


def _i32(w):
    return w - (1 << 32) if w >= 1 << 31 else w


# what each case's member must do, so that the case tests what it is named
# for: (the model's stats, counts, total, prob_bits) -> bool
_DOES = {
    "big": lambda st, c, tot, pb: min(x for x in c if x) > 1 << 24 and any(
        int(np.float32(x)) != x for x in c),
    "total_high": lambda st, c, tot, pb: tot & M32 != tot,
    "diff_rounds": lambda st, c, tot, pb: st["diff"] > 256,
    "excess_rounds": lambda st, c, tot, pb: st["rounds"] >= 3,
    "ties": lambda st, c, tot, pb: st["ties"] >= 1 and st["rounds"] == 1,
    "single": lambda st, c, tot, pb: True,
    "totals_below": lambda st, c, tot, pb: st["diff"] < 0 and tot < sum(c),
    "zero_total": lambda st, c, tot, pb: tot == 0 and sum(c) > 0,
    "uniform": lambda st, c, tot, pb: st["diff"] == 0,
    "few": lambda st, c, tot, pb: 0 < st["diff"] and c[0] == 0,
}


@pytest.mark.parametrize("pb", chip_smoke.TABLE_EDGE_PROB_BITS)
@pytest.mark.parametrize("case", chip_smoke.TABLE_EDGE_CASES)
def test_plain_table_equals_the_scalar_model(case, pb):
    """On ``chip_smoke.py``'s K17 edge batch: the case's member, an empty
    one and natural counts, each row of each output equal to the model."""
    hist, totals = chip_smoke.table_edge_batch(case, pb)
    packed, magic, pdf = TT.ans_table_plain(torch.from_numpy(hist),
                                            torch.from_numpy(totals), pb)
    assert (packed.dtype, magic.dtype, pdf.dtype) == (
        torch.int32, torch.int32, torch.int64)
    for b in range(hist.shape[0]):
        w_packed, w_magic, w_pdf, st = _scalar_model(hist[b], totals[b], pb)
        assert packed[b].tolist() == [_i32(w) for w in w_packed], b
        assert magic[b].tolist() == [_i32(w) for w in w_magic], b
        assert pdf[b].tolist() == w_pdf, b
        nonempty = int(totals[b]) & M32 > 0
        assert sum(w_pdf) == (1 << pb if nonempty else 0), b
    assert not packed[1].any() and not magic[1].any() and not pdf[1].any()
    _, _, w_pdf, st = _scalar_model(hist[0], totals[0], pb)
    assert _DOES[case](st, [int(x) for x in hist[0]], int(totals[0]), pb), st
    if case == "single":
        assert max(w_pdf) == 1 << pb


def test_dispatch_on_cpu_runs_the_plain_table(monkeypatch):
    """A CPU tensor takes the plain version, whatever its integer types;
    so does plain=True, where the encode never calls the dispatch."""
    def refuse(*a):
        raise AssertionError("K17 launched on a CPU tensor")

    monkeypatch.setattr(K, "ans_table", refuse)
    hist, totals = chip_smoke.table_edge_batch("ties", 10)
    want = TT.ans_table_plain(torch.from_numpy(hist), torch.from_numpy(totals), 10)
    for h in (torch.from_numpy(hist), torch.from_numpy(hist).to(torch.int32)):
        got = TT.ans_table(h, torch.from_numpy(totals).to(torch.int32), 10)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    x = torch.from_numpy(np.arange(4 * 4096, dtype=np.uint8).reshape(4, -1)
                         .view(np.int32).copy())
    sizes = torch.tensor([4096, 100, 0, 4095], dtype=torch.int32)
    TA.ans_encode_sections(x, sizes, 10)
    monkeypatch.setattr(TA, "ans_table", refuse)
    TA.ans_encode_sections(x, sizes, 10, plain=True)


@pytest.mark.parametrize("hist_kind", ["int32", "int64", "expanded"])
def test_dispatch_on_the_card_reaches_k17_once(monkeypatch, hist_kind):
    """On a CUDA tensor (use_kernels stepped over here) the encode calls
    K17 once, with int32 counts whose rows are contiguous (an expanded row
    as it is, int64 counts cut to their low 32 bits) and int64 totals, and
    encodes with its tables; the archive equals the plain path's."""
    calls = []

    def k17(hist, totals, prob_bits):
        assert hist.dtype == torch.int32 and hist.stride(1) == 1
        assert totals.dtype == torch.int64 and totals.is_contiguous()
        calls.append(hist)
        return TT.ans_table_plain(hist, totals, prob_bits)

    monkeypatch.setattr(K, "ans_table", k17)
    monkeypatch.setattr(TT, "use_kernels", lambda t: True)
    x = torch.from_numpy(chip_smoke.exponential_bytes(5, 3 * 8192, 3.0)
                         .reshape(3, -1).view(np.int32).copy())
    sizes = torch.tensor([8192, 5000, 1], dtype=torch.int32)
    row = torch.from_numpy(np.bincount(x.view(torch.uint8).numpy().reshape(-1),
                                       minlength=256))
    hist = {"int32": row.to(torch.int32).repeat(3, 1),
            "int64": row.repeat(3, 1) + (1 << 32),
            "expanded": row.to(torch.int32)[None, :].expand(3, 256)}[hist_kind]
    tots = torch.full((3,), 3 * 8192, dtype=torch.int32)
    got = TA.ans_encode_core(x, sizes, 10, hist=hist, hist_totals=tots,
                             native=hist_kind != "expanded")
    assert len(calls) == 1
    if hist_kind == "expanded":
        assert calls[0].stride(0) == 0
    want = TA.ans_encode_core(x, sizes, 10, hist=hist, hist_totals=tots,
                              native=hist_kind != "expanded", plain=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _wrapper_args():
    hist, totals = chip_smoke.table_edge_batch("few", 10)
    return [torch.from_numpy(hist).to(torch.int32), torch.from_numpy(totals), 10]


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: [a[0].to(torch.int64)] + a[1:],  # hist not int32
        lambda a: [a[0][:, :255]] + a[1:],  # not 256 symbols
        lambda a: [a[0][0]] + a[1:],  # not 2-D
        lambda a: [a[0].t().contiguous().t()] + a[1:],  # rows not contiguous
        lambda a: [a[0][:0]] + a[1:],  # no members
        lambda a: a[:1] + [a[1].to(torch.int32)] + a[2:],  # totals not int64
        lambda a: a[:1] + [a[1][:2]] + a[2:],  # totals of the wrong batch
        lambda a: a[:1] + [a[1].repeat(2)[::2]] + a[2:],  # totals not contiguous
        lambda a: a[:2] + [12],  # prob_bits out of range
        lambda a: a[:2] + [8],
    ],
)
def test_wrapper_refuses_bad_arguments_before_it_builds(monkeypatch, bad):
    """K17's wrapper checks dtypes, shapes, layout and prob_bits before the
    build (its check for CUDA tensors stepped over, so the CPU can reach
    them)."""
    monkeypatch.setattr(K, "_cuda_only", lambda *ts: None)
    monkeypatch.setattr(K, "_lib", None)
    with pytest.raises((TypeError, ValueError)):
        K.ans_table(*bad(_wrapper_args()))
    assert K._lib is None

