"""Dense fp32 through the port's batch API with the checksum on, on the CPU
(plain versions): ``compress_data`` / ``decompress_data`` at sizes around
a block and past ``FLOAT_ALIGN_MIN`` (a v2 container in the row layout), in
both ANS layouts and both decode formulations. Every output equals its
input bit for bit, the benchmark's plain reference reads every archive
of a member of at least one float back with no fault, and a bit flipped
in raw section 2 comes back as a checksum mismatch."""

import functools

import pytest
import torch

import dietgpu_fork_torch.api.codec as C
from bench_torch import reference
from dietgpu_fork_torch.core.constants import FLOAT_ALIGN_MIN
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SIZES = [0, 1, 4095, 4097, FLOAT_ALIGN_MIN + 4097]
PROB_BITS = 10


@functools.lru_cache(maxsize=None)
def _floats(n: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(1000 + n)
    return torch.randn(n, generator=g, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _compressed(sizes: tuple, native: bool):
    comp, comp_bytes, _ = C.compress_data(
        True, [_floats(n) for n in sizes], checksum=True, prob_bits=PROB_BITS,
        native=native)
    return comp, comp_bytes


@pytest.fixture(params=[True, False], ids=["fused", "two-pass"])
def formulation(request, monkeypatch):
    """decompress_data with the fp32 decode forced to one formulation."""
    core = C.float_decompress_core
    monkeypatch.setattr(C, "float_decompress_core", functools.partial(
        core, fused=request.param))
    return request.param


def _decompress(comp, sizes):
    return C.decompress_data(True, comp.clone(), list(sizes), torch.float32,
                             checksum=True, prob_bits=PROB_BITS)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("native", [True, False], ids=["rows", "classic"])
@pytest.mark.parametrize("sizes", [(n,) for n in SIZES] + [tuple(SIZES[:-1])],
                         ids=[str(n) for n in SIZES] + ["ragged"])
def test_round_trip_is_exact_and_the_reference_reads_it(sizes, native, formulation):
    comp, comp_bytes = _compressed(sizes, native)
    outs, got_sizes, success, status, _ = _decompress(comp, sizes)
    assert bool(success.all()) and status.ok
    assert got_sizes.tolist() == list(sizes)
    assert all(_same_bits(o, _floats(n)) for o, n in zip(outs, sizes))
    # the reference reads members of at least one float: it takes an empty
    # member's all-zero probabilities for a broken table, and cannot
    # reshape its empty decode
    live = [i for i, n in enumerate(sizes) if n]
    if not live:
        return
    faults = reference.Faults()
    bad = reference.check_batch(comp[live], comp_bytes[live].tolist(),
                                [_floats(sizes[i]) for i in live], PROB_BITS, True,
                                False, faults)
    assert bad == 0 and faults.total == 0, dict(faults.counts)


def _sec2_byte(n: int, v2: bool) -> int:
    """The archive byte of raw section 2 that holds float 0's third byte."""
    s1w, _ = reference._sections(n, 4)
    o1 = 128 if v2 else 8
    return 4 * (o1 + (-(-s1w // 128) * 128 if v2 else s1w))


@pytest.mark.parametrize("native", [True, False], ids=["rows", "classic"])
@pytest.mark.parametrize("n", [4097, FLOAT_ALIGN_MIN + 4097])
def test_a_bit_flipped_in_raw_section_2_is_a_checksum_mismatch(n, native, formulation):
    comp, _ = _compressed((n,), native)
    bad = comp.clone()
    k = _sec2_byte(n, native and n >= FLOAT_ALIGN_MIN)
    bad[0, k] ^= 0x10
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        _decompress(bad, (n,))
    # without the verify the decode succeeds, with float 0 changed alone
    outs, _, success, _, _ = C.decompress_data(True, bad, [n], torch.float32,
                                               checksum=False, prob_bits=PROB_BITS)
    assert bool(success.all())
    diff = (outs[0].view(torch.int32) != _floats(n).view(torch.int32)).nonzero()
    assert diff.flatten().tolist() == [0]
