"""Probability normalisation and coding tables, batched in plain PyTorch.

A port of the JAX package's ``ops/table.py``: (B, 256)-shaped work that
runs beside the kernels on whatever device its inputs lie on. It
reproduces the reference's quantisation exactly, including its float32
first pass with a truncating cast and the symbol-id (not rank) +1 quirk
(GpuANSStatistics.cuh:178-367), because any "cleaner" rewrite changes the
archive bytes. All u32 values are int64 carriers (see ``bitops``).

``ans_table`` builds the encoder's tables: a CUDA tensor takes K17
(``csrc/ans_table.cu``), one launch with no read to the host; a CPU tensor
takes ``ans_table_plain``, the normalisation and the packing below.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.config import use_kernels
from ..core.constants import NUM_SYMBOLS
from ..runtime import cuda_kernels as K
from ..utils.profiling import span
from .bitops import M32, clz32, from_u32, udiv_u43_by_u32


def normalize_probs_batched(
    counts: torch.Tensor, totals: torch.Tensor, prob_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantise histograms so each row sums to exactly 2^prob_bits.

    counts: u32[B, 256]; totals: [B] (0 for empty members, whose rows come
    back all-zero). Returns (pdf, cdf, magic, shift), each int64[B, 256].
    """
    dev = counts.device
    target = 1 << prob_bits
    counts = counts.to(torch.int64) & M32
    totals = totals.to(torch.int64) & M32
    nonempty = (totals > 0)[:, None]

    # float32 first pass, truncating cast (GpuANSStatistics.cuh:215-218)
    safe_tot = torch.where(totals > 0, totals, 1).to(torch.float32)
    with span("sync:table.target"):
        target32 = torch.tensor(float(target), dtype=torch.float32, device=dev)
    q = (target32 * (counts.to(torch.float32) / safe_tot[:, None])).to(torch.int64)
    q = torch.where((counts > 0) & (q == 0), 1, q)
    q = torch.where(nonempty, q, 0)
    diff = target - q.sum(dim=1)

    syms = torch.arange(NUM_SYMBOLS, dtype=torch.int64, device=dev)
    prob = q

    # diff > 0: +1 to symbols whose *id* < remaining diff, in rounds of 256
    # (GpuANSStatistics.cuh:261-273)
    pos_diff = diff.clamp(min=0)
    add = (pos_diff[:, None] // NUM_SYMBOLS) + (
        syms[None, :] < (pos_diff[:, None] % NUM_SYMBOLS)
    ).to(torch.int64)
    prob = prob + torch.where(diff[:, None] > 0, add, 0)

    # diff < 0: repeatedly take 1 from the `it` smallest values > 1, ties
    # broken by symbol id (GpuANSStatistics.cuh:274-315), by ascending rank
    # of the key (prob << 16 | sym) among the entries > 1
    d = (-diff).clamp(min=0)
    while _any_left(d):
        gt1 = prob > 1
        num_gt1 = gt1.sum(dim=1)
        it = torch.minimum(d, num_gt1)
        key = (prob << 16) | syms[None, :]
        arank = (gt1[:, None, :] & (key[:, None, :] < key[:, :, None])).sum(dim=2)
        sub = gt1 & (arank < it[:, None]) & (d[:, None] > 0)
        prob = prob - sub.to(torch.int64)
        d = d - it
    pdf = torch.where(nonempty, prob, 0)

    csum = torch.cumsum(pdf, dim=1)
    cdf = csum - pdf

    # magic-multiply division constants (GpuANSStatistics.cuh:345-358)
    nz = pdf > 0
    shift = torch.where(nz, 32 - clz32(pdf - 1), 0)
    safe_pdf = torch.where(nz, pdf, 1)
    a_hi = ((1 << shift) - pdf) & M32
    magic = torch.where(nz, (udiv_u43_by_u32(a_hi, safe_pdf) + 1) & M32, 0)
    return pdf, cdf, magic, shift


def _any_left(d: torch.Tensor) -> bool:
    """Whether a row has excess left: one read to the host a round."""
    with span("sync:table.normalize_round"):
        return bool((d > 0).any())


def pack_encode_table(pdf, cdf, shift):
    """pdf[12 bits] | cdf[11 bits] << 12 | shift << 23, one u32 per symbol.
    pdf needs 12 bits: a single-symbol table has pdf = 2^prob_bits."""
    return (pdf | (cdf << 12) | (shift << 23)) & M32


def ans_table_plain(
    hist: torch.Tensor, totals: torch.Tensor, prob_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K17's contract: ``normalize_probs_batched``, then
    ``pack_encode_table``. hist: [B, 256] counts; totals: [B]. Returns the
    encoder's (packed, magic) as int32[B, 256] and pdf int64[B, 256]."""
    pdf, cdf, magic, shift = normalize_probs_batched(hist, totals, prob_bits)
    return from_u32(pack_encode_table(pdf, cdf, shift)), from_u32(magic), pdf


def ans_table(
    hist: torch.Tensor, totals: torch.Tensor, prob_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ans_table_plain``'s result: one launch of K17 for a CUDA tensor,
    the plain version for a CPU tensor. hist and totals of any integer
    type, each value read as its low 32 bits."""
    if not use_kernels(hist):
        return ans_table_plain(hist, totals, prob_bits)
    if hist.dtype != torch.int32 or hist.stride(-1) != 1:
        hist = hist.to(torch.int32).contiguous()  # keeps the low 32 bits
    return K.ans_table(hist, totals.to(device=hist.device, dtype=torch.int64)
                       .contiguous(), prob_bits)


def build_decode_table_batched(pdf: torch.Tensor, prob_bits: int) -> torch.Tensor:
    """Expand pdf rows into 2^prob_bits decode entries packing
    ((slot - cdf) << 20 | pdf << 8 | sym) (GpuANSDecode.cuh:34-41).

    pdf: u32[B, 256] -> int64[B, 2^prob_bits] (u32 values).
    """
    pdf = pdf.to(torch.int64) & M32
    B = pdf.shape[0]
    nbuckets = 1 << prob_bits
    bounds = torch.cumsum(pdf, dim=1)  # inclusive, nondecreasing
    slots = torch.arange(nbuckets, dtype=torch.int64, device=pdf.device)
    sym = torch.searchsorted(
        bounds, slots.expand(B, nbuckets).contiguous(), right=True
    ).clamp(max=NUM_SYMBOLS - 1)
    cdf = bounds - pdf
    within = slots[None, :] - torch.gather(cdf, 1, sym)
    return (
        ((within & M32) << 20) | (torch.gather(pdf, 1, sym) << 8) | sym
    ) & M32
