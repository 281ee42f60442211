"""Temporary-memory accounting, preserving the reference API contract.

A port of the JAX package's ``runtime/stack_memory.py``, pure arithmetic.
The CUDA reference manages scratch with a LIFO bump allocator over a
caller-provided arena (StackDeviceMemory, utils/StackDeviceMemory.h:127-272)
and every PyTorch op returns the high-water mark (DietGpu.cpp:285). The
port allocates through PyTorch's caching allocator instead; what this
module keeps is the contract: a per-call high-water estimate returned from
every API entry point, computed by the reference's allocation schedule, so
the numbers equal the JAX package's and the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..core.constants import (
    BLOCK_SIZE,
    NUM_SYMBOLS,
    FLOAT_NUM_COMP_SEGMENTS,
    FloatType,
    div_up,
    raw_comp_block_max_size,
    round_up,
)

# 256 B alignment of every stack allocation (kSDMAlignment,
# StackDeviceMemory.h:22)
ALIGNMENT = 256


def _a(nbytes: int) -> int:
    return round_up(nbytes, ALIGNMENT)


@dataclasses.dataclass
class StackMemoryEstimator:
    """LIFO accounting replica: tracks current and max usage of the
    reference's temp allocations."""

    cur: int = 0
    high: int = 0
    _stack: List[int] = dataclasses.field(default_factory=list)

    def alloc(self, nbytes: int) -> None:
        nbytes = _a(nbytes)
        self._stack.append(nbytes)
        self.cur += nbytes
        self.high = max(self.high, self.cur)

    def free(self) -> None:
        self.cur -= self._stack.pop()

    def free_all(self) -> None:
        while self._stack:
            self.free()


def ans_encode_temp_size(num_in_batch: int, max_size: int,
                         have_histogram: bool = False) -> int:
    """Replicates ansEncodeBatchDevice's allocation schedule
    (GpuANSEncode.cuh:686-735)."""
    est = StackMemoryEstimator()
    max_blocks = div_up(max_size, BLOCK_SIZE)
    est.alloc(num_in_batch * NUM_SYMBOLS * 16)  # uint4 table
    if not have_histogram:
        est.alloc(num_in_batch * NUM_SYMBOLS * 4)
    est.alloc(num_in_batch * 4)  # checksums
    uncoalesced_stride = 128 + raw_comp_block_max_size(BLOCK_SIZE)
    est.alloc(num_in_batch * max_blocks * uncoalesced_stride)
    est.alloc(num_in_batch * max_blocks * 4)  # compressedWords
    est.alloc(num_in_batch * max_blocks * 4)  # prefix
    return est.high


def float_compress_temp_size(num_in_batch: int, max_size: int,
                             float_type: FloatType) -> int:
    """Replicates floatCompressDevice's allocation schedule
    (GpuFloatCompress.cuh:698-752) plus the inner ANS encode."""
    est = StackMemoryEstimator()
    est.alloc(num_in_batch * 4)  # checksum
    comp_row_stride = round_up(max_size, 16)
    comp_dataset_stride = round_up(num_in_batch * comp_row_stride, 16)
    est.alloc(comp_dataset_stride * 2)  # toComp (2 planes reserved)
    est.alloc(num_in_batch * 4)  # tempOutSize
    est.alloc(num_in_batch * 4)  # ansOutOffset
    hist_stride = round_up(num_in_batch * NUM_SYMBOLS, 4)
    est.alloc(hist_stride * 4 * 2)  # histograms
    inner = ans_encode_temp_size(num_in_batch, max_size, have_histogram=True)
    return est.high + inner * FLOAT_NUM_COMP_SEGMENTS[FloatType(float_type)]


def ans_decode_temp_size(num_in_batch: int, prob_bits: int) -> int:
    """ansDecodeBatch: decode LUTs (GpuANSDecode.cuh:488-489)."""
    est = StackMemoryEstimator()
    est.alloc(num_in_batch * (1 << prob_bits) * 4)
    return est.high


def float_decompress_temp_size(num_in_batch: int, max_size: int,
                               float_type: FloatType,
                               prob_bits: int) -> int:
    """floatDecompressDevice two-pass path (GpuFloatDecompress.cuh:975-1073)."""
    est = StackMemoryEstimator()
    stride = round_up(max_size, 16)
    nseg = FLOAT_NUM_COMP_SEGMENTS[FloatType(float_type)]
    est.alloc(num_in_batch * stride * nseg)  # temp exponents
    return est.high + ans_decode_temp_size(num_in_batch, prob_bits)
