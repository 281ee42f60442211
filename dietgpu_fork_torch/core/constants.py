"""Archive-format constants of the PyTorch/CUDA port.

An own copy of what the port reads from the JAX package's
``core/constants.py``: that package's ``__init__`` imports jax, so the port
cannot import it. ``tests/test_torch_import.py`` holds the two copies equal.
"""

from __future__ import annotations

import enum

NUM_SYMBOLS = 256

# Uncompressed bytes per independent coding block, interleaved rANS states
# per block, and symbol positions per state (GpuANSUtils.cuh:37).
BLOCK_SIZE = 4096
WARP_SIZE = 32
STEPS_PER_BLOCK = BLOCK_SIZE // WARP_SIZE  # 128

# States live in [2^15, 2^31); renormalisation moves 16-bit words.
ANS_STATE_BITS = 31
ANS_ENCODED_BITS = 16
ANS_ENCODED_MASK = (1 << ANS_ENCODED_BITS) - 1
ANS_START_STATE = 1 << (ANS_STATE_BITS - ANS_ENCODED_BITS)  # 2^15
ANS_MIN_STATE = ANS_START_STATE

# Magic and version words. 0xDB0D is the row-stream ANS layout: the streams
# of each row of 4 blocks interleave per step (blocks, then lanes, ascending)
# into one segment, 16 B aligned per row.
ANS_MAGIC = 0xD00D
ANS_VERSION = 0x0001
ANS_MAGIC_NATIVE = 0xDB0D
FLOAT_MAGIC = 0xF00F
FLOAT_VERSION = 0x0001
# Float container v2: members of >= FLOAT_ALIGN_MIN floats in native
# archives start their raw sections on 512 B (128-word) boundaries.
FLOAT_VERSION_ALIGNED = 0x0002
FLOAT_ALIGN_MIN = 1 << 20
FLOAT_SECTION_ALIGN_BYTES = 512

BLOCK_ALIGNMENT = 16
VALID_PROB_BITS = (9, 10, 11)
DEFAULT_PROB_BITS = 10

ANS_HEADER_BYTES = 32
FLOAT_HEADER_BYTES = 16
FLOAT_HEADER2_BYTES = 16
# The sparse archive's header holds the float count only: no magic.
SPARSE_HEADER_BYTES = 16


class FloatType(enum.IntEnum):
    UNDEFINED = 0
    FLOAT16 = 1
    BFLOAT16 = 2
    FLOAT32 = 3
    FLOAT64 = 4


FLOAT_WORD_SIZE = {
    FloatType.FLOAT16: 2,
    FloatType.BFLOAT16: 2,
    FloatType.FLOAT32: 4,
    FloatType.FLOAT64: 8,
}

# ANS-coded exponent planes per float type (fp64 codes two bytes per float,
# each plane its own ANS archive; GpuFloatUtils.cuh:78-96).
FLOAT_NUM_COMP_SEGMENTS = {
    FloatType.FLOAT16: 1,
    FloatType.BFLOAT16: 1,
    FloatType.FLOAT32: 1,
    FloatType.FLOAT64: 2,
}


def div_up(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return div_up(a, b) * b


def num_blocks(uncompressed_bytes: int) -> int:
    return div_up(uncompressed_bytes, BLOCK_SIZE)


def raw_comp_block_max_size(uncompressed_block_bytes: int = BLOCK_SIZE) -> int:
    """Worst-case compressed bytes of one block (GpuANSEncode.cuh:31-36)."""
    return round_up(
        uncompressed_block_bytes + uncompressed_block_bytes // 4, BLOCK_ALIGNMENT
    )


def ans_compressed_overhead(nblocks: int) -> int:
    """Archive bytes before the compressed streams (GpuANSUtils.cuh:68-81)."""
    return (
        ANS_HEADER_BYTES
        + 2 * NUM_SYMBOLS
        + 4 * WARP_SIZE * nblocks
        + 8 * round_up(nblocks, 2)
    )


def max_compressed_size(uncompressed_bytes: int) -> int:
    """Worst-case ANS archive size. Like the CUDA reference, the overhead is
    taken for a constant 4096 blocks whatever the input size."""
    blocks = num_blocks(uncompressed_bytes)
    raw = ans_compressed_overhead(BLOCK_SIZE)
    raw += raw_comp_block_max_size(BLOCK_SIZE) * blocks
    return round_up(raw, 16)


def float_uncomp_data_size(float_type: FloatType, size: int) -> int:
    """Bytes of the raw float sections, each 16 B aligned."""
    ft = FloatType(float_type)
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        return round_up(size, 16)
    if ft == FloatType.FLOAT32:
        return 2 * round_up(size, 8) + round_up(size, 16)
    if ft == FloatType.FLOAT64:
        return 4 * round_up(size, 4) + 2 * round_up(size, 8)
    raise ValueError(f"unsupported float type {float_type}")


def max_float_compressed_size(float_type: FloatType, size: int) -> int:
    """Worst-case float archive size (GpuFloatCompress.cu:23-48)."""
    ft = FloatType(float_type)
    base = FLOAT_HEADER_BYTES + FLOAT_HEADER2_BYTES + max_compressed_size(size)
    base += float_uncomp_data_size(ft, size)
    if ft == FloatType.FLOAT64:
        base += max_compressed_size(size)
    return base


def sparse_bitmap_bytes(size: int) -> int:
    """Bytes of the sparse archive's bit-packed nonzero bitmap, 16 B
    aligned (GpuSparseFloatCompress.cuh:208-222)."""
    return round_up(div_up(size, 8), 16)


def max_sparse_float_compressed_size(float_type: FloatType, size: int) -> int:
    """Worst-case sparse float archive size (GpuSparseFloatCompress.cu:16-24)."""
    return (SPARSE_HEADER_BYTES + sparse_bitmap_bytes(size)
            + max_float_compressed_size(float_type, size))


# Worst-case u16 words of one block's stream, and of one row of 4 blocks,
# in u32 words.
MAX_BLOCK_WORDS32 = raw_comp_block_max_size(BLOCK_SIZE) // 4  # 1280
MAX_ROW_WORDS32 = 4 * MAX_BLOCK_WORDS32  # 5120
