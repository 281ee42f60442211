"""Interleaved 32-state rANS encoder: kernel K2, in the row-stream
(0xDB0D) and the classic (0xD00D) layout, and its plain versions.

Each block of 4096 bytes is coded by 32 interleaved states over 128 steps
(state l codes byte 32*s + l at step s).

* ``encode_rows``: the emissions of each ROW of 4 consecutive blocks form
  one shared stream, step-major and, within a step, blocks then lanes
  ascending (the JAX package's ``ops/rans_encode.py:112``, the contract of
  ``encode_blocks_rows``).
* ``encode_blocks``: each block has its own stream, step-major and lanes
  ascending (the JAX package's ``ops/rans_encode.py:51``,
  ``encode_blocks``), the CUDA reference's own layout.

Both send a CUDA tensor to the kernel (``csrc/rans_encode_rows.cu``) and a
CPU tensor to the plain version, built from the JAX package's
``_walk_cpu`` and its compaction (which sorts on each emission's rank in
its stream; here the rank indexes a scatter).
"""

from __future__ import annotations

import torch

from ..core.config import use_kernels
from ..core.constants import (
    ANS_START_STATE,
    ANS_STATE_BITS,
    BLOCK_SIZE,
    MAX_BLOCK_WORDS32,
    MAX_ROW_WORDS32,
    NUM_SYMBOLS,
    STEPS_PER_BLOCK,
    VALID_PROB_BITS,
    WARP_SIZE,
)
from ..runtime import cuda_kernels as K
from .bitops import M32, from_u32, to_u32, umulhi
from .float_split import unpack_bytes


def _check_encode_args(x32, sizes, packed, magic, prob_bits):
    if x32.dtype != torch.int32 or x32.dim() != 2 or not x32.is_contiguous():
        raise TypeError("x32 must be a contiguous 2-D torch.int32 tensor")
    B, W = x32.shape
    if W == 0 or W % (BLOCK_SIZE // 4):
        raise ValueError(f"x32 row width {W} is not a positive multiple of 1024")
    for name, t, shape in (("sizes", sizes, (B,)),
                           ("packed", packed, (B, NUM_SYMBOLS)),
                           ("magic", magic, (B, NUM_SYMBOLS))):
        if t.dtype != torch.int32 or t.shape != shape or t.device != x32.device:
            raise TypeError(f"{name} must be torch.int32 {shape} on {x32.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if prob_bits not in VALID_PROB_BITS:
        raise ValueError(f"prob_bits must be one of {VALID_PROB_BITS}, got {prob_bits}")


def encode_rows(x32, sizes, packed, magic, prob_bits: int):
    """Encode every block of a batch into row streams.

    x32: int32[B, NB*1024] packed symbol bytes; sizes: int32[B] byte
    counts; packed: int32[B, 256] (pdf | cdf << 12 | shift << 23);
    magic: int32[B, 256]. Returns (states int32[B, NB, 32], streams
    int32[B, NR, MAX_ROW_WORDS32] of u16 pairs, zero past each row's
    words, NR = ceil(NB / 4), num_words int32[B, NB] per block).
    """
    _check_encode_args(x32, sizes, packed, magic, prob_bits)
    if use_kernels(x32):
        return K.encode_rows(x32, sizes, packed, magic, prob_bits)
    return encode_rows_plain(x32, sizes, packed, magic, prob_bits)


def encode_blocks(x32, sizes, packed, magic, prob_bits: int):
    """Encode every block of a batch into per-block streams.

    Arguments as ``encode_rows``. Returns (states int32[B, NB, 32], streams
    int32[B, NB, MAX_BLOCK_WORDS32] of u16 pairs, zero past each block's
    words, num_words int32[B, NB]).
    """
    _check_encode_args(x32, sizes, packed, magic, prob_bits)
    if use_kernels(x32):
        return K.encode_blocks(x32, sizes, packed, magic, prob_bits)
    return encode_blocks_plain(x32, sizes, packed, magic, prob_bits)


def _walk(x32, sizes, packed, magic, prob_bits):
    """The 128-step encode walk. Returns (states int64[B, NB, 32],
    words int64[S, B, NB, 32], mask bool[S, B, NB, 32])."""
    dev = x32.device
    B, W = x32.shape
    NB = W // (BLOCK_SIZE // 4)
    sym = unpack_bytes(to_u32(x32))  # [B, NB*4096]
    tab = torch.gather(to_u32(packed), 1, sym).reshape(
        B, NB, STEPS_PER_BLOCK, WARP_SIZE)
    mag = torch.gather(to_u32(magic), 1, sym).reshape(
        B, NB, STEPS_PER_BLOCK, WARP_SIZE)
    pos = torch.arange(NB * BLOCK_SIZE, dtype=torch.int64, device=dev).reshape(
        NB, STEPS_PER_BLOCK, WARP_SIZE)
    valid = pos[None] < sizes.to(torch.int64)[:, None, None, None]

    check_shift = ANS_STATE_BITS - prob_bits
    states = torch.full((B, NB, WARP_SIZE), ANS_START_STATE, dtype=torch.int64,
                        device=dev)
    words, masks = [], []
    for s in range(STEPS_PER_BLOCK):
        t, m, v = tab[:, :, s], mag[:, :, s], valid[:, :, s]
        pdf = t & 0xFFF
        cdf = (t >> 12) & 0x7FF
        shift = (t >> 23).clamp(max=31)
        write = v & (states >= (pdf << check_shift))
        words.append(states & 0xFFFF)
        masks.append(write)
        states = torch.where(write, states >> 16, states)
        # exact (state / pdf, state % pdf) by magic multiply
        # (GpuANSEncode.cuh:79-86)
        q = ((umulhi(states, m) + states) & M32) >> shift
        mod = (states - q * pdf) & M32
        states = torch.where(v, ((q << prob_bits) + mod + cdf) & M32, states)
    return states, torch.stack(words), torch.stack(masks)


def _compact(words, mask, group: int, cap32: int):
    """Order each stream's emissions: (S, B, NB, 32) -> int64[B, G, cap32]
    u16 pairs for streams of `group` consecutive blocks (G = ceil(NB /
    group)), step-major, then blocks, then lanes. Each emitted word goes to
    its rank in its stream; words past cap32 u16 pairs, and non-emissions,
    go to a dropped slot."""
    S, B, NB, _ = words.shape
    G = -(-NB // group)

    def streams(a):  # (S, B, NB, 32) -> (B, G, S*group*32)
        a = torch.nn.functional.pad(a, (0, 0, 0, G * group - NB))
        return a.reshape(S, B, G, group * WARP_SIZE).permute(1, 2, 0, 3).reshape(
            B, G, S * group * WARP_SIZE)

    words_g = streams(words)
    mask_g = streams(mask)
    cap = 2 * cap32
    rank = torch.cumsum(mask_g.to(torch.int64), dim=2) - 1
    slot = torch.where(mask_g & (rank < cap), rank, cap)
    w16 = torch.zeros((B, G, cap + 1), dtype=torch.int64, device=words.device)
    w16 = w16.scatter_(2, slot, torch.where(mask_g, words_g, 0))[..., :cap]
    return w16[..., 0::2] | (w16[..., 1::2] << 16)


def encode_blocks_plain(x32, sizes, packed, magic, prob_bits: int):
    """Plain PyTorch version of K2's classic layout; runs on any device."""
    _check_encode_args(x32, sizes, packed, magic, prob_bits)
    states, words, mask = _walk(x32, sizes, packed, magic, prob_bits)
    num_words = mask.sum(dim=(0, 3)).to(torch.int32)
    streams = _compact(words, mask, 1, MAX_BLOCK_WORDS32)
    return from_u32(states), from_u32(streams), num_words


def encode_rows_plain(x32, sizes, packed, magic, prob_bits: int):
    """Plain PyTorch version of K2's row layout; runs on any device."""
    _check_encode_args(x32, sizes, packed, magic, prob_bits)
    states, words, mask = _walk(x32, sizes, packed, magic, prob_bits)
    num_words = mask.sum(dim=(0, 3)).to(torch.int32)
    streams = _compact(words, mask, 4, MAX_ROW_WORDS32)
    return from_u32(states), from_u32(streams), num_words
