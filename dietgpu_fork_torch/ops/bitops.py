"""uint32 arithmetic on int64 carriers.

PyTorch has no shifts, sums or comparisons for ``torch.uint32`` on the
CPU, so the plain (non-kernel) code carries each u32 value in an int64
lane, masked to 32 bits after every operation that can leave that range.
At the public functions the same bits travel as ``torch.int32``;
``to_u32`` and ``from_u32`` convert between the two. The CUDA kernels do
this arithmetic natively in ``uint32_t`` (``__umulhi``, ``__clz``).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def to_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & M32


def from_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 carrying u32 values (any bits above 31 ignored) -> int32 with
    the same low 32 bits."""
    t = t & M32
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> their int32 reading, still in int64 (the
    JAX package's ``.astype(int32)`` of a uint32)."""
    t = t & M32
    return torch.where(t >= (1 << 31), t - (1 << 32), t)


def umulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of the 64-bit product of two u32 values (PTX
    ``__umulhi``), exact in int64 by splitting ``a`` into 16-bit halves."""
    a = a & M32
    b = b & M32
    lo = (a & 0xFFFF) * b  # < 2^48
    hi = (a >> 16) * b  # < 2^48
    return (hi + (lo >> 16)) >> 16


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 value (PTX ``__popc``), SWAR in int64."""
    x = x & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count of leading zeros of a u32 value; clz32(0) == 32."""
    x = x & M32
    bits = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        big = t > 0
        bits = bits + big.to(x.dtype) * s
        x = torch.where(big, t, x)
    return 32 - (bits + (x > 0).to(bits.dtype))


def udiv_u43_by_u32(a_hi: torch.Tensor, divisor: torch.Tensor) -> torch.Tensor:
    """floor((a_hi << 32) / divisor) for a_hi < divisor <= 2^31, exact in
    int64 (the magic-constant division of GpuANSStatistics.cuh:345-358,
    where a_hi = 2^shift - pdf < 2^11)."""
    return ((a_hi & M32) << 32) // (divisor & M32)
