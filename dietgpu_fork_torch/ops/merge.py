"""Ragged multi-source runs merge: kernel K3 and its plain version.

    out[dst[r] + i] = srcs[ref[r]][off[r] + i]   for i < lens[r]
    out[j] = 0                                   where no run covers j

The merge places every piece of an archive (float header, raw section,
ANS metadata, row streams) in one pass on compress, and on decompress
stages the raw sections of the two-pass float decode and the sparse
bitmap; the rANS decode reads its streams, states and (fused) raw
sections from the archive in place.

Runs have nondecreasing ends (dst + lens); destinations are sorted and do
not overlap (a zero-length run may sit anywhere at or after the end of the
run before it). Word j takes the first run whose end lies past j. At
most ``MAX_MERGE_SOURCES`` (8) sources, on every device: K3 takes them by
value. Offsets are int64
throughout, and the source ref is an explicit index per run: the JAX
package's packing of the ref into the offset's top bits (``_RSH = 28``)
is not ported. A read past the end of a source (a corrupt archive) takes
that source's last word; a ref outside the sources gives zeros.
``_runs_merge_ref`` clips into its sources laid end to end, so the two
agree on such reads for a single source.

K3 replaces both Pallas merges: ``merge.py:305`` ``_merge2_kernel`` (the
multi-source merge) and, called with one source, ``merge.py:74``
``_merge_kernel`` (the v1 single-source merge, entry ``_runs_merge_tpu``),
whose contract is this one with ``srcs = [src_flat]`` and every ref 0.
The two-pass float decode's raw staging and the sparse decode's bitmap
staging are such single-source calls.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.config import use_kernels
from ..runtime import cuda_kernels as K
from ..runtime.cuda_kernels import MAX_MERGE_SOURCES


def _check_merge_args(srcs, dst, ref, off, lens, out_len):
    if not srcs:
        raise ValueError("runs_merge needs at least one source")
    dev = dst.device
    for s in srcs:
        if s.dtype != torch.int32 or s.dim() != 1 or not s.is_contiguous():
            raise TypeError("sources must be contiguous 1-D torch.int32")
        if s.numel() == 0:
            raise ValueError("sources must not be empty")
        if s.device != dev:
            raise ValueError("sources and runs must lie on one device")
    R = dst.shape[0]
    for name, t, dt in (("dst", dst, torch.int64), ("off", off, torch.int64),
                        ("lens", lens, torch.int64), ("ref", ref, torch.int32)):
        if t.dtype != dt or t.shape != (R,) or t.device != dev:
            raise TypeError(f"{name} must be {dt} of shape [{R}] on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_len < 0:
        raise ValueError("out_len must be >= 0")


def runs_merge(
    srcs: Sequence[torch.Tensor],
    dst: torch.Tensor,
    ref: torch.Tensor,
    off: torch.Tensor,
    lens: torch.Tensor,
    out_len: int,
) -> torch.Tensor:
    """srcs: 1-D int32 tensors (u32 words); dst/off/lens: int64[R];
    ref: int32[R] indices into srcs. Returns int32[out_len]."""
    srcs = list(srcs)
    _check_merge_args(srcs, dst, ref, off, lens, out_len)
    if len(srcs) > MAX_MERGE_SOURCES:
        raise ValueError(f"runs_merge takes at most {MAX_MERGE_SOURCES} "
                         f"sources, not {len(srcs)}")
    if use_kernels(dst):
        return K.runs_merge(srcs, dst, ref, off, lens, out_len)
    return runs_merge_plain(srcs, dst, ref, off, lens, out_len)


def runs_merge_plain(srcs, dst, ref, off, lens, out_len: int):
    """Plain PyTorch version of K3 (the gather formulation of
    ``_runs_merge_ref``): each output word finds its run by binary search.
    The search runs over run ends (dst + len, nondecreasing), so
    zero-length runs never hide the run that covers a word."""
    srcs = list(srcs)
    _check_merge_args(srcs, dst, ref, off, lens, out_len)
    dev = dst.device
    out = torch.zeros(out_len, dtype=torch.int32, device=dev)
    R = dst.shape[0]
    if R == 0 or out_len == 0:
        return out
    j = torch.arange(out_len, dtype=torch.int64, device=dev)
    ends = dst + lens
    r = torch.searchsorted(ends, j, right=True).clamp(max=R - 1)
    d = dst[r]
    inside = (j >= d) & (j < ends[r])
    rid = ref[r]
    o = off[r] + (j - d)
    for i, s in enumerate(srcs):
        idx = o.clamp(0, s.numel() - 1)
        out = torch.where(inside & (rid == i), s[idx], out)
    return out
