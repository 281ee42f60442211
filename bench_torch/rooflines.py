"""The bytes that one launch of each of the port's kernels needs, and the
least time an H100 can take for them.

Keyed by the wrapper's name in ``dietgpu_fork_torch.runtime.cuda_kernels``,
the name the ops modules look the launch up by. Each byte counts once, as
read or as written, and only what the call's data needs, not the capacity
of the tensors that hold it: the floats below each member's count, the
nonzero floats, the coded words, the words of the runs a merge copies, in
and out alike. K2's streams count up to their words, in its 16 B stores:
the zeros it writes past them are no part of the result, since the merge
copies only the words. Outputs count whole where the whole is the result:
histograms, checksums, states, word counts, lookups, and a merge's archive
rows with the zeros past each member's bytes that the API promises. An
argument that ``NEEDS`` does not name counts whole, and so does every
output of a wrapper it does not list. A kernel whose count is not here has
it in ``kernel_bytes/<wrapper>.py``, a module with
``nbytes(args, out) -> int``.

Copied from the port's ``chip_smoke.py`` (``bound_ms`` and ``_DATA_INPUT``),
with its outputs counted by the same rule as its inputs.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

# H100 SXM (80 GB HBM3) device memory, NVIDIA's data sheet, at 700 W
HBM_BYTES_PER_S = 3.35e12
WARP = 32  # rANS states a block
_WORD_SIZE = {1: 2, 2: 2, 3: 4, 4: 8}  # the port's FloatType codes
_HERE = Path(__file__).resolve().parent


def tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


def _ws(ft) -> int:
    return _WORD_SIZE[int(ft)]


def _below(n, cap: int) -> int:
    """Floats below each row's count n, within the row's capacity."""
    return int(n.to(torch.int64).clamp(0, cap).sum())


def _nnz(ranks) -> int:
    return int(ranks[:, -1].sum())


def _live_words(bm32, n) -> int:
    """Bitmap words holding a float below n, over the rows: the words the
    rank scan must read."""
    return int(((n.to(torch.int64).clamp(0, 32 * bm32.shape[1]) + 31) // 32).sum())


def _distinct(tables, idx) -> int:
    """Distinct clamped indices over the rows: the table words that one
    lookup per row must read."""
    s = idx.clamp(0, tables.shape[1] - 1).sort(dim=1).values
    return int(s.shape[0] + (s[:, 1:] != s[:, :-1]).sum()) if s.numel() else 0


def _decode_need(a) -> int:
    """The archive bytes an in-place decode (``decode_at``'s arguments)
    needs of the whole archive tensor it is handed: the streams' words, the
    states of the blocks that decode something, and the raw section bytes
    below each block's count (1 a float for the 16-bit join, 3 for
    fp32's)."""
    seg_len, uncomp_w, raw_off, sec2_off = a[2], a[4], a[8], a[9]
    raw = 0 if raw_off is None else (1 if sec2_off is None else 3)
    return (4 * int(seg_len.clamp(min=0).sum())
            + 4 * WARP * int((uncomp_w > 0).sum()) + raw * int(uncomp_w.sum()))


def _decode_out(a, out) -> int:
    """The decoded symbols below each block's count, at the epilogue's
    width (a block of 4096 symbols fills ``out.shape[-1]`` words)."""
    return out.shape[-1] * _below(a[4], 4096) // 1024


def _split16_n(a) -> int:
    return _below(a[1], 2 * a[0].shape[1])


def _split_wide_n(a) -> int:
    return _below(a[1], 4 * a[0].shape[1] // _ws(a[2]))


def _join_at_need(a) -> int:
    """K7's archive mode: the section and plane bytes of the floats below
    each count (3 + 1 B a float for fp32, 6 + 2 for fp64)."""
    planes, count, ft = a[1], a[4], a[5]
    return _ws(ft) * _below(count, 4 * planes[0].shape[1])


def _join16_at_need(a) -> int:
    """K13's archive mode: 1 B of raw section and 1 B of plane a float
    below each count."""
    plane, count = a[1], a[3]
    return 2 * _below(count, 4 * plane.shape[1])


def _streams_need(out, group: int) -> int:
    """K2's states and word counts, and its streams up to their words in
    16 B stores: a stream holds the u16 words of its ``group`` blocks (4 a
    row, 1 in the classic layout), up to its capacity."""
    states, streams, num_words = out
    B, NB = num_words.shape
    w = num_words.to(torch.int64)
    if group > 1:
        w = torch.nn.functional.pad(w, (0, -NB % group)).reshape(B, -1, group).sum(dim=2)
    words = w.clamp(0, 2 * streams.shape[-1])
    return tensor_bytes(states) + tensor_bytes(num_words) + 16 * int(((words + 7) // 8).sum())


# wrapper: (argument indices, the bytes this call's data needs of them,
# the bytes it needs of the outputs, or None: all of them)
NEEDS = {
    "split16_hist": ((0,), lambda a: 2 * _split16_n(a),
                     lambda a, o: 2 * _split16_n(a) + tensor_bytes(o[2:])),
    "split_wide_hist": ((0,), lambda a: _ws(a[2]) * _split_wide_n(a),
                        lambda a, o: _ws(a[2]) * _split_wide_n(a) + tensor_bytes(o[3:])),
    "encode_rows": ((0,), lambda a: int(a[1].sum()), lambda a, o: _streams_need(o, 4)),
    "encode_blocks": ((0,), lambda a: int(a[1].sum()), lambda a, o: _streams_need(o, 1)),
    "runs_merge": ((0,), lambda a: 4 * int(a[4].sum()), None),
    "decode_join16": ((0,), _decode_need, _decode_out),
    "decode_join16_blocks": ((0,), _decode_need, _decode_out),
    "decode_rows": ((0,), _decode_need, _decode_out),
    "decode_blocks": ((0,), _decode_need, _decode_out),
    "decode_join32": ((0,), _decode_need, _decode_out),
    "decode_join32_blocks": ((0,), _decode_need, _decode_out),
    "join_wide_at": ((0, 1), _join_at_need, lambda a, o: _join_at_need(a)),
    "join16_at": ((0, 1), _join16_at_need, lambda a, o: _join16_at_need(a)),
    "byte_hist": ((0,), lambda a: int(a[1].sum()), None),
    "pack_bitmap": ((0,), lambda a: _ws(a[2]) * _below(a[1], 4 * a[0].shape[1] // _ws(a[2])),
                    lambda a, o: 4 * int(((a[1].to(torch.int64).clamp(0, 32 * o.shape[1])
                                            + 31) // 32).sum())),
    "compact_by_bitmap": ((0,), lambda a: _ws(a[3]) * _nnz(a[2]),
                          lambda a, o: _ws(a[3]) * _nnz(a[2])),
    "expand_by_bitmap": ((0,), lambda a: _ws(a[5]) * _nnz(a[2]),
                         lambda a, o: _ws(a[5]) * _below(a[3], a[4])),
    "rowwise_lookup": ((0,), lambda a: 4 * _distinct(*a), None),
    "word_ranks": ((0,), lambda a: 4 * _live_words(*a),
                   lambda a, o: 4 * (_live_words(*a) + o.shape[0])),
}

# every wrapper of runtime/cuda_kernels.py that launches a kernel
WRAPPERS = (
    "split16_hist", "split16", "split_wide_hist", "split_wide",
    "encode_rows", "encode_blocks", "runs_merge",
    "decode_rows", "decode_blocks", "decode_join16", "decode_join16_blocks",
    "decode_join32", "decode_join32_blocks",
    "join_wide", "join_wide_at", "join16_rows", "join16_at",
    "byte_hist", "pack_bitmap", "word_ranks", "compact_by_bitmap",
    "expand_by_bitmap", "chunked_lookup", "rowwise_lookup",
)


def _extra(wrapper: str):
    path = _HERE / "kernel_bytes" / f"{wrapper}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(f"kernel_bytes_{wrapper}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.nbytes


def kernel_bytes(wrapper: str, args, out) -> int:
    """The bytes one launch of ``wrapper`` on these arguments needs."""
    extra = _extra(wrapper)
    if extra is not None:
        return int(extra(args, out))
    idx, need_in, need_out = NEEDS.get(wrapper, ((), None, None))
    nbytes = sum(tensor_bytes(x) for k, x in enumerate(args) if k not in idx)
    if need_in is not None:
        nbytes += need_in(args)
    return nbytes + (tensor_bytes(out) if need_out is None else need_out(args, out))


def bound_s(nbytes: int) -> float:
    """The least seconds for nbytes at the device memory's rate."""
    return nbytes / HBM_BYTES_PER_S
