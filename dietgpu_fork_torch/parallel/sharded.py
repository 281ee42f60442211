"""Data-parallel batch compression over a ``torch.distributed`` process group.

A port of the JAX package's ``parallel/sharded.py``. A batch of
independently decodable archives is embarrassingly parallel: each rank runs
the whole codec on its block of members with no communication, and
collectives appear only where the semantics need them (the shared
histogram, the size exchange). Where the JAX package shards one global
array over a mesh axis with ``shard_map``, here each rank holds its block
(``shard_batch``) and calls the function itself; the mesh is a process
group (``data_mesh``), whose ranks are the axis indices. The archives are
classic (0xD00D), as the JAX package's default.

Every function takes ``plain=True`` to run every kernel's plain PyTorch
version wherever the tensors lie.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.constants import DEFAULT_PROB_BITS, FloatType
from ..models.ans import ans_decode_padded, ans_encode_padded
from ..models.float_codec import float_compress_padded, float_decompress_core
from ..ops.histogram import byte_hist, byte_hist_plain
from .collectives import _all_gather_rows

# the shared table normalises against the global byte total in int32
_MAX_TOTAL = (1 << 31) - 1


def data_mesh(ranks=None):
    """The process group of a 1-D data-parallel mesh: the default group, or
    a new group of ``ranks`` (every process of the default group must make
    the call, as ``dist.new_group`` needs)."""
    if ranks is None:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def shard_batch(group, x: torch.Tensor, device=None) -> torch.Tensor:
    """This rank's contiguous block of B / world rows of the (B, ...) batch
    ``x``, on the current CUDA device unless ``device`` says otherwise."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    if x.shape[0] % world:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{world} ranks")
    rows = x.shape[0] // world
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return x[rank * rows: (rank + 1) * rows].to(device)


def float_compress_sharded(
    group,
    data32: torch.Tensor,
    sizes: torch.Tensor,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    plain: bool = False,
):
    """Compress the rank's block of members (int32[b, W32] packed floats,
    sizes[b] float counts) with no communication. Returns (comp
    uint8[b, CB], comp_bytes int64[b])."""
    return float_compress_padded(data32, sizes, FloatType(float_type),
                                 prob_bits, use_checksum, native=False,
                                 plain=plain)


def float_decompress_sharded(
    group,
    comp_u8: torch.Tensor,
    out_floats: int,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    plain: bool = False,
):
    """Decompress the rank's block of archives (uint8[b, CB]), each of
    capacity out_floats; ``float_decompress_core``'s five outputs."""
    C = comp_u8.shape[1]
    comp_u8 = F.pad(comp_u8, (0, -C % 4)) if C % 4 else comp_u8.contiguous()
    b = comp_u8.shape[0]
    dev = comp_u8.device
    return float_decompress_core(
        comp_u8.view(torch.int32), torch.zeros(b, dtype=torch.int64, device=dev),
        out_floats, FloatType(float_type), prob_bits,
        torch.full((b,), out_floats, dtype=torch.int64, device=dev),
        native=False, plain=plain,
    )


def ans_encode_sharded(
    group,
    x_u8: torch.Tensor,
    sizes: torch.Tensor,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    plain: bool = False,
):
    """Raw-ANS encode of the rank's block of byte rows (uint8[b, S]).
    Returns (comp uint8[b, CB], comp_bytes int64[b])."""
    return ans_encode_padded(x_u8, sizes, prob_bits, use_checksum,
                             native=False, plain=plain)


def ans_decode_sharded(
    group,
    comp_u8: torch.Tensor,
    out_capacity: int,
    prob_bits: int = DEFAULT_PROB_BITS,
    plain: bool = False,
):
    """Raw-ANS decode of the rank's block of archives; returns (out
    uint8[b, out_capacity], success, n, csum)."""
    return ans_decode_padded(comp_u8, out_capacity, prob_bits, native=False,
                             plain=plain)


def ans_encode_shared_table(
    group,
    x_u8: torch.Tensor,
    sizes: torch.Tensor,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    plain: bool = False,
):
    """Shared-frequency-table encode: the byte histograms of every rank's
    members are summed by one all-reduce over the group, and every member
    is encoded against that one table, normalised by the global byte total.
    Every archive embeds the same table and still decodes on its own.

    The global byte total must fit int32 (about 2.1 GB): a larger one raises
    ValueError on every rank. Returns (comp uint8[b, CB], comp_bytes
    int64[b])."""
    sz = sizes.to(device=x_u8.device, dtype=torch.int32)
    hist_fn = byte_hist_plain if plain else byte_hist
    # the histogram counts each member's first sizes[b] bytes only, so the
    # bytes past them need no mask
    h = hist_fn(x_u8, sz)[0]
    g = torch.cat([h.sum(dim=0, dtype=torch.int64),
                   sz.sum(dtype=torch.int64).reshape(1)])
    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    gtot = int(g[256])
    if gtot > _MAX_TOTAL:
        raise ValueError(f"the group's {gtot} bytes pass the shared table's "
                         f"int32 total")
    b = x_u8.shape[0]
    hist = g[:256].to(torch.int32)[None, :].expand(b, 256)
    tots = torch.full((b,), gtot, dtype=torch.int32, device=x_u8.device)
    return ans_encode_padded(x_u8, sz, prob_bits, use_checksum, hist=hist,
                             hist_totals=tots, native=False, plain=plain)


def global_compressed_sizes(comp_bytes: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's per-member compressed sizes, all-gathered in rank order
    (every rank holds as many members), so each rank can place outputs in
    submission order."""
    return _all_gather_rows(comp_bytes, group).reshape(
        (-1,) + tuple(comp_bytes.shape[1:]))
