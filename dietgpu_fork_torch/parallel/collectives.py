"""Compressed collectives on ``torch.distributed``: each rank float-compresses
its piece, the compressed words ride the collective, and receivers decompress
locally.

A port of the JAX package's ``parallel/collectives.py``. There one global
array is sharded over a mesh axis and each function runs under
``shard_map``; here each rank holds only its own piece (the block of rows
that the mesh would place on its device), calls the function itself, and
gets its piece of the JAX function's output back. The mesh axis becomes a
process group (``None``: the default group), whose ranks are the axis
indices.

Wire protocol, as in the JAX package:

1. SIZE EXCHANGE: each rank compresses its piece (classic 0xD00D layout,
   as the JAX package's default) and all-gathers a (2,) header [flag,
   payload_words]. The payload is the archive when it is no larger than the
   raw piece (flag 1), else the raw words (flag 2), so incompressible data
   costs raw plus chunk rounding and transport never fails for capacity.
2. TRANSFER: the headers are read on the host once (the transport's one
   device-to-host read), and ONE collective moves ``nchunks * chunk_w``
   words, nchunks = ceil(max payload / chunk_w). The JAX package moves the
   same words in a loop of chunk_w-word collectives, which XLA's static
   shapes need; the ``wire`` statistic, the words a rank moved, is the same
   number in both.

Every received row goes through the decode, as in the JAX package: a raw
row (flag 2) fails it and is taken as it came. A rank that no pair of a
permutation sends to receives a zero header and zero words: it gets zeros
and ``ok=False``, as under ``jax.lax.ppermute``.

Every function takes ``plain=True`` to run every kernel's plain PyTorch
version wherever the tensors lie, and ``return_stats=True`` to return the
rank's wire words too.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.constants import DEFAULT_PROB_BITS, FLOAT_WORD_SIZE, FloatType
from ..models.float_codec import float_compress_core, float_decompress_core

_FLAG_COMP = 1  # payload words are a float archive
_FLAG_RAW = 2  # payload words are the raw piece (the archive was larger)

_FT_OF = {
    torch.float16: FloatType.FLOAT16,
    torch.bfloat16: FloatType.BFLOAT16,
    torch.float32: FloatType.FLOAT32,
    torch.float64: FloatType.FLOAT64,
}


def _chunk_words(payload_words: int, override: Optional[int]) -> int:
    """Transfer granularity: ~1/64 of the payload buffer, 128-word aligned,
    clamped to [128, 8192] words (512 B .. 32 KiB)."""
    if override is not None:
        cw = override
    else:
        cw = min(8192, max(128, payload_words // 64))
    return -(-cw // 128) * 128


def _pad_words(payload_words: int, chunk_w: int) -> int:
    return max(chunk_w, -(-payload_words // chunk_w) * chunk_w)


def _ft_of(dtype: torch.dtype) -> FloatType:
    try:
        return _FT_OF[dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype}") from None


def _to_u32(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Flatten a float tensor to little-endian u32 words (int32 bits): 16-bit
    pairs low half first, the last pair zero padded; fp64 as (lo, hi) word
    pairs. Returns (words int32[W32], float count, W32)."""
    n = x.numel()
    _ft_of(x.dtype)
    b = x.reshape(-1).contiguous().view(torch.uint8)
    if b.numel() % 4:
        b = F.pad(b, (0, 4 - b.numel() % 4))
    elif b.data_ptr() % 4:
        b = b.clone()
    w = b.view(torch.int32)
    return w, n, w.numel()


def _from_u32(w: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The first prod(shape) floats of u32 words (int32 bits) as a tensor of
    ``dtype`` and ``shape``."""
    n = 1
    for d in shape:
        n *= d
    nb = n * FLOAT_WORD_SIZE[_ft_of(dtype)]
    return w.contiguous().view(torch.uint8)[:nb].view(dtype).reshape(shape)


def _rows_from_u32(rows: torch.Tensor, dtype: torch.dtype, n: int) -> torch.Tensor:
    """[R, W32] u32 rows -> [R, n] floats of ``dtype``: each row's first n."""
    nb = n * FLOAT_WORD_SIZE[_ft_of(dtype)]
    return rows.contiguous().view(torch.uint8)[:, :nb].contiguous().view(dtype)


def _encode_payload(x32: torch.Tensor, n: int, ft: FloatType, prob_bits: int,
                    pad_w: int, plain: bool = False):
    """Compress one piece; return (int32[pad_w] payload, int32[2] meta).

    meta = [flag, payload_words]: flag 1 = archive, flag 2 = raw words (the
    archive did not beat raw, so the raw piece rides the wire instead)."""
    raw_w = x32.shape[0]
    dev = x32.device
    comp32, comp_bytes = float_compress_core(
        x32[None, :], torch.tensor([n], dtype=torch.int32, device=dev), ft,
        prob_bits, native=False, plain=plain,
    )
    comp32 = comp32[0]
    comp_w = (comp_bytes[0] + 3) >> 2
    use_comp = comp_w <= raw_w

    if comp32.shape[0] >= pad_w:
        comp_pad = comp32[:pad_w]
    else:
        comp_pad = F.pad(comp32, (0, pad_w - comp32.shape[0]))
    raw_pad = F.pad(x32, (0, pad_w - raw_w))
    payload = torch.where(use_comp, comp_pad, raw_pad)
    meta = torch.stack([
        torch.where(use_comp, _FLAG_COMP, _FLAG_RAW),
        torch.where(use_comp, comp_w, raw_w),
    ]).to(torch.int32)
    return payload, meta


def _decode_payload(payload: torch.Tensor, meta: torch.Tensor, n: int,
                    ft: FloatType, prob_bits: int, w32: int,
                    plain: bool = False):
    """Inverse of ``_encode_payload`` for a batch of received rows:
    payload int32[R, >= w32], meta int32[R, 2] -> (words int32[R, w32], zero
    where the row failed; good bool[R]). Every row goes through one batched
    decode, as in the JAX package; a row of flag 2 or 0 fails it and is
    taken raw or as zeros."""
    flag = meta[:, 0]
    comp = flag == _FLAG_COMP
    raw = flag == _FLAG_RAW
    words, ok, _, _, _ = float_decompress_core(
        payload, torch.zeros(payload.shape[0], dtype=torch.int64,
                             device=payload.device),
        n, ft, prob_bits, native=False, plain=plain,
    )
    words = words[:, :w32]
    decoded = torch.where(raw[:, None], payload[:, :w32], words)
    good = raw | (comp & ok)
    return torch.where(good[:, None], decoded, 0), good


def _all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """t -> [world, *t.shape], every rank's t in rank order."""
    out = t.new_empty((dist.get_world_size(group),) + t.shape)
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def _nchunks(sizes: torch.Tensor, chunk_w: int) -> int:
    return -(-int(sizes.max()) // chunk_w)


def _gather_chunked(payload: torch.Tensor, meta: torch.Tensor, group,
                    chunk_w: int):
    """All-gather ``payload`` moving ceil(max payload / chunk_w) chunks of it.
    meta's first two words are [flag, payload_words]; any further words ride
    along. Returns ((world, pad_w) payloads, (world, len(meta)) metas, the
    wire words moved)."""
    metas = _all_gather_rows(meta, group)
    words = _nchunks(metas[:, 1], chunk_w) * chunk_w
    out = payload.new_zeros((metas.shape[0], payload.shape[0]))
    if words:
        dist.all_gather(list(out[:, :words].unbind(0)),
                        payload[:words].contiguous(), group=group)
    return out, metas, words


def _check_perm(perm, world: int):
    perm = [(int(s), int(d)) for s, d in perm]
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm sends from or to a rank twice: {perm}")
    if not all(0 <= r < world for r in srcs + dsts):
        raise ValueError(f"perm names a rank outside a world of {world}: {perm}")
    return perm


def _permute_chunked(payload: torch.Tensor, meta: torch.Tensor, group, perm,
                     chunk_w: int):
    """Send ``payload`` along ``perm``, moving ceil(max payload / chunk_w)
    chunks; the sizes come from one all-gather, and meta rides with the
    payload so the receiver can decode. Every pair, (r, r) included, goes in
    one ``all_to_all_single`` with per-rank splits. Returns
    (received payload int32[pad_w], received meta int32[2], the wire words
    moved); zeros where no pair sends to this rank."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    perm = _check_perm(perm, world)
    words = _nchunks(_all_gather_rows(meta[1:2], group), chunk_w) * chunk_w
    send = torch.cat([meta, payload[:words]])
    ins = [0] * world
    outs = [0] * world
    for s, d in perm:
        if s == rank:
            ins[d] = send.numel()
        if d == rank:
            outs[s] = send.numel()
    got = send.new_empty(sum(outs))
    dist.all_to_all_single(got, send if sum(ins) else send[:0], outs, ins,
                           group=group)
    recv = got if sum(outs) else torch.zeros_like(send)
    moved = payload.new_zeros(payload.shape)
    moved[:words] = recv[2:]
    return moved, recv[:2], words


def _wire(words: int, dev) -> torch.Tensor:
    return torch.tensor([words], dtype=torch.int32, device=dev)


def compressed_all_gather(
    local: torch.Tensor,
    group=None,
    prob_bits: int = DEFAULT_PROB_BITS,
    chunk_words: Optional[int] = None,
    return_stats: bool = False,
    plain: bool = False,
):
    """All-gather float pieces (each rank's block of rows, all of one shape),
    moving compressed words over the interconnect. Lossless; an
    incompressible piece rides the wire raw.

    Returns (the pieces concatenated in rank order, (world * rows, ...);
    ok bool[world], one flag a piece), and with return_stats the rank's wire
    words, int32[1]. Each piece is converted back on its own, so a 16-bit
    piece of an odd count of floats comes back whole."""
    ft = _ft_of(local.dtype)
    world = dist.get_world_size(group)
    flat32, n, w32 = _to_u32(local)
    chunk_w = _chunk_words(w32, chunk_words)
    pad_w = _pad_words(w32, chunk_w)
    payload, meta = _encode_payload(flat32, n, ft, prob_bits, pad_w, plain)
    rows, metas, wire_w = _gather_chunked(payload, meta, group, chunk_w)
    decoded, good = _decode_payload(rows, metas, n, ft, prob_bits, w32, plain)
    out = _rows_from_u32(decoded, local.dtype, n).reshape(
        (world * local.shape[0],) + tuple(local.shape[1:]))
    if return_stats:
        return out, good, _wire(wire_w, local.device)
    return out, good


def _addend(local: torch.Tensor, world: int):
    """The rank's addend of a reduction: local is its (1, *shape) piece.
    Returns (flat words, float count, word count, floats a chunk, words a
    chunk)."""
    if local.dim() < 1 or local.shape[0] != 1:
        raise ValueError("local must be the rank's (1, *shape) piece")
    flat32, n, w32 = _to_u32(local.reshape(local.shape[1:]))
    if n % world:
        raise ValueError(f"the flattened addend ({n} floats) must split into "
                         f"{world} chunks")
    chunk_n, chunk_32 = n // world, w32 // world
    if 4 * chunk_32 != chunk_n * FLOAT_WORD_SIZE[_ft_of(local.dtype)]:
        raise ValueError("a chunk must be a whole number of u32 words")
    return flat32, n, w32, chunk_n, chunk_32


def compressed_reduce_scatter(
    local: torch.Tensor,
    group=None,
    prob_bits: int = DEFAULT_PROB_BITS,
    chunk_words: Optional[int] = None,
    return_stats: bool = False,
    plain: bool = False,
):
    """Ring sum-reduce-scatter with compressed payloads.

    ``local``: the rank's (1, *shape) addend. The flattened addends split
    into ``world`` equal chunks; rank d gets the element-wise sum over all
    ranks of chunk d. Each of the world hops moves one compressed chunk, so a
    rank's wire words are about min(ratio, 1) of its addend whatever the
    world. The partial sums travel losslessly, so the result is bit for bit
    the ring's add order: rank d starts from its chunk d, adds the chunk
    (d - s - 1) % world it holds to what it receives at step s, and a last
    hop lands chunk d on rank d.

    Returns (out (1, chunk floats), ok bool[1]) and with return_stats the
    rank's wire words, int32[1]."""
    ft = _ft_of(local.dtype)
    world = dist.get_world_size(group)
    d = dist.get_rank(group)
    flat32, _, _, chunk_n, chunk_32 = _addend(local, world)
    chunk_w = _chunk_words(chunk_32, chunk_words)
    pad_w = _pad_words(chunk_32, chunk_w)
    perm = [(i, (i + 1) % world) for i in range(world)]

    def chunk(idx):
        return flat32[idx * chunk_32: (idx + 1) * chunk_32]

    def add_f(a32, b32):
        fa = _from_u32(a32, local.dtype, (chunk_n,))
        fb = _from_u32(b32, local.dtype, (chunk_n,))
        return _to_u32(fa + fb)[0]

    def hop(acc32):
        payload, meta = _encode_payload(acc32, chunk_n, ft, prob_bits, pad_w,
                                        plain)
        moved, mmeta, ww = _permute_chunked(payload, meta, group, perm, chunk_w)
        dec, ok = _decode_payload(moved[None], mmeta[None], chunk_n, ft,
                                  prob_bits, chunk_32, plain)
        return dec[0], ok, ww

    acc = chunk(d % world)
    good = torch.ones(1, dtype=torch.bool, device=local.device)
    wire = 0
    for s in range(world - 1):
        dec, ok, ww = hop(acc)
        acc = add_f(dec, chunk((d - s - 1) % world))
        good, wire = good & ok, wire + ww
    # acc now holds the full sum of chunk (d + 1) % world; one last hop
    # lands chunk d on rank d
    dec, ok, ww = hop(acc)
    good, wire = good & ok, wire + ww
    out = _from_u32(dec, local.dtype, (1, chunk_n))
    if return_stats:
        return out, good, _wire(wire, local.device)
    return out, good


def compressed_all_reduce(
    local: torch.Tensor,
    group=None,
    prob_bits: int = DEFAULT_PROB_BITS,
    chunk_words: Optional[int] = None,
    return_stats: bool = False,
    plain: bool = False,
):
    """Sum-all-reduce = compressed ring reduce-scatter + compressed
    all-gather of the reduced chunks; a rank's wire words are about twice
    its compressed addend, whatever the world.

    ``local``: the rank's (1, *shape) addend. Returns (the sum, (1, *shape),
    the same on every rank; ok bool[1], False if any rank's reduce-scatter
    or any piece of the gather failed) and with return_stats the rank's
    wire words, int32[1]."""
    ft = _ft_of(local.dtype)
    shape = tuple(local.shape[1:])
    red, good_rs, wire_rs = compressed_reduce_scatter(
        local, group, prob_bits, chunk_words, True, plain)
    chunk_n = red.shape[1]
    flat32, _, w32 = _to_u32(red)
    chunk_w = _chunk_words(w32, chunk_words)
    pad_w = _pad_words(w32, chunk_w)
    payload, meta = _encode_payload(flat32, chunk_n, ft, prob_bits, pad_w, plain)
    # each rank's reduce-scatter flag rides the gather's size exchange
    meta = torch.cat([meta, good_rs.to(torch.int32)])
    rows, metas, ww = _gather_chunked(payload, meta, group, chunk_w)
    decoded, ok = _decode_payload(rows, metas[:, :2], chunk_n, ft, prob_bits,
                                  w32, plain)
    good = (ok.all() & metas[:, 2].bool().all()).reshape(1)
    out = _rows_from_u32(decoded, local.dtype, chunk_n).reshape((1,) + shape)
    if return_stats:
        return out, good, wire_rs + ww
    return out, good


def compressed_ppermute(
    local: torch.Tensor,
    perm: Sequence[Tuple[int, int]],
    group=None,
    prob_bits: int = DEFAULT_PROB_BITS,
    chunk_words: Optional[int] = None,
    return_stats: bool = False,
    plain: bool = False,
):
    """Point-to-point exchange of the pieces (halo or pipeline style) along
    ``perm``, pairs (source rank, destination rank), with compressed
    payloads. Every rank of the group calls it with the same perm.

    Returns (the piece received, local's shape and dtype, zeros where no
    pair sends to this rank; ok bool[1], False there) and with return_stats
    the rank's wire words, int32[1]."""
    ft = _ft_of(local.dtype)
    flat32, n, w32 = _to_u32(local)
    chunk_w = _chunk_words(w32, chunk_words)
    pad_w = _pad_words(w32, chunk_w)
    payload, meta = _encode_payload(flat32, n, ft, prob_bits, pad_w, plain)
    moved, mmeta, ww = _permute_chunked(payload, meta, group, perm, chunk_w)
    dec, good = _decode_payload(moved[None], mmeta[None], n, ft, prob_bits,
                                w32, plain)
    out = _from_u32(dec[0], local.dtype, local.shape)
    if return_stats:
        return out, good, _wire(ww, local.device)
    return out, good
