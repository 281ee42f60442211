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
   payload_words] (a permute gathers the payload_words alone, and the
   header rides with the payload). The payload is the archive when it is
   no larger than the raw piece (flag 1), else the raw words (flag 2), so
   incompressible data costs raw plus chunk rounding and transport never
   fails for capacity.
2. TRANSFER: the gathered headers are read on the host once, with the
   rank's own flag (the transport's one device-to-host read), and ONE
   collective moves ``nchunks * chunk_w`` words, nchunks = ceil(max
   payload / chunk_w): each rank sends its archive words or its raw words,
   as its flag says. The JAX package selects between the two, padded, on
   the device, and moves the same words in a loop of chunk_w-word
   collectives, which XLA's static shapes need; the ``wire`` statistic,
   the words a rank moved, is the same number in both.
3. DECODE: every received row goes through one batched decode, as in the
   JAX package; the decode leaves a failed row zero, and a raw row is
   taken as it came. In an all-gather (``compressed_all_gather`` and the
   gather of ``compressed_all_reduce``) the host has read every row's flag
   with the sizes, so the raw rows are copied in by their indices; here
   the port departs from the JAX package, whose two selects over all the
   rows take raw rows and zero failed ones; the outputs and ``ok`` flags
   are the same. A permute's received row (``compressed_ppermute`` and the
   hops of ``compressed_reduce_scatter``), whose flag the host does not
   read, is selected on the device as in the JAX package. A rank that no
   pair of a permutation sends to receives a zero header and zero words:
   it gets zeros and ``ok=False``, as under ``jax.lax.ppermute``.

Spans (``utils/profiling.span``): ``parallel:<function>`` around each
public collective; inside, ``stage:parallel.encode``, ``.sizes`` (the
header exchange and its read, ``sync:parallel.sizes``), ``.transfer``,
``.decode`` and ``.output``.

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
from ..utils.profiling import span, spanned

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
                    plain: bool = False):
    """Compress one piece; return (int32[CW] archive words, zero past its
    size; int32[2] meta on the piece's device).

    meta = [flag, payload_words]: flag 1 = archive, flag 2 = raw words (the
    archive did not beat raw, so the raw piece rides the wire instead).
    Which of the two the rank sends (``_payload``) is chosen once the host
    has read the flag with the gathered sizes."""
    raw_w = x32.shape[0]
    comp32, comp_bytes = float_compress_core(
        x32[None, :], torch.full((1,), n, dtype=torch.int32, device=x32.device),
        ft, prob_bits, native=False, plain=plain,
    )
    comp_w = (comp_bytes[0] + 3) >> 2
    use_comp = comp_w <= raw_w
    meta = torch.stack([
        torch.where(use_comp, _FLAG_COMP, _FLAG_RAW),
        torch.where(use_comp, comp_w, raw_w),
    ]).to(torch.int32)
    return comp32[0], meta


def _payload(comp32: torch.Tensor, x32: torch.Tensor, flag: int,
             words: int) -> torch.Tensor:
    """The ``words`` words a rank sends: its archive words where its flag is
    1, else its raw words, zero past their end."""
    src = comp32 if flag == _FLAG_COMP else x32
    if src.shape[0] >= words:
        return src[:words]
    return F.pad(src, (0, words - src.shape[0]))


def _decode(rows: torch.Tensor, n: int, ft: FloatType, prob_bits: int,
            w32: int, plain: bool):
    """One batched decode of archive rows int32[R, CW] -> (words int32[R,
    w32], zero for a row that fails; ok bool[R])."""
    words, ok, _, _, _ = float_decompress_core(
        rows, torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device),
        n, ft, prob_bits, native=False, plain=plain,
    )
    return words[:, :w32], ok


def _decode_rows(rows: torch.Tensor, flags: Sequence[int], n: int,
                 ft: FloatType, prob_bits: int, w32: int, plain: bool = False):
    """Gathered rows int32[R, >= payload words] under their flags as the
    host read them -> (words int32[R, w32], zero where the row failed; good
    bool[R]). Every row goes through one batched decode, which leaves a
    failed row zero; then each row of flag 2 is taken as it came, whatever
    the decode made of it (such a row holds the w32 raw words)."""
    out, good = _decode(rows, n, ft, prob_bits, w32, plain)
    for i, flag in enumerate(flags):
        if flag == _FLAG_RAW:
            out[i] = rows[i, :w32]
            good[i] = True
    return out, good


def _decode_payload(payload: torch.Tensor, meta: torch.Tensor, n: int,
                    ft: FloatType, prob_bits: int, w32: int,
                    plain: bool = False):
    """A permute's received rows, whose flags the host does not read:
    payload int32[R, wire words], meta int32[R, 2] -> (words int32[R, w32],
    zero where the row failed; good bool[R]). Every row goes through one
    batched decode, as in the JAX package; a row of flag 2 or 0 fails it
    and is taken raw or as zeros. Rows narrower than w32 hold no raw piece,
    which is w32 words."""
    flag = meta[:, 0]
    comp = flag == _FLAG_COMP
    raw = flag == _FLAG_RAW
    words, ok = _decode(payload, n, ft, prob_bits, w32, plain)
    if payload.shape[1] >= w32:
        words = torch.where(raw[:, None], payload[:, :w32], words)
    good = raw | (comp & ok)
    return torch.where(good[:, None], words, 0), good


# torch.distributed's gather into one tensor, under its newer name where
# this torch has it
_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """t -> [world, *t.shape], every rank's t in rank order."""
    out = t.new_empty((dist.get_world_size(group),) + t.shape)
    _gather_flat(out.view(-1), t.contiguous(), group=group)
    return out


def _wire_words(sizes: Sequence[int], chunk_w: int) -> int:
    """The words every rank moves: the largest payload in whole chunks."""
    return -(-max(sizes) // chunk_w) * chunk_w


def _gather_chunked(comp32: torch.Tensor, x32: torch.Tensor, meta: torch.Tensor,
                    group, chunk_w: int):
    """All-gather each rank's payload, moving ceil(max payload / chunk_w)
    chunks of it: its archive words comp32 or its raw words x32, as its
    flag says. meta's first two words are [flag, payload_words]; any
    further words ride along. The gathered metas are read on the host once
    (the transport's one device-to-host read). Returns ((world, wire
    words) payload rows, (world, len(meta)) metas on the host, the wire
    words moved)."""
    with span("stage:parallel.sizes"):
        metas = _all_gather_rows(meta, group)
        with span("sync:parallel.sizes"):
            metas = metas.cpu()
        words = _wire_words(metas[:, 1].tolist(), chunk_w)
    with span("stage:parallel.transfer"):
        flag = int(metas[dist.get_rank(group), 0])
        out = comp32.new_empty((metas.shape[0], words))
        if words:
            _gather_flat(out.view(-1), _payload(comp32, x32, flag, words),
                         group=group)
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


def _permute_chunked(comp32: torch.Tensor, x32: torch.Tensor, meta: torch.Tensor,
                     group, perm, chunk_w: int):
    """Send this rank's payload along ``perm``, moving ceil(max payload /
    chunk_w) chunks: its archive words comp32 or its raw words x32, as its
    flag says. The sizes come from one all-gather, read on the host with
    this rank's flag, and meta rides with the payload so the receiver can
    decode. Every pair, (r, r) included, goes in one ``all_to_all_single``
    with per-rank splits. Returns (received payload int32[1, wire words],
    received meta int32[1, 2], the wire words moved); zeros where no pair
    sends to this rank."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    perm = _check_perm(perm, world)
    with span("stage:parallel.sizes"):
        sizes = _all_gather_rows(meta[1:2], group)
        with span("sync:parallel.sizes"):
            host = torch.cat([sizes.reshape(-1), meta[:1]]).tolist()
        words = _wire_words(host[:-1], chunk_w)
    with span("stage:parallel.transfer"):
        send = torch.cat([meta, _payload(comp32, x32, host[-1], words)])
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
    return recv[None, 2:], recv[None, :2], words


def _wire(words: int, dev) -> torch.Tensor:
    return torch.full((1,), words, dtype=torch.int32, device=dev)


@spanned("parallel:compressed_all_gather")
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
    with span("stage:parallel.encode"):
        flat32, n, w32 = _to_u32(local)
        chunk_w = _chunk_words(w32, chunk_words)
        comp32, meta = _encode_payload(flat32, n, ft, prob_bits, plain)
    rows, metas, wire_w = _gather_chunked(comp32, flat32, meta, group, chunk_w)
    with span("stage:parallel.decode"):
        decoded, good = _decode_rows(rows, metas[:, 0].tolist(), n, ft,
                                     prob_bits, w32, plain)
    with span("stage:parallel.output"):
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


@spanned("parallel:compressed_reduce_scatter")
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
    perm = [(i, (i + 1) % world) for i in range(world)]

    def chunk(idx):
        return flat32[idx * chunk_32: (idx + 1) * chunk_32]

    def add_f(a32, b32):
        fa = _from_u32(a32, local.dtype, (chunk_n,))
        fb = _from_u32(b32, local.dtype, (chunk_n,))
        return _to_u32(fa + fb)[0]

    def hop(acc32):
        with span("stage:parallel.encode"):
            comp32, meta = _encode_payload(acc32, chunk_n, ft, prob_bits, plain)
        moved, mmeta, ww = _permute_chunked(comp32, acc32, meta, group, perm,
                                            chunk_w)
        with span("stage:parallel.decode"):
            dec, ok = _decode_payload(moved, mmeta, chunk_n, ft, prob_bits,
                                      chunk_32, plain)
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
    with span("stage:parallel.output"):
        out = _from_u32(dec, local.dtype, (1, chunk_n))
        if return_stats:
            return out, good, _wire(wire, local.device)
    return out, good


@spanned("parallel:compressed_all_reduce")
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
    with span("stage:parallel.encode"):
        flat32, _, w32 = _to_u32(red)
        chunk_w = _chunk_words(w32, chunk_words)
        comp32, meta = _encode_payload(flat32, chunk_n, ft, prob_bits, plain)
        # each rank's reduce-scatter flag rides the gather's size exchange
        meta = torch.cat([meta, good_rs.to(torch.int32)])
    rows, metas, ww = _gather_chunked(comp32, flat32, meta, group, chunk_w)
    with span("stage:parallel.decode"):
        decoded, ok = _decode_rows(rows, metas[:, 0].tolist(), chunk_n, ft,
                                   prob_bits, w32, plain)
        good = (ok.all() & bool(metas[:, 2].all())).reshape(1)
    with span("stage:parallel.output"):
        out = _rows_from_u32(decoded, local.dtype, chunk_n).reshape((1,) + shape)
        if return_stats:
            return out, good, wire_rs + ww
    return out, good


@spanned("parallel:compressed_ppermute")
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
    with span("stage:parallel.encode"):
        flat32, n, w32 = _to_u32(local)
        chunk_w = _chunk_words(w32, chunk_words)
        comp32, meta = _encode_payload(flat32, n, ft, prob_bits, plain)
    moved, mmeta, ww = _permute_chunked(comp32, flat32, meta, group, perm,
                                        chunk_w)
    with span("stage:parallel.decode"):
        dec, good = _decode_payload(moved, mmeta, n, ft, prob_bits, w32, plain)
    with span("stage:parallel.output"):
        out = _from_u32(dec[0], local.dtype, local.shape)
        if return_stats:
            return out, good, _wire(ww, local.device)
    return out, good
