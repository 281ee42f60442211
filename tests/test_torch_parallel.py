"""The port's parallel layer (``dietgpu_fork_torch.parallel``) against the
JAX package's (``dietgpu_fork_tpu.parallel``), bit for bit.

For worlds of 1, 2 and 4 ranks the same seeded numpy inputs
(``test_torch_parallel_ranks.world_inputs``) go through the JAX functions on
a mesh of the first W virtual CPU devices and through the port on gloo: a
world of one in this process, larger ones in spawned rank processes that
import no JAX. Each rank's results must equal its piece of the JAX outputs:
archives, compressed sizes, decoded words, flags, wire words, and the ring
sums, whose add order is the same on both sides. The JAX references run in
spawned processes too, one per world and part, while this process runs the
world of one and the local helpers. fp64, which JAX cannot hold with x64
off, is held to its input and to a numpy float64 ring.
"""

from __future__ import annotations

import importlib
import inspect
import multiprocessing
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.parallel import collectives as jco
from dietgpu_fork_tpu.parallel import sharded as jsh
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import floats_from_words, rows_from_numpy
from dietgpu_fork_torch.parallel import collectives as co
from tests.test_torch_parallel_ranks import (
    ALL_REDUCE_SHAPE,
    ANS_S,
    FLOAT_N,
    GATHERS,
    PERMS,
    REDUCE_SCATTERS,
    WORLDS,
    finish_world,
    float_words,
    perm_of,
    start_world,
    world_inputs,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

JAX_PARTS = ("sharded", "collectives")
_JDT = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp32": jnp.float32,
        "bf16-chunk128": jnp.bfloat16, "fp32-raw": jnp.float32}
_WORD = {np.uint16: np.int16, np.uint32: np.int32}


# -- the JAX side, in spawned processes -------------------------------------


def _bits(x) -> np.ndarray:
    """A JAX output as numpy, floats as their unsigned words."""
    x = np.asarray(x)
    return x if x.dtype.kind in "biu" else x.view(f"u{x.dtype.itemsize}")


def _jax_rows(x, world):
    """A global (B, ...) output -> each rank's block of rows."""
    x = _bits(x)
    b = x.shape[0] // world
    return [x[r * b: (r + 1) * b] for r in range(world)]


def _jax_sharded(world, inp, mesh):
    ranks = [{} for _ in range(world)]

    def put(name, x, replicated=False):
        for r, v in enumerate([_bits(x)] * world if replicated
                              else _jax_rows(x, world)):
            ranks[r][name] = v

    B = 2 * world
    for name, ft in (("float/bf16", JFT.BFLOAT16), ("float/fp32", JFT.FLOAT32)):
        xs = jsh.shard_batch(mesh, jnp.asarray(inp[name].view(np.uint32)))
        ss = jsh.shard_batch(mesh, jnp.full((B,), FLOAT_N, jnp.int32))
        comp, cb = jsh.float_compress_sharded(mesh, xs, ss, ft)
        words, ok, n, _, _ = jsh.float_decompress_sharded(mesh, comp, FLOAT_N, ft)
        for field, v in (("comp", comp), ("comp_bytes", cb), ("words", words),
                         ("ok", ok), ("n", n)):
            put(f"{name}/{field}", v)
        put(f"{name}/sizes", jsh.global_compressed_sizes(cb, mesh), True)
    ss = jsh.shard_batch(mesh, jnp.full((B,), ANS_S, jnp.int32))
    for name, enc in (("ans", jsh.ans_encode_sharded),
                      ("table", jsh.ans_encode_shared_table)):
        comp, cb = enc(mesh, jsh.shard_batch(mesh, jnp.asarray(inp[name])), ss)
        out, ok, _, _ = jsh.ans_decode_sharded(mesh, comp, ANS_S)
        for field, v in (("comp", comp), ("comp_bytes", cb), ("out", out),
                         ("ok", ok)):
            put(f"{name}/{field}", v)
    return ranks


_GATHER = jax.jit(jco.compressed_all_gather,
                  static_argnames=("mesh", "chunk_words", "return_stats"))


def _jax_collectives(world, inp, mesh):
    ranks = [{} for _ in range(world)]

    def put(name, res, replicated_out):
        out, ok, wire = (_bits(v) for v in res)
        for r in range(world):
            ranks[r][f"{name}/out"] = out if replicated_out else _jax_rows(out, world)[r]
            ranks[r][f"{name}/ok"] = ok if replicated_out else ok[r: r + 1]
            ranks[r][f"{name}/wire"] = wire[r: r + 1]

    def floats(name, wdt, jdt):
        return jnp.asarray(inp[name].view(_WORD[wdt])).view(jdt)

    for name, (wdt, _, cw, _) in GATHERS.items():
        put(f"gather/{name}", _GATHER(floats(f"gather/{name}", wdt, _JDT[name]),
                                      mesh, chunk_words=cw, return_stats=True),
            True)
    for name, (wdt, _, _) in REDUCE_SCATTERS.items():
        put(f"rs/{name}", jax.jit(
            lambda v: jco.compressed_reduce_scatter(v, mesh, return_stats=True))(
                floats(f"rs/{name}", wdt, _JDT[name])), False)
    put("all_reduce", jax.jit(
        lambda v: jco.compressed_all_reduce(v, mesh, return_stats=True))(
            floats("all_reduce", np.uint32, jnp.float32)), False)
    x = floats("ppermute", np.uint16, jnp.bfloat16)
    for kind in PERMS:
        perm = perm_of(kind, world)
        put(f"ppermute/{kind}", jax.jit(
            lambda v: jco.compressed_ppermute(v, mesh, perm, return_stats=True))(x),
            False)
    return ranks


def _jax_main(world: int, part: str, out_dir: str) -> None:
    mesh = jsh.data_mesh(jax.devices()[:world])
    fn = _jax_sharded if part == "sharded" else _jax_collectives
    for r, res in enumerate(fn(world, world_inputs(world), mesh)):
        np.savez(os.path.join(out_dir, f"jax-{part}-rank{r}.npz"), **res)


def _load(path: Path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# -- fixtures: every world and part started at once ------------------------


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Starts the JAX references of every world and the port's worlds of 2
    and 4 before the module's first test; ends any left at its end."""
    root = tmp_path_factory.mktemp("parallel")
    ctx = multiprocessing.get_context("spawn")
    jaxes = []
    for w in WORLDS:
        (root / f"jax{w}").mkdir()
        for part in JAX_PARTS:
            p = ctx.Process(target=_jax_main, args=(w, part, str(root / f"jax{w}")))
            p.start()
            jaxes.append(p)
    ranks = {w: start_world(w, root / f"torch{w}") for w in WORLDS if w > 1}
    handles = {"root": root, "jax": jaxes, "torch": ranks}
    yield handles
    for p in jaxes:
        if p.is_alive():
            p.kill()
        p.join()
    for c in ranks.values():
        for p in c.processes:
            if p.is_alive():
                p.kill()
            p.join()


@pytest.fixture(scope="module")
def worlds(started):
    """{world: (the port's results, the JAX results), a dict a rank each}."""
    root = started["root"]
    port = {1: finish_world(None, 1, root / "torch1")}
    for w, c in started["torch"].items():
        port[w] = finish_world(c, w, root / f"torch{w}")
    for p in started["jax"]:
        p.join(timeout=600)
        assert p.exitcode == 0, f"a JAX reference process exited {p.exitcode}"
    out = {}
    for w in WORLDS:
        ref = [dict() for _ in range(w)]
        for part in JAX_PARTS:
            for r in range(w):
                ref[r].update(_load(root / f"jax{w}" / f"jax-{part}-rank{r}.npz"))
        out[w] = (port[w], ref)
    return out


def _same(a: np.ndarray, b: np.ndarray):
    """Equal bits, as unsigned words of a's width, where the arrays'
    trailing widths differ only by zeros."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iu" and a.dtype.itemsize == b.dtype.itemsize:
        u = np.dtype(f"u{a.dtype.itemsize}")
        a, b = a.view(u), b.view(u)
    elif a.dtype == np.bool_ or b.dtype == np.bool_:
        a, b = a.astype(bool), b.astype(bool)
    else:
        a, b = a.astype(np.int64), b.astype(np.int64)
    if a.ndim < 2:
        assert a.shape == b.shape, (a.shape, b.shape)
    assert a.shape[:-1] == b.shape[:-1], (a.shape, b.shape)
    k = min(a.shape[-1], b.shape[-1])
    np.testing.assert_array_equal(a[..., :k], b[..., :k])
    assert not a[..., k:].any() and not b[..., k:].any()


def _fields(worlds, world, name, fields):
    port, ref = worlds[world]
    for r in range(world):
        for f in fields:
            _same(port[r][f"{name}/{f}"], ref[r][f"{name}/{f}"])
    return port, ref


# -- the local helpers, no world ------------------------------------------


def _public_functions(module):
    return sorted(name for name, f in inspect.getmembers(module, inspect.isfunction)
                  if f.__module__ == module.__name__ and not name.startswith("_"))


# what the port's modules add to the JAX package's: the spans the port
# records inside itself
_PORT_ONLY = {"utils.profiling": ["span", "spanned"]}


@pytest.mark.parametrize("name", ["parallel.collectives", "parallel.sharded",
                                  "utils.profiling"])
def test_every_public_function_of_the_jax_module_is_ported(name):
    jmod = importlib.import_module(f"dietgpu_fork_tpu.{name}")
    tmod = importlib.import_module(f"dietgpu_fork_torch.{name}")
    assert _public_functions(tmod) == sorted(
        _public_functions(jmod) + _PORT_ONLY.get(name, []))


_JAX_DT = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
           torch.float32: jnp.float32}


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 7, 2049])
def test_to_from_u32_equal_jax(dtype, n):
    ws = torch.finfo(dtype).bits // 8
    words = float_words(np.random.default_rng(n), {2: np.uint16, 4: np.uint32}[ws], n)
    x = floats_from_words(words, dtype)
    jx = jnp.asarray(words.view(_WORD[words.dtype.type])).view(_JAX_DT[dtype])
    w, nn, w32 = co._to_u32(x)
    jw, jn, jw32 = jco._to_u32(jx)
    assert (nn, w32) == (jn, jw32)
    assert np.array_equal(w.numpy().view(np.uint32), np.asarray(jw))
    back = co._from_u32(w, dtype, (n,))
    jback = jco._from_u32(jw, _JAX_DT[dtype], (n,))
    assert np.array_equal(back.view(torch.int16 if ws == 2 else torch.int32).numpy(),
                          np.asarray(jback).view(_WORD[words.dtype.type]))


@pytest.mark.parametrize("n", [1, 7, 2049])
def test_to_from_u32_fp64_is_lo_hi_pairs(n):
    words = float_words(np.random.default_rng(n), np.uint64, n)
    x = floats_from_words(words, torch.float64)
    w, nn, w32 = co._to_u32(x)
    assert (nn, w32) == (n, 2 * n)
    pairs = np.stack([words & 0xFFFFFFFF, words >> 32], axis=1).reshape(-1)
    assert np.array_equal(w.numpy().view(np.uint32), pairs.astype(np.uint32))
    assert torch.equal(co._from_u32(w, torch.float64, (n,)).view(torch.int64),
                       x.view(torch.int64))


@pytest.mark.parametrize("payload_words,override",
                         [(0, None), (100, None), (8191, None), (8192, None),
                          (1 << 20, None), (1 << 24, None), (5000, 1),
                          (5000, 129), (5000, 4096)])
def test_chunk_and_pad_words_equal_jax(payload_words, override):
    cw = co._chunk_words(payload_words, override)
    assert cw == jco._chunk_words(payload_words, override)
    # a rank's payload rides in the chunks that the JAX package pads it to
    if payload_words:
        assert co._wire_words([payload_words], cw) == jco._pad_words(payload_words, cw)
    assert (co._FLAG_COMP, co._FLAG_RAW) == (jco._FLAG_COMP, jco._FLAG_RAW)


_ENC = jax.jit(jco._encode_payload, static_argnums=(1, 2, 3, 4))
_DEC = jax.jit(jco._decode_payload, static_argnums=(2, 3, 4, 5))


@pytest.mark.parametrize("case", ["compressed-bf16", "raw-fp32"])
def test_encode_decode_payload_equal_jax(case):
    """The payload and meta of one piece, and its decode, equal JAX's; so
    does the decode of a zero payload with a zero meta (a rank that
    receives nothing)."""
    rng = np.random.default_rng(7)
    if case == "compressed-bf16":
        words = float_words(rng, np.uint16, 3000)
        ft, flag = FloatType.BFLOAT16, co._FLAG_COMP
        x32 = words.view(np.uint32)
    else:
        words = float_words(rng, np.uint32, 3000, "bits")
        ft, flag = FloatType.FLOAT32, co._FLAG_RAW
        x32 = words
    n, w32 = 3000, x32.shape[0]
    cw = co._chunk_words(w32, None)
    pad_w = jco._pad_words(w32, cw)
    comp32, meta = co._encode_payload(rows_from_numpy(x32), n, ft, 10)
    # the words the rank sends, by its flag, padded as the JAX package's
    payload = co._payload(comp32, rows_from_numpy(x32), int(meta[0]), pad_w)
    jp, jm = _ENC(jnp.asarray(x32), n, JFT(int(ft)), 10, pad_w)
    assert int(meta[0]) == flag
    assert np.array_equal(payload.numpy().view(np.uint32), np.asarray(jp))
    assert np.array_equal(meta.numpy(), np.asarray(jm))
    for p, m, jp_, jm_ in ((payload, meta, jp, jm),
                           (torch.zeros_like(payload), torch.zeros_like(meta),
                            jnp.zeros_like(jp), jnp.zeros_like(jm))):
        dec, good = co._decode_payload(p[None], m[None], n, ft, 10, w32)
        jdec, jgood = _DEC(jp_, jm_, n, JFT(int(ft)), 10, w32)
        assert np.array_equal(dec[0].numpy().view(np.uint32), np.asarray(jdec))
        assert bool(good[0]) == bool(jgood)
        # the gather's decode, under the flag the host read, agrees
        rows, rgood = co._decode_rows(p[None], m[None, 0].tolist(), n, ft, 10, w32)
        assert torch.equal(rows, dec) and torch.equal(rgood, good)
    assert bool(good[0]) is False and not bool(dec.any())


# -- the worlds ------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["float/bf16", "float/fp32"])
def test_sharded_float_codec_equals_jax(worlds, world, name):
    port, _ = _fields(worlds, world, name,
                      ("comp", "comp_bytes", "words", "ok", "n", "sizes"))
    inp = world_inputs(world)[name].view(np.uint32)
    for r in range(world):
        assert port[r][f"{name}/ok"].all()
        _same(port[r][f"{name}/words"], inp[2 * r: 2 * r + 2])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["ans", "table"])
def test_sharded_ans_equals_jax(worlds, world, name):
    port, _ = _fields(worlds, world, name, ("comp", "comp_bytes", "out", "ok"))
    inp = world_inputs(world)[name]
    comp = np.concatenate([port[r][f"{name}/comp"] for r in range(world)])
    for r in range(world):
        assert port[r][f"{name}/ok"].all()
        assert np.array_equal(port[r][f"{name}/out"], inp[2 * r: 2 * r + 2])
    if name == "table":  # every archive embeds the one packed pdf table
        assert (comp[:, 32:544] == comp[:1, 32:544]).all()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(GATHERS))
def test_all_gather_equals_jax(worlds, world, name):
    port, _ = _fields(worlds, world, f"gather/{name}", ("out", "ok", "wire"))
    inp = world_inputs(world)[f"gather/{name}"]
    raw_w = inp.shape[1] * inp.itemsize // 4
    for r in range(world):
        assert port[r][f"gather/{name}/ok"].all()
        _same(port[r][f"gather/{name}/out"], inp)
        wire = int(port[r][f"gather/{name}/wire"][0])
        if name == "fp32-raw":  # rides raw: the raw words, chunk-rounded
            assert raw_w <= wire <= raw_w + co._chunk_words(raw_w, None)
        else:  # an archive no larger than raw, chunk-rounded
            assert wire <= raw_w


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(REDUCE_SCATTERS))
def test_reduce_scatter_equals_jax(worlds, world, name):
    port, _ = _fields(worlds, world, f"rs/{name}", ("out", "ok", "wire"))
    for r in range(world):
        assert port[r][f"rs/{name}/ok"].all()
        assert port[r][f"rs/{name}/out"].shape == (
            1, REDUCE_SCATTERS[name][2][0] // world)


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_equals_jax(worlds, world):
    port, _ = _fields(worlds, world, "all_reduce", ("out", "ok", "wire"))
    for r in range(world):
        assert port[r]["all_reduce/ok"].all()
        assert port[r]["all_reduce/out"].shape == (1,) + ALL_REDUCE_SHAPE
        _same(port[r]["all_reduce/out"], port[0]["all_reduce/out"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", PERMS)
def test_ppermute_equals_jax(worlds, world, kind):
    port, _ = _fields(worlds, world, f"ppermute/{kind}", ("out", "ok", "wire"))
    inp = world_inputs(world)["ppermute"]
    src = {d: s for s, d in perm_of(kind, world)}
    for r in range(world):
        out = port[r][f"ppermute/{kind}/out"]
        ok = bool(port[r][f"ppermute/{kind}/ok"][0])
        if r in src:
            assert ok
            _same(out, inp[src[r]: src[r] + 1])
        else:  # no pair sends here: zeros and a failed flag, as in JAX
            assert not ok and not out.any()


@pytest.mark.parametrize("world", WORLDS)
def test_fp64_gather_and_ppermute_return_the_input(worlds, world):
    port, _ = worlds[world]
    inp = world_inputs(world)["fp64/gather"]
    for r in range(world):
        assert port[r]["fp64/gather/ok"].all()
        _same(port[r]["fp64/gather/out"], inp)
        assert port[r]["fp64/ppermute/ok"].all()
        _same(port[r]["fp64/ppermute/out"], inp[(r - 1) % world: (r - 1) % world + 1])
        assert int(port[r]["fp64/gather/wire"][0]) < inp.shape[1] * 2


@pytest.mark.parametrize("world", WORLDS)
def test_fp64_ring_sum_equals_numpy_ring(worlds, world):
    """Rank d's chunk d is X_d + X_(d+1) + ... + X_(d-1), added left to
    right in float64: the ring's order."""
    port, _ = worlds[world]
    xs = world_inputs(world)["fp64/rs"].view(np.float64).reshape(world, world, -1)
    for d in range(world):
        acc = xs[d, d].copy()
        for i in range(1, world):
            acc = acc + xs[(d + i) % world, d]
        assert port[d]["fp64/rs/ok"].all()
        _same(port[d]["fp64/rs/out"], acc.view(np.int64)[None])


@pytest.mark.parametrize("world", WORLDS)
def test_odd_bf16_gather_comes_back_whole(worlds, world):
    port, _ = worlds[world]
    inp = world_inputs(world)["gather/bf16-odd"]
    for r in range(world):
        assert port[r]["gather/bf16-odd/ok"].all()
        _same(port[r]["gather/bf16-odd/out"], inp)
