"""Raw-byte ANS in the port (plain versions on the CPU), both layouts, vs
the JAX package's ans_encode_padded / ans_decode_padded and the NumPy
oracle, byte for byte: the checksum header, a caller-supplied histogram,
the capacity failure, corrupt headers folding into success=False, and the
header read."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.models import ans as JA
from dietgpu_fork_torch.core.interop import bytes_from_numpy, bytes_to_numpy
from dietgpu_fork_torch.models import ans as TA
from tests.conftest import make_exponential_bytes
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SIZES = [0, 1, 4095, 4096, 4097, 5 * 4096 + 3, 9000]

jax_enc = jax.jit(JA.ans_encode_padded,
                  static_argnames=("prob_bits", "use_checksum", "out_bytes",
                                   "native"))
jax_dec = jax.jit(JA.ans_decode_padded,
                  static_argnames=("out_capacity", "prob_bits", "native"))


def _batch(seed, sizes, S=None):
    rng = np.random.default_rng(seed)
    S = S or max(sizes)
    data = [make_exponential_bytes(rng, n, lam=6.0) for n in sizes]
    buf = np.zeros((len(sizes), S), np.uint8)
    for i, d in enumerate(data):
        buf[i, : d.size] = d
    return data, buf, np.array(sizes, np.int32)


def _encode(buf, n, pb=10, cks=False, native=True, hist=None):
    comp, cb = TA.ans_encode_padded(
        bytes_from_numpy(buf), torch.from_numpy(n), pb, cks,
        None if hist is None else torch.from_numpy(hist), native=native)
    return bytes_to_numpy(comp), cb.numpy()


@pytest.mark.parametrize("cks", [False, True])
@pytest.mark.parametrize("pb", [9, 11])
@pytest.mark.parametrize("native", [False, True])
def test_padded_round_trip_equals_jax_and_oracle(native, pb, cks):
    data, buf, n = _batch(pb, SIZES)
    comp, cb = _encode(buf, n, pb, cks, native)
    jcomp, jcb = jax_enc(jnp.asarray(buf), jnp.asarray(n), prob_bits=pb,
                         use_checksum=cks, native=native)
    assert comp.shape == np.asarray(jcomp).shape
    assert np.array_equal(comp, np.asarray(jcomp))
    assert np.array_equal(cb, np.asarray(jcb).astype(np.int64))
    enc = R.ans_encode_native if native else R.ans_encode
    for i, d in enumerate(data):
        want = enc(d, pb, cks)
        assert cb[i] == want.size and np.array_equal(comp[i, : want.size], want)
    S = buf.shape[1]
    out, ok, size, csum = TA.ans_decode_padded(bytes_from_numpy(comp), S, pb,
                                               native=native)
    jout, jok, jsize, jcsum = jax_dec(jnp.asarray(comp), out_capacity=S,
                                      prob_bits=pb, native=native)
    assert out.shape == (len(SIZES), S)
    assert np.array_equal(bytes_to_numpy(out), np.asarray(jout))
    assert ok.all() and np.asarray(jok).all()
    assert size.tolist() == SIZES == np.asarray(jsize).tolist()
    assert csum.tolist() == np.asarray(jcsum).tolist()
    assert csum.tolist() == [R.checksum(d) if cks else 0 for d in data]
    for i, d in enumerate(data):
        assert np.array_equal(bytes_to_numpy(out[i, : d.size]), d)


@pytest.mark.parametrize("native", [False, True])
def test_large_member_equals_oracle(native):
    n = (1 << 20) + 4097
    data, buf, sizes = _batch(5, [n])
    comp, cb = _encode(buf, sizes, 10, True, native)
    enc = R.ans_encode_native if native else R.ans_encode
    want = enc(data[0], 10, True)
    assert cb[0] == want.size and np.array_equal(comp[0, : want.size], want)
    out, ok, size, _ = TA.ans_decode_padded(bytes_from_numpy(comp), n, 10,
                                            native=native)
    assert ok.all() and int(size[0]) == n
    assert np.array_equal(bytes_to_numpy(out[0]), data[0])


@pytest.mark.parametrize("native", [False, True])
def test_caller_histogram_and_totals(native):
    data, buf, n = _batch(3, [5000, 12000, 0])
    hist = np.stack([np.bincount(d, minlength=256) for d in data]).astype(np.int64)
    base, bcb = _encode(buf, n, native=native)
    given, gcb = _encode(buf, n, native=native, hist=hist)
    assert np.array_equal(base, given) and np.array_equal(bcb, gcb)
    # a shared histogram, normalised against its own total, as the JAX
    # package's hist_totals hook does
    shared = hist.sum(axis=0, keepdims=True).repeat(3, axis=0)
    tot = np.full(3, shared[0].sum(), np.int32)
    got, gcb = TA.ans_encode_padded(
        bytes_from_numpy(buf), torch.from_numpy(n), 10,
        hist=torch.from_numpy(shared), hist_totals=torch.from_numpy(tot),
        native=native)
    want, wcb = jax_enc_totals(buf, n, shared, tot, native)
    assert np.array_equal(bytes_to_numpy(got), want)
    assert np.array_equal(gcb.numpy(), wcb)
    out, ok, *_ = TA.ans_decode_padded(got, buf.shape[1], 10, native=native)
    assert ok.all()
    for i, d in enumerate(data):
        assert np.array_equal(bytes_to_numpy(out[i, : d.size]), d)


def jax_enc_totals(buf, n, hist, tot, native):
    comp, cb = JA.ans_encode_padded(
        jnp.asarray(buf), jnp.asarray(n), 10, hist=jnp.asarray(hist.astype(np.uint32)),
        hist_totals=jnp.asarray(tot), native=native)
    return np.asarray(comp), np.asarray(cb).astype(np.int64)


@pytest.mark.parametrize("native", [False, True])
def test_capacity_failure(native):
    data, buf, n = _batch(4, [9000, 300])
    comp, _ = _encode(buf, n, native=native)
    out, ok, size, _ = TA.ans_decode_padded(
        bytes_from_numpy(comp), 9000, 10, torch.tensor([8999, 300]), native)
    assert ok.tolist() == [False, True] and size.tolist() == [9000, 300]
    assert not out[0].any()
    assert np.array_equal(bytes_to_numpy(out[1, :300]), data[1])


def _corrupt(comp, how, native):
    comp = comp.copy()
    w = comp.view(np.uint32)
    nb = int(w[0, 1])
    bw = 8 + 128 + 32 * nb
    if how == "magic":
        w[0, 0] ^= 0x10000
    elif how == "layout":
        w[0, 0] = (0xD00D if native else 0xDB0D) << 16 | 1
    elif how == "prob_bits":
        w[0, 4] = (w[0, 4] & 0xFFFFFFF0) | 9
    elif how == "num_blocks":
        w[0, 1] += 1
    elif how == "block_words_past_total":
        w[0, bw] = (w[0, bw] & 0xFFFF0000) | 0xFFF
    elif how == "block_uncomp":
        w[0, bw] -= 1 << 16
    elif how == "block_start":
        w[0, bw + 1] = 1 << 20
    elif how == "truncated":
        comp = comp[:, : 4 * (bw + 2 * nb) + 64]
    return comp


@pytest.mark.parametrize(
    "how", ["magic", "layout", "prob_bits", "num_blocks",
            "block_words_past_total", "block_uncomp", "block_start",
            "truncated"])
@pytest.mark.parametrize("native", [False, True])
def test_corrupt_headers_fail_without_raising(native, how):
    data, buf, n = _batch(6, [9000, 4097])
    comp, _ = _encode(buf, n, native=native)
    bad = _corrupt(comp, how, native)
    out, ok, _, _ = TA.ans_decode_padded(bytes_from_numpy(bad), 9000, 10,
                                         native=native)
    assert not ok[0] and not out[0].any()
    if how != "truncated":
        assert ok[1]
        assert np.array_equal(bytes_to_numpy(out[1, :4097]), data[1])


def test_get_compressed_info():
    data, buf, n = _batch(8, [100, 0, 4097])
    comp, _ = _encode(buf, n, cks=True, native=False)
    sizes, csums = TA.ans_get_compressed_info(bytes_from_numpy(comp))
    jsizes, jcsums = JA.ans_get_compressed_info(jnp.asarray(comp))
    assert sizes.tolist() == [100, 0, 4097] == np.asarray(jsizes).tolist()
    assert csums.tolist() == np.asarray(jcsums).tolist()
    assert csums.tolist() == [R.checksum(d) for d in data]
