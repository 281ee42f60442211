"""The port's fp32 and fp64 archives against the JAX package's Pallas
kernels, run in interpret mode (``DIETTPU_INTERPRET=1``) on the CPU: the
archives are equal byte for byte, and the Pallas decode path (the JOIN_NONE
row decode, then the 32/64-bit join kernels) round-trips the port's
archive.

A file of its own beside ``test_torch_interpret.py``: each interpret-mode
trace takes seconds, and a separate file lets the two run side by side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import float_codec as JF
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import float_codec as TF
from tests.test_torch_threads import one_torch_thread  # noqa: F401

N = 9000
WIDE = [FloatType.FLOAT32, FloatType.FLOAT64]


def _port_archive(ft):
    w = chip_smoke.float_words(5, N, ft)
    d32 = chip_smoke.pack_rows([w], N)
    out, cb = TF.float_compress_core(
        rows_from_numpy(d32), torch.tensor([N], dtype=torch.int32), ft, 10)
    return w, d32, rows_to_numpy(out), int(cb[0])


@pytest.mark.parametrize("ft", WIDE)
def test_archive_equals_jax_pallas_path(ft, monkeypatch):
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    _, d32, out, cb = _port_archive(ft)
    jft = JFT(int(ft))
    # a fresh function, so no trace of the portable path is reused
    enc = jax.jit(lambda d, m: JF.float_compress_core(d, m, jft, 10, native=True))
    jout, jcb = enc(jnp.asarray(d32), jnp.asarray([N], jnp.int32))
    assert int(np.asarray(jcb)[0]) == cb
    assert np.array_equal(np.asarray(jout)[0].view(np.uint8)[:cb],
                          out[0].view(np.uint8)[:cb])


@pytest.mark.parametrize("ft", WIDE)
def test_jax_pallas_path_decodes_port_archive(ft, monkeypatch):
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    w, _, out, _ = _port_archive(ft)
    jft = JFT(int(ft))
    dec = jax.jit(lambda c, b: JF.float_decompress_core(
        c, b, N, jft, 10, native=True))
    jw, js, jn, *_ = dec(jnp.asarray(out), jnp.zeros(1, jnp.int32))
    assert bool(np.asarray(js)[0]) and int(np.asarray(jn)[0]) == N
    got = np.asarray(jw).view(np.uint8)[0]
    assert np.array_equal(got[: w.nbytes], w.view(np.uint8))
    assert not got[w.nbytes:].any()
