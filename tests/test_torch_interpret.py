"""The port's archive equals the archive of the JAX package's Pallas
kernels, run in interpret mode (``DIETTPU_INTERPRET=1``) on the CPU.

A file of its own: the interpret-mode trace is the costliest case of the
port's tests, and a separate file lets it run beside the others."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import float_codec as JF
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import float_codec as TF
from tests.conftest import make_float_words
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def test_archive_equals_jax_pallas_path(rng, monkeypatch):
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    n = 9000
    w = make_float_words(rng, JFT.BFLOAT16, n)
    d32 = chip_smoke.pack_rows([w], n)
    out, cb = TF.float_compress_core(
        rows_from_numpy(d32), torch.tensor([n], dtype=torch.int32),
        FloatType.BFLOAT16, 10,
    )
    out, cb = rows_to_numpy(out), int(cb[0])
    # a fresh function, so no trace of the portable path is reused
    enc = jax.jit(lambda d, m: JF.float_compress_core(
        d, m, JFT.BFLOAT16, 10, native=True))
    jout, jcb = enc(jnp.asarray(d32), jnp.asarray([n], jnp.int32))
    assert int(np.asarray(jcb)[0]) == cb
    assert np.array_equal(np.asarray(jout)[0].view(np.uint8)[:cb],
                          out[0].view(np.uint8)[:cb])
