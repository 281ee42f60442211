"""The port's fused fp32 decode (``fused=True``, K12's route, plain on the
CPU) equals the JAX package's Pallas ``JOIN_F32`` decode, run in interpret
mode (``DIETTPU_INTERPRET=1``) with its fused fp32 branch switched on, on
one native archive of the port.

A file of its own: the interpret-mode trace of the fused decode takes
about half a minute, and a separate file lets it run beside the others.
The classic layout is held to the JAX package's portable decode in
``test_torch_fused_decode.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from dietgpu_fork_tpu.core.constants import FloatType as JFT
from dietgpu_fork_tpu.models import float_codec as JF
from dietgpu_fork_tpu.ops.pallas import rans_decode_fused2 as JD
from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models import float_codec as TF
from tests.test_torch_threads import one_torch_thread  # noqa: F401

N = 9000


def test_fused_fp32_equals_jax_pallas_join_f32(monkeypatch):
    monkeypatch.setenv("DIETTPU_INTERPRET", "1")
    monkeypatch.setattr(JF, "_FUSED_F32", True)
    traced = []
    pallas_fused = JD.decode_join32_fused

    def spy(*args, **kwargs):
        traced.append(kwargs.get("row_stream"))
        return pallas_fused(*args, **kwargs)

    monkeypatch.setattr(JD, "decode_join32_fused", spy)
    w = chip_smoke.float_words(6, N, FloatType.FLOAT32)
    d32 = chip_smoke.pack_rows([w], N)
    out, _ = TF.float_compress_core(
        rows_from_numpy(d32), torch.tensor([N], dtype=torch.int32),
        FloatType.FLOAT32, 10)
    got, ok, n, _, _ = TF.float_decompress_core(
        out, torch.zeros(1, dtype=torch.int64), N, FloatType.FLOAT32, 10,
        fused=True)
    assert bool(ok[0]) and int(n[0]) == N
    # a fresh function, so no trace of the portable path is reused
    dec = jax.jit(lambda c, b: JF.float_decompress_core(
        c, b, N, JFT.FLOAT32, 10, native=True))
    jw, js, jn, *_ = dec(jnp.asarray(rows_to_numpy(out)), jnp.zeros(1, jnp.int32))
    assert traced == [True]  # the Pallas JOIN_F32 kernel, row layout
    assert bool(np.asarray(js)[0]) and int(np.asarray(jn)[0]) == N
    jw = np.asarray(jw)
    assert jw.shape == (1, N) and got.shape == (1, N)
    assert np.array_equal(rows_to_numpy(got), jw)
    assert np.array_equal(jw[0], w)
