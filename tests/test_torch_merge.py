"""K3's plain version (the runs merge) vs the JAX package's _runs_merge_ref,
with ragged, zero-length and multi-source runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dietgpu_fork_tpu.ops.pallas.merge import _RSH, _runs_merge_ref
from dietgpu_fork_torch.ops import merge as TM
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _srcs(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 32, s, dtype=np.uint64).astype(np.uint32)
            for s in sizes]


def _jax_merge(srcs, dst, ref, off, lens, out_len):
    enc = (np.asarray(ref, np.int64) << _RSH) | np.asarray(off, np.int64)
    out = _runs_merge_ref(
        tuple(jnp.asarray(s) for s in srcs), jnp.asarray(dst, jnp.int32),
        jnp.asarray(enc.astype(np.int32)), jnp.asarray(lens, jnp.int32),
        out_len=out_len,
    )
    return np.asarray(out)


def _port_merge(srcs, dst, ref, off, lens, out_len, fn=TM.runs_merge_plain):
    out = fn(
        [torch.from_numpy(s.view(np.int32)) for s in srcs],
        torch.tensor(dst, dtype=torch.int64), torch.tensor(ref, dtype=torch.int32),
        torch.tensor(off, dtype=torch.int64), torch.tensor(lens, dtype=torch.int64),
        out_len,
    )
    assert out.dtype == torch.int32 and out.shape == (out_len,)
    return out.numpy().view(np.uint32)


CASES = {
    # one source, ragged runs with gaps
    "single": ([300], [0, 10, 50, 200], [0, 0, 0, 0], [5, 100, 0, 280],
               [4, 30, 100, 20], 256),
    # zero-length runs at a run's end and at the next run's start
    "zero_len": ([64, 64], [0, 8, 8, 8, 40], [0, 1, 0, 1, 0], [0, 0, 3, 10, 9],
                 [8, 0, 0, 20, 24], 70),
    # three sources, runs touching end to end
    "multi_ref": ([40, 1000, 9], [0, 16, 516, 520, 600],
                  [2, 1, 0, 2, 1], [0, 10, 5, 1, 0], [9, 500, 4, 8, 100], 704),
    # a read past the source's end takes its last word (the JAX reference
    # flattens several sources end to end, so it agrees for one source)
    "clipped": ([10], [0, 12], [0, 0], [7, 2], [6, 11], 30),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_runs_merge_equals_jax(case):
    sizes, dst, ref, off, lens, out_len = CASES[case]
    srcs = _srcs(len(case), sizes)
    got = _port_merge(srcs, dst, ref, off, lens, out_len)
    want = _jax_merge(srcs, dst, ref, off, lens, out_len)
    assert np.array_equal(got, want)
    assert np.array_equal(
        _port_merge(srcs, dst, ref, off, lens, out_len, TM.runs_merge), got
    )


def test_runs_merge_random_ragged_equals_jax():
    rng = np.random.default_rng(7)
    srcs = _srcs(8, [5000, 300, 1])
    R = 200
    lens = rng.integers(0, 40, R)
    lens[rng.random(R) < 0.2] = 0
    gaps = rng.integers(0, 5, R)
    ref = rng.integers(0, 3, R)
    caps = np.array([s.size for s in srcs])
    lens = np.minimum(lens, caps[ref])
    dst = np.cumsum(gaps + np.concatenate([[0], lens[:-1]]))
    off = rng.integers(0, caps[ref] - lens + 1)
    out_len = int(dst[-1] + lens[-1] + 7)
    got = _port_merge(srcs, dst, ref, off, lens, out_len)
    want = _jax_merge(srcs, dst, ref, off, lens, out_len)
    assert np.array_equal(got, want)


def test_runs_merge_no_runs_gives_zeros():
    srcs = _srcs(9, [4])
    got = _port_merge(srcs, [], [], [], [], 12)
    assert not got.any()


def test_runs_merge_rejects_bad_arguments():
    s = [torch.zeros(4, dtype=torch.int32)]
    dst = torch.zeros(1, dtype=torch.int64)
    ok = dict(ref=torch.zeros(1, dtype=torch.int32), off=dst, lens=dst)
    with pytest.raises(TypeError):
        TM.runs_merge(s, dst.to(torch.int32), ok["ref"], dst, dst, 4)
    with pytest.raises(TypeError):
        TM.runs_merge([s[0].to(torch.int64)], dst, ok["ref"], dst, dst, 4)
    with pytest.raises(ValueError):
        TM.runs_merge([], dst, ok["ref"], dst, dst, 4)
    with pytest.raises(ValueError):
        TM.runs_merge(s, dst, ok["ref"], dst, dst, -1)


# K3 works in tiles of 8192 output words and holds 256 run descriptors at a
# time; the plain version, its contract, is unchanged. These cases sit on
# those edges.
TILE = 8192


def test_runs_merge_runs_at_tile_boundaries_equal_jax():
    """Runs ending and starting on tile boundaries, zero-length runs there,
    a gap across one and a run straddling one."""
    srcs = _srcs(11, [40000])
    dst = [0, TILE, TILE, TILE, 2 * TILE - 3, 3 * TILE + 5, 4 * TILE]
    lens = [TILE, 0, 0, 100, 6, 10, 0]
    off = [0, 5, 9, 17, 2, 30000, 1]
    out_len = 4 * TILE + 40
    got = _port_merge(srcs, dst, [0] * 7, off, lens, out_len)
    assert np.array_equal(got, _jax_merge(srcs, dst, [0] * 7, off, lens, out_len))


def test_runs_merge_run_spanning_many_tiles_equals_jax():
    srcs = _srcs(12, [7 * TILE + 100, 50])
    dst, ref, off, lens = [3, 7 * TILE + 10], [0, 1], [1, 0], [7 * TILE + 2, 40]
    out_len = 8 * TILE
    got = _port_merge(srcs, dst, ref, off, lens, out_len)
    assert np.array_equal(got, _jax_merge(srcs, dst, ref, off, lens, out_len))
    assert not got[7 * TILE + 5: 7 * TILE + 10].any() and not got[:3].any()


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_runs_merge_offsets_not_congruent_equal_jax(shift):
    """Source and destination offsets that differ mod 4 words: the kernel's
    4 B path; over more runs than one batch of descriptors."""
    rng = np.random.default_rng(shift)
    srcs = _srcs(13, [30000, 20000])
    R = 700
    lens = rng.integers(1, 40, R)
    dst = np.cumsum(rng.integers(0, 3, R) + np.concatenate([[0], lens[:-1]]))
    ref = rng.integers(0, 2, R)
    off = (dst + shift) % 4 + 4 * rng.integers(0, 4000, R)
    out_len = int(dst[-1] + lens[-1] + 9)
    got = _port_merge(srcs, dst, ref, off, lens, out_len)
    assert np.array_equal(got, _jax_merge(srcs, dst, ref, off, lens, out_len))


def test_runs_merge_takes_at_most_eight_sources():
    s = [torch.zeros(4, dtype=torch.int32)] * 9
    one = torch.zeros(1, dtype=torch.int64)
    ref = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 8"):
        TM.runs_merge(s, one, ref, one, one, 4)
    assert TM.runs_merge(s[:8], one, ref, one, one + 2, 4).shape == (4,)
