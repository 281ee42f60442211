"""The reference decoder against archives the program makes on the CPU
(its plain versions), in both layouts, and against broken archives."""

import pytest
import torch

import dietgpu_fork_torch.api.codec as C
from bench_torch import reference as R

CASES = [
    (torch.bfloat16, [5000, 1, 70000], False, False, 10),
    (torch.float16, [9000], False, False, 9),
    (torch.float32, [9000, 4097], False, True, 11),
    (torch.float64, [3000, 17, 40000], True, True, 9),
    (torch.bfloat16, [4000, 2500], True, False, 10),
]


def members(dtype, sizes, sparse, seed=3):
    g = torch.Generator().manual_seed(seed)
    out = []
    for n in sizes:
        x = torch.randn(n, generator=g, dtype=torch.float64).to(dtype)
        if sparse:
            x[torch.rand(n, generator=g) < 0.5] = 0
        out.append(x)
    return out


def check(comp, sizes, ts, pb, checksum, sparse):
    f = R.Faults()
    bad = R.check_batch(comp, sizes, ts, pb, checksum, sparse, f)
    return bad, dict(f.counts)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("dtype,sizes,sparse,checksum,pb", CASES)
def test_reference_decodes_the_programs_archives(dtype, sizes, sparse, checksum, pb, native):
    ts = members(dtype, sizes, sparse)
    comp, cb, _ = C.compress_data(True, ts, checksum, pb, sparse, native=native)
    assert check(comp, cb.tolist(), ts, pb, checksum, sparse) == (0, {})


@pytest.mark.parametrize("dtype,sparse", [(torch.bfloat16, False), (torch.float64, True)])
def test_v2_containers(dtype, sparse):
    n = (1 << 20) + (2 * 4096 if sparse else 0) * 128 + 5
    ts = members(dtype, [n], sparse)
    comp, cb, _ = C.compress_data(True, ts, sparse, 9, sparse, native=True)
    u = comp.view(torch.int32).reshape(-1)
    base = 4 + R._up(R._ceil(n, 8), 16) // 4 if sparse else 0
    nnz = int((R.float_bits(ts[0]) != 0).sum())
    assert (int(u[base]) & R.M32) == (R.FLOAT_V2 if nnz >= R.V2_MIN_FLOATS else R.FLOAT_V1)
    assert check(comp, cb.tolist(), ts, 9, sparse, sparse) == (0, {})


def test_a_flipped_stream_bit_is_caught():
    ts = members(torch.bfloat16, [70000], False)
    comp, cb, _ = C.compress_data(True, ts, False, 10, False, native=True)
    comp[0, int(cb[0]) - 40] ^= 4
    bad, faults = check(comp, cb.tolist(), ts, 10, False, False)
    assert bad > 0 and faults.get("ans_final_state", 0) > 0


@pytest.mark.parametrize("where,what", [
    (lambda cb: 4, "float_count"),
    (lambda cb: 8, "float_type"),
    (lambda cb: cb + 3, "archive_padding"),
])
def test_broken_fields_are_counted(where, what):
    ts = members(torch.float32, [9000], False)
    comp, cb, _ = C.compress_data(True, ts, True, 10, False, native=True)
    comp[0, where(int(cb[0]))] ^= 0x40
    assert what in check(comp, cb.tolist(), ts, 10, True, False)[1]


def test_a_wrong_checksum_and_a_wrong_bitmap_are_counted():
    ts = members(torch.float64, [3000], True)
    comp, cb, _ = C.compress_data(True, ts, True, 9, True, native=True)
    base = 4 + R._up(R._ceil(3000, 8), 16) // 4
    c2 = comp.clone()
    c2[0, 4 * base + 12] ^= 1
    assert "float_checksum" in check(c2, cb.tolist(), ts, 9, True, True)[1]
    c2 = comp.clone()
    c2[0, 16] ^= 0x80
    assert "sparse_bitmap" in check(c2, cb.tolist(), ts, 9, True, True)[1]


def test_an_archive_of_other_floats_reads_as_mismatches():
    ts = members(torch.bfloat16, [5000], False)
    comp, cb, _ = C.compress_data(True, members(torch.bfloat16, [5000], False, seed=4),
                                  False, 10, False, native=True)
    bad, faults = check(comp, cb.tolist(), ts, 10, False, False)
    assert bad > 4000 and faults == {}


def test_xor_bytes():
    t = torch.tensor([0x0102, 0x0304, 0x0010], dtype=torch.int16).view(torch.bfloat16)
    assert R.xor_bytes(t) == 0x01 ^ 0x02 ^ 0x03 ^ 0x04 ^ 0x10
    assert R.xor_bytes(torch.zeros(0, dtype=torch.float64)) == 0
