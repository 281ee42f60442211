import pytest
import torch

from bench_torch import rooflines

i32, i64 = torch.int32, torch.int64


def z(*shape, dtype=i32):
    return torch.zeros(shape, dtype=dtype)


def test_merge_counts_the_copied_run_words_and_the_whole_output():
    srcs = [z(100), z(50)]
    lens = torch.tensor([10, 0, 7])
    args = (srcs, z(3, dtype=i64), z(3), z(3, dtype=i64), lens, 40)
    out = z(40)
    want = 4 * 17 + 3 * 8 + 3 * 4 + 3 * 8 + 3 * 8 + 4 * 40
    assert rooflines.kernel_bytes("runs_merge", args, out) == want


@pytest.mark.parametrize("w,streams", [("encode_rows", 64), ("encode_blocks", 96)])
def test_encode_counts_the_bytes_below_each_size_and_the_streams_up_to_their_words(w, streams):
    # rows: one stream for each 4 blocks, (1 + 2 + 3 + 4) and 9 u16 words;
    # classic: one a block; each in 16 B stores, the zeros past them left out
    sizes = torch.tensor([5 * 4096 - 7], dtype=i32)
    args = (z(1, 5 * 1024), sizes, z(1, 256), z(1, 256), 10)
    num_words = torch.tensor([[1, 2, 3, 4, 9]], dtype=i32)
    cap = 5120 if w == "encode_rows" else 1280
    out = (z(1, 5, 32), z(1, 2 if w == "encode_rows" else 5, cap), num_words)
    want = 5 * 4096 - 7 + 4 + 2 * 1024 + 4 * (5 * 32 + 5) + streams
    assert rooflines.kernel_bytes(w, args, out) == want


def test_a_stream_counts_no_more_than_its_capacity():
    args = (z(1, 1024), torch.tensor([4096], dtype=i32), z(1, 256), z(1, 256), 10)
    out = (z(1, 1, 32), z(1, 1, 1280), torch.tensor([[100000]], dtype=i32))
    assert rooflines.kernel_bytes("encode_blocks", args, out) == 4096 + 4 + 2048 + 128 + 4 + 5120


def test_bitmap_pack_counts_the_floats_below_n_and_their_bitmap_words():
    n = torch.tensor([3, 1], dtype=i32)
    out = z(2, 4)
    assert rooflines.kernel_bytes("pack_bitmap", (z(2, 8), n, 4), out) == 8 * 4 + 8 + 8
    assert rooflines.kernel_bytes("pack_bitmap", (z(2, 8), n, 2), out) == 2 * 4 + 8 + 8


def test_rank_scan_counts_the_live_bitmap_words():
    n = torch.tensor([40, 0], dtype=i64)
    out = z(2, 4)
    assert rooflines.kernel_bytes("word_ranks", (z(2, 3), n), out) == 4 * 2 + 16 + 4 * (2 + 2)


def test_compaction_and_expansion_count_the_nonzero_floats():
    ranks = torch.tensor([[0, 3, 5], [0, 1, 2]], dtype=i32)
    args = (z(2, 8), z(2, 2), ranks, 4)
    out = (z(2, 8), ranks[:, -1])
    assert rooflines.kernel_bytes("compact_by_bitmap", args, out) == 8 * 7 + 16 + 24 + 8 * 7
    n = torch.tensor([4, 9], dtype=i32)
    args = (z(2, 8), z(2, 2), ranks, n, 4, 4)
    want = 8 * 7 + 16 + 24 + 8 + 8 * (4 + 4)
    assert rooflines.kernel_bytes("expand_by_bitmap", args, z(2, 8)) == want


@pytest.mark.parametrize("w,raw_off,sec2_off,raw,width", [
    ("decode_rows", None, None, 0, 1),
    ("decode_join16", z(2, dtype=i64), None, 1, 2),
    ("decode_join32", z(2, dtype=i64), z(2, dtype=i64), 3, 4),
])
def test_decode_counts_streams_live_states_raw_bytes_and_the_symbols_out(
        w, raw_off, sec2_off, raw, width):
    seg_len = torch.tensor([[5, 0], [3, -1]], dtype=i64)
    uncomp = torch.tensor([[4096, 10, 0], [0, 0, 0]], dtype=i32)
    args = (z(1000), z(2, 2, dtype=i64), seg_len, z(2, 3), uncomp, z(2, dtype=i64),
            z(2, 1024), 10, raw_off, sec2_off, True)
    out = z(2, 3, 1024 * width)
    need = 4 * 8 + 4 * 32 * 2 + raw * 4106
    rest = 32 + 32 + 24 + 24 + 16 + 8192 + sum(
        t.numel() * 8 for t in (raw_off, sec2_off) if t is not None)
    assert rooflines.kernel_bytes(w, args, out) == need + rest + width * 4106


def test_joins_count_the_floats_below_each_count():
    count = torch.tensor([10, 3], dtype=i64)
    plane = z(2, 4)
    args = (z(500), [plane], z(2, dtype=i64), z(2, dtype=i64), count, 3)
    assert rooflines.kernel_bytes("join_wide_at", args, z(2, 16)) == 4 * 13 + 32 + 16 + 4 * 13
    args = (z(500), plane, z(2, dtype=i64), count, 2)
    assert rooflines.kernel_bytes("join16_at", args, z(2, 8)) == 2 * 13 + 16 + 16 + 2 * 13


def test_splits_count_the_floats_below_each_count_in_and_out():
    args = (z(2, 64), torch.tensor([1, 2], dtype=i32), True)
    out = (z(2, 32), z(2, 32), z(2, 256), z(2))
    assert rooflines.kernel_bytes("split16_hist", args, out) == 2 * 3 + 8 + 2 * 3 + 2048 + 8
    # fp64: 32 floats a row of 64 words, the count past it clamped
    args = (z(2, 64), torch.tensor([1, 40], dtype=i32), 4)
    out = (z(4, 8), z(2, 32), z(2, 16), z(4, 256), z(2))
    assert rooflines.kernel_bytes("split_wide_hist", args, out) == 8 * 33 + 8 + 8 * 33 + 4096 + 8


def test_a_kernel_without_a_rule_counts_every_tensor_whole():
    args = (z(2, 8), z(2, 3, dtype=i64))
    assert rooflines.kernel_bytes("chunked_lookup", args, z(2, 3)) == 64 + 48 + 24


def test_a_count_in_its_own_file_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "kernel_bytes").mkdir()
    (tmp_path / "kernel_bytes" / "new_kernel.py").write_text(
        "def nbytes(args, out):\n    return 7 * args[0]\n")
    monkeypatch.setattr(rooflines, "_HERE", tmp_path)
    assert rooflines.kernel_bytes("new_kernel", (3,), None) == 21


def test_bound_is_bytes_at_the_published_rate():
    assert rooflines.bound_s(3.35e12) == pytest.approx(1.0)
