"""The PyTorch port stands alone: importing it pulls in neither jax nor the
JAX package, its sources never name them, and its own copy of the format
constants equals the JAX package's."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dietgpu_fork_tpu.core.constants as J
import dietgpu_fork_torch.core.constants as T
from dietgpu_fork_torch.core.interop import (
    bytes_from_numpy,
    bytes_to_numpy,
    floats_from_words,
    rows_from_numpy,
    rows_to_numpy,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "dietgpu_fork_torch").rglob("*")
    if p.suffix in (".py", ".cu", ".cuh")
) + ["chip_smoke.py"]


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import dietgpu_fork_torch\n"
        "import dietgpu_fork_torch.models.float_codec\n"
        "import dietgpu_fork_torch.models.sparse\n"
        "import dietgpu_fork_torch.ops.bitmap_pack\n"
        "import dietgpu_fork_torch.ops.sparse_stream\n"
        "import dietgpu_fork_torch.ops.lookup\n"
        "import dietgpu_fork_torch.runtime.cuda_kernels\n"
        "import dietgpu_fork_torch.core.interop\n"
        "import dietgpu_fork_torch.api.codec\n"
        "import dietgpu_fork_torch.runtime.stack_memory\n"
        "import dietgpu_fork_torch.parallel.collectives\n"
        "import dietgpu_fork_torch.parallel.sharded\n"
        "import dietgpu_fork_torch.utils.profiling\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'dietgpu_fork_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_source_names_no_jax(path):
    text = (ROOT / path).read_text()
    for word in ("import jax", "from jax", "dietgpu_fork_tpu"):
        assert word not in text, f"{path} mentions {word!r}"


@pytest.mark.parametrize(
    "name",
    [
        "NUM_SYMBOLS", "BLOCK_SIZE", "WARP_SIZE", "STEPS_PER_BLOCK",
        "ANS_STATE_BITS", "ANS_ENCODED_BITS", "ANS_ENCODED_MASK",
        "ANS_START_STATE", "ANS_MIN_STATE", "ANS_MAGIC", "ANS_VERSION",
        "ANS_MAGIC_NATIVE", "FLOAT_MAGIC", "FLOAT_VERSION",
        "FLOAT_VERSION_ALIGNED", "FLOAT_ALIGN_MIN",
        "FLOAT_SECTION_ALIGN_BYTES", "BLOCK_ALIGNMENT", "VALID_PROB_BITS",
        "DEFAULT_PROB_BITS", "ANS_HEADER_BYTES", "FLOAT_HEADER_BYTES",
        "FLOAT_HEADER2_BYTES", "SPARSE_HEADER_BYTES",
    ],
)
def test_constant_equals_jax(name):
    assert getattr(T, name) == getattr(J, name)


def test_float_types_equal_jax():
    assert {m.name: int(m) for m in T.FloatType} == {
        m.name: int(m) for m in J.FloatType
    }
    assert {int(k): v for k, v in T.FLOAT_WORD_SIZE.items()} == {
        int(k): v for k, v in J.FLOAT_WORD_SIZE.items()
    }
    assert {int(k): v for k, v in T.FLOAT_NUM_COMP_SEGMENTS.items()} == {
        int(k): v for k, v in J.FLOAT_NUM_COMP_SEGMENTS.items()
    }


def test_stream_bounds_equal_jax():
    from dietgpu_fork_tpu.ops.rans_encode import (
        MAX_BLOCK_WORDS32,
        MAX_ROW_WORDS32,
    )

    assert T.MAX_BLOCK_WORDS32 == MAX_BLOCK_WORDS32
    assert T.MAX_ROW_WORDS32 == MAX_ROW_WORDS32


@pytest.mark.parametrize("size", [0, 1, 4095, 4096, 4097, 20483, 1 << 20, 1 << 24])
def test_size_functions_equal_jax(size):
    assert T.num_blocks(size) == J.num_blocks(size)
    assert T.max_compressed_size(size) == J.max_compressed_size(size)
    assert T.raw_comp_block_max_size(size or 1) == J.raw_comp_block_max_size(size or 1)
    assert T.sparse_bitmap_bytes(size) == J.sparse_bitmap_bytes(size)
    for ft in (1, 2, 3, 4):
        assert T.max_float_compressed_size(T.FloatType(ft), size) == (
            J.max_float_compressed_size(J.FloatType(ft), size)
        )
        assert T.max_sparse_float_compressed_size(T.FloatType(ft), size) == (
            J.max_sparse_float_compressed_size(J.FloatType(ft), size)
        )


@pytest.mark.parametrize(
    "wrapper",
    ["split16_hist", "encode_rows", "runs_merge", "decode_join16",
     "split_wide_hist", "decode_rows", "join_wide", "byte_hist",
     "encode_blocks", "decode_blocks", "decode_join16_blocks", "pack_bitmap",
     "compact_by_bitmap", "expand_by_bitmap", "decode_join32",
     "decode_join32_blocks", "join16_rows", "split16", "split_wide",
     "chunked_lookup", "rowwise_lookup", "word_ranks", "ans_parse",
     "ans_table"],
)
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper never runs, builds or falls back on a CPU tensor."""
    from dietgpu_fork_torch.runtime import cuda_kernels as K

    t = torch.zeros((1, 1024), dtype=torch.int32)
    i64 = t[0, :1].long()
    # the in-place decode's (words, seg_off, seg_len, comp_w, uncomp_w,
    # state_off, lut)
    at = (t[0], t[:, :1].long(), t[:, :1].long(), t, t, i64, t)
    args = {
        "split16_hist": (t, t[0, :1], True),
        "encode_rows": (t, t[0, :1], t[:, :256], t[:, :256], 10),
        "runs_merge": ([t[0]], t[0, :1].long(), t[0, :1], t[0, :1].long(),
                       t[0, :1].long(), 4),
        "decode_join16": at + (10, i64, None, True),
        "split_wide_hist": (t, t[0, :1], T.FloatType.FLOAT32),
        "decode_rows": at + (10, None, None, False),
        "join_wide": ([t], t, t, T.FloatType.FLOAT32),
        "byte_hist": (t.view(torch.uint8), t[0, :1]),
        "encode_blocks": (t, t[0, :1], t[:, :256], t[:, :256], 10),
        "decode_blocks": at + (10, None, None, False),
        "decode_join16_blocks": at + (10, i64, None, True),
        "pack_bitmap": (t, t[0, :1], T.FloatType.FLOAT32),
        "compact_by_bitmap": (t, t[:, :32], t[:, :33], T.FloatType.FLOAT32),
        "expand_by_bitmap": (t, t[:, :32], t[:, :33], t[0, :1], 1024,
                             T.FloatType.FLOAT32),
        "decode_join32": at + (10, i64, i64, False),
        "decode_join32_blocks": at + (10, i64, i64, False),
        "join16_rows": (t, t, True),
        "split16": (t, True),
        "split_wide": (t, T.FloatType.FLOAT64),
        "chunked_lookup": (t, t),
        "rowwise_lookup": (t, t[:, :128]),
        "word_ranks": (t[:, :32], i64),
        "ans_parse": (t, i64, 4096, None, 10, True, None),
        "ans_table": (t[:, :256], i64, 10),
    }[wrapper]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        getattr(K, wrapper)(*args)
    assert K._lib is None


def test_the_api_reads_no_archive_format():
    """``api/codec.py`` leaves every archive read to the models: it imports
    no private name of ``models/`` and holds no ANS magic."""
    src = (ROOT / "dietgpu_fork_torch" / "api" / "codec.py").read_text()
    tree = ast.parse(src)
    imported = [a.name for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)
                and "models" in (node.module or "").split(".")
                for a in node.names]
    assert imported and not [n for n in imported if n.startswith("_")]
    magics = {T.ANS_MAGIC, T.ANS_MAGIC_NATIVE}
    assert not [n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and n.value in magics]
    assert not re.search(r"0x(DB0D|D00D)", src, re.IGNORECASE)


def test_every_kernel_launch_goes_through_one_helper():
    """The device guard, the stream, the error check and the launch count
    are written once, in ``cuda_kernels._launch``: no wrapper can drop one."""
    src = (ROOT / "dietgpu_fork_torch" / "runtime" / "cuda_kernels.py").read_text()
    assert len(re.findall(r"torch\.cuda\.device\(", src)) == 1
    assert len(re.findall(r"(?<!def )\b_stream\(", src)) == 1
    assert len(re.findall(r"launches\[\w+\] \+= 1", src)) == 1
    # the library's other entries are no launches
    assert set(re.findall(r"\.(dgt_\w+)\(", src)) == {
        "dgt_error_string", "dgt_rans_encode_ctas_per_sm"}


def test_every_source_is_built_and_counted():
    """Each kernel source is in the build (K8, the sparse K9-K11, the
    lookups K14, the rank scan K15, the parse K16 and the table build K17
    among them), and each layout of K2,
    K4, K6 and K12, and each split or join mode, has its own launch
    counter."""
    from dietgpu_fork_torch.runtime import cuda_kernels as K

    on_disk = sorted(p.name for p in K.CSRC.glob("*.cu"))
    assert sorted(K.SOURCES) == on_disk
    assert {"byte_hist.cu", "bitmap_pack.cu", "sparse_compact.cu",
            "sparse_expand.cu", "lookup.cu", "word_ranks.cu",
            "ans_parse.cu", "ans_table.cu"} <= set(K.SOURCES)
    assert {"byte_hist", "rans_encode_blocks", "rans_decode_blocks",
            "rans_decode_join16_blocks", "bitmap_pack", "sparse_compact",
            "sparse_expand", "rans_decode_join32", "rans_decode_join32_blocks",
            "join16", "split16", "split_wide", "chunked_lookup",
            "rowwise_lookup", "word_ranks", "ans_parse",
            "ans_table"} <= set(K.launches)
    K.launches["byte_hist"] = 3
    K.reset_launches()
    assert not any(K.launches.values())


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A change to a header the sources include (``csrc/*.cuh``) names a
    new library, so the kernels are built anew."""
    from dietgpu_fork_torch.runtime import cuda_kernels as K

    for p in K.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(K, "CSRC", tmp_path)
    before = K._library_path()
    assert list(tmp_path.glob("*.cuh"))
    header = sorted(tmp_path.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n")
    assert K._library_path() != before


def test_interop_is_bit_exact():
    a = np.array([[0, 1, 0x7FFFFFFF, 0x80000000], [0xFFFFFFFF, 5, 6, 0xDEADBEEF]],
                 dtype=np.uint32)
    t = rows_from_numpy(a)
    assert t.dtype == torch.int32 and t.shape == a.shape
    assert int(t[0, 3]) == -(1 << 31) and int(t[1, 0]) == -1
    back = rows_to_numpy(t)
    assert back.dtype == np.uint32 and np.array_equal(back, a)
    with pytest.raises(TypeError):
        rows_from_numpy(a.astype(np.int64))
    with pytest.raises(TypeError):
        rows_to_numpy(t.to(torch.int64))


@pytest.mark.parametrize(
    "words,dtype",
    [(np.array([0x3F80, 0xBF80, 0x7FC1], np.uint16), torch.bfloat16),
     (np.array([0x3C00, 0xFC00], np.uint16), torch.float16),
     (np.array([0x3F800000, 0x80000001], np.uint32), torch.float32),
     (np.array([0x3FF0000000000000, 0xFFF8000000000001], np.uint64),
      torch.float64)],
)
def test_float_and_byte_interop_is_bit_exact(words, dtype):
    t = floats_from_words(words, dtype)
    assert t.dtype == dtype and t.shape == words.shape
    b = t.view(torch.uint8)
    assert np.array_equal(bytes_to_numpy(b), words.view(np.uint8))
    assert torch.equal(bytes_from_numpy(words.view(np.uint8)), b)
    with pytest.raises(TypeError):
        bytes_from_numpy(words)
    with pytest.raises(TypeError):
        bytes_to_numpy(t)
