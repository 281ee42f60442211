import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, runpy\n"
        "import bench_torch.harness, bench_torch.control, bench_torch.reference\n"
        "from bench_torch import harness\n"
        "for p in sorted((harness.HERE / 'metrics').glob('*.py')):\n"
        "    harness._reader(p.stem)\n"
        "import dietgpu_fork_torch.api.codec, dietgpu_fork_torch.runtime.cuda_kernels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dietgpu_fork_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_file_names_jax_or_the_old_benchmarks():
    """The JAX package is named only in the tuple of modules a run refuses
    to hold (``harness.UNWANTED``)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|dietgpu_fork_tpu)\b|"
                     r"dietgpu_fork_tpu|['\"]bench/|['\"]bench\.py", re.M)
    refused = re.compile(r"^UNWANTED = \(.*\)$", re.M)
    for p in HERE.rglob("*.py"):
        if p.name == Path(__file__).name:
            continue
        text = p.read_text()
        if p == HERE / "harness.py":
            assert len(refused.findall(text)) == 1
            text = refused.sub("", text)
        assert not pat.search(text), p


def test_a_run_finds_jax_and_the_jax_package_by_top_level_name(monkeypatch):
    from bench_torch import harness
    assert {"jax", "jaxlib", "flax", "dietgpu_fork_tpu"} <= set(harness.UNWANTED)
    before = harness.unwanted_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.bench_probe", object())
    monkeypatch.setitem(sys.modules, "dietgpu_fork_tpu_x", object())
    assert harness.unwanted_modules() == sorted(before + ["jaxlib.bench_probe"])


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload", "sparse_fp64.b3x1m",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0 and res.stdout == ""
