"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's readings on standard error, the numbers compared with
their limits last, and one JSON object as the last line of standard
output. Exits with code 2, printing no result, without as many CUDA
devices as the cell asks for, and with code 3 if this process holds JAX
or the JAX package once the run is over. A cell whose configuration names
a ``collective`` runs its ranks over NCCL, one process a device
(``ranks.py``); every other cell runs in this process on device 0
(``harness.py``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import harness, ranks  # noqa: E402


def _card() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "nvidia-smi: no reading"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cell, config = harness.load_cell(args.workload)[:2]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    if "collective" in config:
        log(f"card: {_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        out = ranks.run(args.workload, args.seed, args.seconds, bool(args.trace),
                        world=cell["chips"], backend="nccl", device_type="cuda",
                        t_start=T_START)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        log(f"card: {_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          device=dev, t_start=T_START, log=log)
    unwanted = harness.unwanted_modules()
    if unwanted:
        log(f"this process holds modules the run must not load: {unwanted}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
