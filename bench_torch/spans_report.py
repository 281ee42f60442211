"""The program's own spans in one cell, read from a traced slice as the
benchmark's traced run takes it: the host syncs by site, whether every wait
on the device lies in a ``sync:`` span, the launches by layer, and idle time
and launches by stage (``program_spans.py``). With ``--sync-debug`` it first
runs one round trip under ``torch.cuda.set_sync_debug_mode("warn")`` and
names the port's line and ``sync:`` span behind each synchronising call.

    python3 bench_torch/spans_report.py --workload <cell> --seed <n> [--sync-debug]

Prints one JSON object. Needs a CUDA device, like ``run.py``.
"""

import argparse
import ast
import collections
import json
import sys
import tempfile
import traceback
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import harness, program_spans, tracing  # noqa: E402

PORT = "dietgpu_fork_torch"


def _sync_blocks(path: Path):
    """(first line, last line, name) of each ``with span("sync:...")``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.With):
            for item in node.items:
                c = item.context_expr
                if (isinstance(c, ast.Call) and getattr(c.func, "id", "") == "span"
                        and c.args and isinstance(c.args[0], ast.Constant)
                        and str(c.args[0].value).startswith("sync:")):
                    out.append((node.lineno, node.end_lineno, c.args[0].value))
    return out


def sync_sites(r: "harness.Run") -> list:
    """One round trip under the sync debug mode: each synchronising call's
    innermost line of the port and the ``sync:`` span around it."""
    seen = []

    def note(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack() if f"/{PORT}/" in f.filename]
        seen.append((frames[-1].filename, frames[-1].lineno) if frames else (filename, lineno))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r.roundtrip()
            harness._sync(r.device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    blocks = {}
    sites = collections.Counter()
    for filename, lineno in seen:
        if filename not in blocks:
            p = Path(filename)
            blocks[filename] = _sync_blocks(p) if p.is_file() else []
        inside = [n for a, b, n in blocks[filename] if a <= lineno <= b]
        rel = filename[filename.find(PORT):] if PORT in filename else filename
        sites[(f"{rel}:{lineno}", inside[-1] if inside else None)] += 1
    return [{"line": k[0], "span": k[1], "calls": v} for k, v in sorted(sites.items())]


def traced(r: "harness.Run", n: int) -> "tracing.TracedSlice":
    for _ in range(len(r.pool)):
        r.roundtrip()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tracing.instrument():
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                r.roundtrip(trace=True)
            harness._sync(r.device)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return tracing.TracedSlice(tracing.load_events(path))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sync-debug", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, config, mix, _, layer = harness.load_cell(args.workload)
    r = harness.Run(config, mix, args.seed, dev)
    for _ in range(mix["warmup_roundtrips"]):
        r.roundtrip()
    harness._sync(dev)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(dev)}
    if args.sync_debug:
        out["sync_sites"] = sync_sites(r)
    t = traced(r, mix["trace_roundtrips"])
    rt = t.roundtrips
    out["roundtrips"] = rt
    out["metrics"] = {m["name"]: harness._reader(m["name"])(t) for m in layer}
    out["sync_coverage"] = program_spans.sync_coverage(t)
    out["syncs_by_site"] = {k: v / rt for k, v in sorted(collections.Counter(
        s["name"] for s in program_spans.spans_of(t, "sync:")).items())}
    out["launches_by_family"] = {str(k): v / rt
                                 for k, v in program_spans.launches_by_family(t).items()}
    out["by_stage"] = program_spans.by_stage(t)
    print(json.dumps(out), flush=True)
    return 0 if r.failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
