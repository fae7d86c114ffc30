"""Run one benchmark cell of vhap_tpu_torch once, on this machine's cards.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is benchmark/workloads/<cell>.json (its configuration, traffic and
limits, found by name); harness.py runs it. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1,
each read by benchmark/metrics/<metric>.py), device, with --trace 1 the
profiled sub-window's breakdown, and last the numbers compared beside
their limits, which also close standard error. Without a CUDA card, or
with fewer than the cell asks for, it exits 3 and prints no result; with
JAX or the JAX package loaded after the window, 4.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

# caches of the program's builds stay inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "bench_cache" / sub))


def metric_specs(workload: str, trace: bool):
    """The BENCHMARK.json metrics this cell reports in this kind of run."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_loaded():
    import harness
    return sorted({m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def result_line(rec, specs, trace: bool, chips: int) -> dict:
    import torch
    metrics = {}
    for m in specs:
        if trace:
            value = importlib.import_module(f"metrics.{m['name']}").read(rec)
        else:
            value = {"step_ms": rec["step_s"] * 1e3,
                     "step_p95_ms": (rec["step_p95_s"] * 1e3
                                     if rec["step_p95_s"] is not None else None),
                     "setup_s": rec["setup_s"]}.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": rec["correct"], "attempted": rec["steps"],
           "failed": sum(rec["compared"][k] > v for k, v in rec["limits"].items()),
           "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=rec["busy_s"], window_s=rec["traced_wall_s"])
        out["breakdown"] = rec["breakdown"]
    out["checks"] = {k: {"value": rec["compared"][k], "limit": v}
                     for k, v in rec["limits"].items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import cellspec
    chips = cellspec.load("workloads", args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell needs {chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 3
    print(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)

    import harness
    trace = bool(args.trace)
    specs = metric_specs(args.workload, trace)
    rec = harness.run(args.workload, args.seed, args.seconds, trace, T_PROCESS)
    found = sorted(set(rec["forbidden_modules"]) | set(forbidden_loaded()))
    if found:
        print(f"run.py: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    out = result_line(rec, specs, trace, chips)
    print(f"[run] {args.workload} seed {args.seed}: {rec['steps']} steps in "
          f"{rec['window_s']:.3f} s, setup {rec['setup_s']:.3f} s, peak "
          f"{rec['memory_peak_bytes']} bytes; counts {json.dumps(rec['counts'])}",
          file=sys.stderr)
    for k, v in rec["detail"].items():
        print(f"detail {k} {json.dumps(v)}", file=sys.stderr)
    print(f"compared {json.dumps(rec['compared'])}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
