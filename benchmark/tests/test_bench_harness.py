"""The harness: what it may import, that its files are found by name, and
the shape of its last line."""

import ast
import json
import shutil
import subprocess
import sys
import time

from conftest import BENCH, tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "vhap_tpu"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: vhap_tpu_torch, the package under
    test, begins with vhap_tpu and is allowed."""
    files = sorted(BENCH.rglob("*.py"))
    assert files
    found = {str(p.relative_to(BENCH)): sorted(set(_top_level_imports(p)) & FORBIDDEN)
             for p in files}
    assert not {k: v for k, v in found.items() if v}


def test_harness_process_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness, run, costs; "
            "import reference.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH), str(BENCH.parent), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _copy_benchmark(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_cell_config_and_metric_are_taken_in_by_name(tmp_path):
    """Files added beside the others are found without editing any."""
    root = _copy_benchmark(tmp_path)
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "mono512.json").read_text())
    conf["name"] = "mono256"
    conf["scene"]["image_size"] = [256, 256]
    (b / "configs" / "mono256.json").write_text(json.dumps(conf))
    (b / "traffic" / "seq_short.json").write_text(json.dumps(
        {**json.loads((b / "traffic" / "seq.json").read_text()), "batches": 8}))
    (b / "workloads" / "mono256.seq_short.json").write_text(json.dumps(
        {"config": "mono256", "traffic": "seq_short", "chips": 1,
         "limits": {"loss": 1.0, "grad": 1.0, "change": 1.0}}))
    (b / "metrics" / "steps_traced.py").write_text(
        "def read(rec):\n    return rec.get('traced_steps')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "tracker loop", "moves": "step_ms",
                               "workloads": ["mono256.seq_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import cellspec, run, importlib\n"
        "s = cellspec.cell('mono256.seq_short')\n"
        "assert s['config']['scene']['image_size'] == [256, 256]\n"
        "assert cellspec.n_timesteps(s) == 8 * 16\n"
        "names = [m['name'] for m in run.metric_specs('mono256.seq_short', True)]\n"
        "assert names == ['steps_traced'], names\n"
        "assert importlib.import_module('metrics.steps_traced').read({'traced_steps': 20}) == 20\n"
        "assert [m['name'] for m in run.metric_specs('mono256.seq_short', False)] == "
        "['step_ms', 'step_p95_ms', 'setup_s']\n"
        "print('ok')\n" % (str(b), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_run_without_a_card_prints_no_result(tmp_path):
    """In a checkout of BENCHMARK.json and benchmark/ alone there is no
    program; here there is no card either: no result, exit not 0."""
    root = _copy_benchmark(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mono512.seq", "--seed", "4294967311", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_last_line_has_the_contracts_keys():
    import harness
    import run
    rec = harness.run("mono512.seq", 2 ** 31 + 11, 0.5, False, time.perf_counter(),
                      device="cpu", overrides=tiny("mono512.seq"))
    assert rec["correct"], rec["compared"]

    class _Cuda:
        @staticmethod
        def get_device_name(i):
            return "cpu (test)"
    import torch
    real = torch.cuda.get_device_name
    torch.cuda.get_device_name = _Cuda.get_device_name
    try:
        out = run.result_line(rec, run.metric_specs("mono512.seq", False), False, 1)
    finally:
        torch.cuda.get_device_name = real
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"step_ms", "step_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["attempted"] == rec["steps"] > 0 and out["failed"] == 0
    assert list(out["checks"]) == list(rec["limits"])
    json.dumps(out)
