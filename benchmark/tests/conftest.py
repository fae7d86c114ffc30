"""The benchmark's tests: the harness, the reference, the frozen counts,
the traffic writers and the faults the check must catch.

    python -m pytest benchmark/tests -q

Tests marked `cuda` need an NVIDIA card and skip elsewhere; the rest run
on the CPU at a tiny size, where the port takes the plain version of every
kernel."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


# tiny sizes of the cells for CPU runs: every width of the step kept in
# kind, the images, texture, bases and loop cut down
TINY = {
    "mono512": {"config": {"tracker": {"batch_size": 2, "model": {
        "n_shape": 20, "n_expr": 10, "tex_resolution": 64}},
        "scene": {"image_size": [32, 32], "period": 4}}},
    "nersemble16": {"config": {"tracker": {"model": {
        "n_shape": 20, "n_expr": 10, "tex_resolution": 64}},
        "scene": {"cameras": 4, "image_size_calibration": [128, 88],
                  "focal_px": 290.0, "period": 2}}},
}


def tiny(workload: str, **traffic):
    import cellspec
    conf = cellspec.load("workloads", workload)["config"]
    t = {"batches": 12, "pipeline": {"rgb_sequential_tracking": {"num_steps": 4}}}
    t.update(traffic)
    return {**TINY[conf], "traffic": t}
