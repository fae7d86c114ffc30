"""The plain reference against the port's use_kernels=False path: on the
CPU the port takes the plain version of every kernel, so a run of each
cell at a tiny size holds the reference's first steps against the
tracker's own (energy of each step, step 1's gradients, the change over
the three steps). The four-chip cell runs as four gloo processes, one view
each, against the reference's one-process version of the sharded step."""

import time

import pytest

from conftest import tiny


@pytest.mark.parametrize("workload", ["mono512.seq", "nersemble16.seq", "mono512.global",
                                      "nersemble16.seq.x4"])
def test_reference_follows_the_port(workload):
    import harness
    rec = harness.run(workload, 987654321987, 0.5, False, time.perf_counter(),
                      device="cpu", overrides=tiny(workload))
    c = rec["compared"]
    # the same float32 operations in the same order on one device: only
    # the order of a few reductions may differ
    assert c["loss"] <= 1e-6 and c["grad"] <= 1e-6 and c["change"] <= 1e-6, c
    assert rec["counts"]["n_fg"] > 0 and rec["counts"]["n_taps"] > 0
    # the live counts are rank 0's rows: what its kernels time
    batch = 4 if workload.startswith("nersemble") else 2
    assert rec["counts"]["B"] * rec["world"] == batch
    assert rec["steps"] > 0 and rec["correct"]


def test_reference_imports_nothing_of_the_program():
    import sys
    import reference.check  # noqa: F401
    loaded = {m.split(".")[0] for m in sys.modules if m.startswith("reference")}
    assert loaded == {"reference"}
    from pathlib import Path
    import ast
    root = Path(reference.check.__file__).parent
    for p in root.rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(n.split(".")[0] in {"vhap_tpu_torch", "vhap_tpu", "jax"}
                               for n in names), (p, names)
