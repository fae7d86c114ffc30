"""The frozen counts behind step_mfu and the rooflines."""

import pytest

import costs

# chip_smoke.py's bench-width launches (its logs, NVIDIA H100 80GB HBM3):
# batch 16 at 512 x 512, 6,016 faces, 295,680 foreground pixels on 2,230
# visible faces, 36,942 texels under 2,365,440 live taps, a 2048 texture
BENCH = {"B": 16, "H": 512, "W": 512, "F": 6016, "n_fg": 295680,
         "n_faces_visible": 2230, "n_cov": 295680, "n_taps": 2365440,
         "n_texels": 36942, "n_texels_k4": 36942,
         "n_texels_pyramid": sum(4 ** k for k in range(12)),
         "n_valid": 40000, "n_cand": 2.8e6, "tex_res": 2048, "V": 5023,
         "n_basis": 400, "leaf_numel": {"tex_extra": 3 * 2048 ** 2, "expr": 1024 * 100}}


def ms(f, *a):
    return costs.bound_s(*f(*a))[0] * 1e3


def test_kernel_table_bounds_at_bench_width():
    """PERF.md's kernel table: K3 0.0185, K4 0.0686, K2b 0.0148 ms, K2f
    0.1053 ms (the eval step's table, no flag rows), all byte-bound."""
    assert ms(costs.k3, BENCH) == pytest.approx(0.0185, abs=5e-5)
    assert ms(costs.k4, BENCH) == pytest.approx(0.0686, abs=5e-5)
    assert ms(costs.k2b, BENCH) == pytest.approx(0.0148, abs=5e-5)
    assert ms(costs.k2f, BENCH, 0) == pytest.approx(0.1053, abs=5e-5)
    for f in (costs.k2f, costs.k2b, costs.k3, costs.k4):
        assert costs.bound_s(*f(BENCH))[1] == "bytes"


def test_counts_depend_on_shapes_and_live_pixels_only():
    a = costs.step(BENCH)
    assert costs.step(dict(BENCH)) == a
    more_fg = {**BENCH, "n_fg": 2 * BENCH["n_fg"], "n_cov": 2 * BENCH["n_cov"]}
    assert costs.step(more_fg)[1] > a[1]
    bigger = {**BENCH, "H": 1024}
    assert costs.pixels(bigger)[0] == 2 * costs.pixels(BENCH)[0]
    assert costs.adam({**BENCH, "leaf_numel": {}}) == (0, 0)


def test_step_bound_covers_its_parts():
    n_bytes, n_flops = costs.step(BENCH)
    assert n_bytes > sum(f(BENCH)[0] for f in costs.KERNELS.values())
    t, by = costs.bound_s(n_bytes, n_flops)
    assert by == "bytes" and 0.5e-3 < t < 5e-3
