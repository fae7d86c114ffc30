"""The control on the card: the reference in the program's place with its
float32 products in TF32 fails the comparison. Marked `cuda`: TF32 exists
only there. The cell-size readings are control.py's (PERF.md)."""

import pytest

pytestmark = pytest.mark.cuda


def test_tf32_control_is_caught(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    import cellspec
    import control
    from reference import check
    from traffic import head, scene
    spec = cellspec.cell("mono512.seq", overrides={
        "config": {"scene": {"image_size": [256, 256]}}})
    T = cellspec.n_timesteps(spec)
    d = head.write_assets(tmp_path / "a", 5)
    data = scene.write_scene(tmp_path / "data", spec["config"]["scene"],
                             spec["config"]["tracker"]["model"], T, 5, d, "cuda")
    cfg = cellspec.tracking_config(spec, check.CLASSES, data, d, tmp_path / "o", "cuda")
    rows = control.rows_of(spec, T)
    run = lambda **kw: check.follow(cfg, "rgb_sequential_tracking", 1.0, rows, T, 5,  # noqa: E731
                                    "cuda", counts=False, **kw)
    got = check.compare(run(tf32=True), run())
    limits = spec["workload"]["limits"]
    assert any(got[k] > limits[k] for k in got), got
