"""tools/validate.py, the port's GT-recovery gate (the counterpart of
vhap_tpu/tools/validate_tpu.py), on the CPU at a tiny size: same report
keys and PASS rule, a shortened reduced schedule, the card by default.
Run on one torch thread, as tests/test_torch_tracker.py is, for the same
reason."""

import numpy as np
import pytest
import torch

# vhap_tpu/tools/validate_tpu.py:86-103
REPORT_KEYS = ["wall_s", "wall_s_per_frame", "media_write_s", "media_blocked_s",
               "tracking_wall_s", "frames", "size", "batch_size",
               "reference_schedule", "rot_err_rad", "trans_err_m", "expr_err"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_validate_passes_on_cpu(tmp_path, capsys):
    from vhap_tpu_torch.tools.validate import main
    rc = main(["--workdir", str(tmp_path), "--frames", "2", "--size", "32",
               "--batch_size", "2", "--schedule_scale", "0.1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "RESULT: PASS" in out and rc == 0, out
    report = eval(out.split("VALIDATION REPORT:")[1].splitlines()[0].strip())
    assert list(report) == REPORT_KEYS
    assert report["rot_err_rad"] < 0.1 and report["trans_err_m"] < 0.02
    assert all(np.isfinite(float(v)) for v in report.values())


def test_schedule(tmp_path):
    """The reduced schedule of validate_tpu.py, scaled; the reference one
    keeps the config's defaults."""
    from vhap_tpu_torch.tools.validate import build_config
    cfg = build_config(tmp_path, 256, 8)
    assert (cfg.pipeline.lmk_init_rigid.num_steps, cfg.pipeline.rgb_init_offset.num_steps,
            cfg.pipeline.rgb_sequential_tracking.num_steps,
            cfg.pipeline.rgb_global_tracking.num_epochs) == (300, 100, 50, 5)
    cfg = build_config(tmp_path, 256, 8, schedule_scale=0.1)
    assert (cfg.pipeline.lmk_init_rigid.num_steps,
            cfg.pipeline.rgb_global_tracking.num_epochs) == (30, 1)
    cfg = build_config(tmp_path, 256, 8, reference_schedule=True)
    assert (cfg.pipeline.lmk_init_rigid.num_steps,
            cfg.pipeline.rgb_global_tracking.num_epochs) == (500, 30)
    assert cfg.device is None and cfg.model.tex_resolution == 256


def test_validate_needs_a_card_or_cpu(tmp_path, monkeypatch):
    from vhap_tpu_torch.tools.validate import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--workdir", str(tmp_path), "--frames", "2", "--size", "32"])
