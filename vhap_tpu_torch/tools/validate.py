"""End-to-end validation: synthetic sequence -> full staged pipeline ->
ground-truth recovery report.

Counterpart of vhap_tpu/tools/validate_tpu.py: generates a 16-frame
synthetic head sequence with the port's generator, runs the complete
photometric tracking pipeline (GlobalTracker) and reports the recovery
errors against the known ground truth. It PASSes when every number of the
report is finite, the mean rotation error is under 0.1 rad and the mean
translation error under 0.02. Runs on the CUDA card unless given
`--device cpu`; `--num_devices N` shards each batch over N devices, one
process each, as the tracker's `exp.num_devices` (0, the default: every
visible card, one process on the CPU).

Usage: python -m vhap_tpu_torch.tools.validate [--workdir output/validate]
           [--device cpu] [--num_devices N] [--reference_schedule]
           [--schedule_scale 0.5]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

# the reduced smoke schedule (vhap_tpu/tools/validate_tpu.py:67-74)
REDUCED_STEPS = {"lmk_init_rigid": 300, "lmk_init_all": 300,
                 "rgb_init_texture": 200, "rgb_init_all": 200,
                 "rgb_init_offset": 100, "rgb_sequential_tracking": 50}
REDUCED_GLOBAL_EPOCHS = 5


def build_config(workdir: Path, size: int, batch_size: int,
                 texture_grad_mode: str = "trilinear",
                 texture_grad_impl: str = "auto",
                 reference_schedule: bool = False,
                 schedule_scale: float = 1.0, device=None, num_devices: int = 0):
    """The validation run's tracking config (validate_tpu.py:55-77); a
    schedule_scale below 1 shortens every stage of the reduced schedule."""
    from vhap_tpu_torch.config.base import BaseTrackingConfig
    cfg = BaseTrackingConfig()
    cfg.data.root_folder = workdir
    cfg.data.sequence = "seq"
    cfg.data.background_color = None
    cfg.model.n_shape, cfg.model.n_expr = 50, 20
    cfg.model.add_teeth = False
    cfg.model.use_static_offset = True
    cfg.model.tex_resolution = size
    cfg.exp.output_folder = workdir / "out"
    cfg.batch_size = batch_size
    cfg.render.texture_grad_mode = texture_grad_mode
    cfg.render.texture_grad_impl = texture_grad_impl
    cfg.device = device
    cfg.exp.num_devices = num_devices
    if not reference_schedule:
        for stage, n in REDUCED_STEPS.items():
            cfg.pipeline[stage].num_steps = max(1, round(n * schedule_scale))
        cfg.pipeline.rgb_global_tracking.num_epochs = max(
            1, round(REDUCED_GLOBAL_EPOCHS * schedule_scale))
    cfg.log.interval_scalar = 200
    cfg.log.interval_media = 10 ** 9
    cfg.__post_init__()
    return cfg


def run(workdir: Path, frames: int = 16, size: int = 256, batch_size: int = 8,
        texture_grad_mode: str = "trilinear", texture_grad_impl: str = "auto",
        reference_schedule: bool = False, schedule_scale: float = 1.0,
        device=None, num_devices: int = 0):
    """Generate (once), track, and return (report, ok, the run's summary,
    tracker.run_tracker's)."""
    from vhap_tpu_torch.tools.make_synthetic_sequence import generate
    from vhap_tpu_torch.tracker.tracker import run_tracker

    workdir = Path(workdir)
    seq_dir = workdir / "seq"
    if not (seq_dir / "gt_params.npz").exists():
        print("generating synthetic sequence ...", flush=True)
        generate(seq_dir, n_frames=frames, size=size, n_shape=50, n_expr=20,
                 device=device)

    cfg = build_config(workdir, size, batch_size, texture_grad_mode,
                       texture_grad_impl, reference_schedule, schedule_scale,
                       device, num_devices)
    t0 = time.time()
    info = run_tracker(cfg)
    wall = time.time() - t0

    gt = np.load(seq_dir / "gt_params.npz")
    z = np.load(sorted(Path(info["out_dir"]).glob("tracked_flame_params_*.npz"))[-1])
    report = {
        "wall_s": round(wall, 1),
        "wall_s_per_frame": round(wall / frames, 2),
        # media_write_s is background-thread IO (overlaps the device),
        # media_blocked_s is main-thread time lost to the media backlog
        # (bounded queue waits + the final drain); tracking wall = wall -
        # blocked
        "media_write_s": round(info["media_write_s"], 1),
        "media_blocked_s": round(info["media_blocked_s"], 1),
        "tracking_wall_s": round(wall - info["media_blocked_s"], 1),
        "frames": frames,
        "size": size,
        "batch_size": batch_size,
        "reference_schedule": reference_schedule,
        "rot_err_rad": float(np.abs(z["rotation"] - gt["rotation"]).mean()),
        "trans_err_m": float(np.abs(z["translation"] - gt["translation"]).mean()),
        "expr_err": float(np.abs(z["expr"] - gt["expr"]).mean()),
    }
    ok = bool(np.isfinite(list(report.values())).all()
              and report["rot_err_rad"] < 0.1 and report["trans_err_m"] < 0.02)
    return report, ok, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", type=Path, default=Path("output/validate"))
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--texture_grad_mode", default="trilinear")
    ap.add_argument("--texture_grad_impl", default="auto")
    ap.add_argument("--reference_schedule", action="store_true",
                    help="keep the reference's full stage step counts "
                         "(config/base.py defaults: 500-step inits, 30 "
                         "global epochs) instead of the reduced schedule")
    ap.add_argument("--schedule_scale", type=float, default=1.0,
                    help="scale every step count of the reduced schedule")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--num_devices", type=int, default=0,
                    help="devices to shard each batch over, one process each "
                         "(0: every visible card; one process on the CPU)")
    args = ap.parse_args(argv)
    report, ok, _ = run(args.workdir, args.frames, args.size, args.batch_size,
                        args.texture_grad_mode, args.texture_grad_impl,
                        args.reference_schedule, args.schedule_scale,
                        args.device, args.num_devices)
    print("VALIDATION REPORT:", report)
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
