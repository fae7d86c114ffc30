"""Time the tracker with the native frame loader and with PIL, in turns.

One process tracks, at chip_smoke.py's reduced depths, the monocular
32-frame 512^2 sequence of its phase 19 and the 16-view colour-corrected
rig of its phase 22 (teeth head, 4 timesteps), each four times in the
order native, PIL, PIL, native (PIL forced by turning the dataset's
`supports_native_batch` off after construction), and prints one JSON line:
per run the median ms/step of every stage, the wall and the batches each
path decoded. Both loaders feed the same prefetch thread, so the rgb
stages' difference is what the host decode costs the step.

    python -m vhap_tpu_torch.tools.loader_ab [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from vhap_tpu_torch.config.base import BaseTrackingConfig
from vhap_tpu_torch.config.cli import parse_cli
from vhap_tpu_torch.config.nersemble import NersembleTrackingConfig
from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.tools.make_synthetic_sequence import generate
from vhap_tpu_torch.tools.multiview_slice import write_rig
from vhap_tpu_torch.tracker.tracker import GlobalTracker

ORDER = ("native", "pil", "pil", "native")
# chip_smoke.py's reduced depths (the reference: 500 a stage, 50 a frame or
# timestep, 30 global epochs); both run one global epoch
MONO_STEPS = {"lmk_init_rigid": 50, "lmk_init_all": 50, "rgb_init_texture": 10,
              "rgb_init_all": 10, "rgb_init_offset": 10, "rgb_sequential_tracking": 10}
MV_STEPS = {"lmk_init_rigid": 150, "lmk_init_all": 150, "rgb_init_texture": 10,
            "rgb_init_all": 10, "rgb_init_offset": 10, "rgb_sequential_tracking": 20}


def mono_config(root: Path, out: Path, device: str) -> BaseTrackingConfig:
    """The monocular loop of chip_smoke.py phases 19 and 25 on root/seq:
    full width (batch 16, texture 2048, static offset, residual texture),
    MONO_STEPS deep, media every 25 steps, one process."""
    cfg = BaseTrackingConfig()
    cfg.data.root_folder, cfg.data.sequence = root, "seq"
    cfg.data.background_color = None
    cfg.model.add_teeth = False
    cfg.model.use_static_offset = cfg.model.tex_extra = True
    cfg.model.tex_resolution = 2048
    cfg.exp.output_folder = out
    cfg.batch_size = 16
    cfg.device = device
    cfg.exp.num_devices = 1
    for stage, n in MONO_STEPS.items():
        cfg.pipeline[stage].num_steps = n
    cfg.pipeline.rgb_global_tracking.num_epochs = 1
    cfg.log.interval_scalar, cfg.log.interval_media = 50, 25
    cfg.__post_init__()
    return cfg


def mv_argv(root: Path, out: Path) -> list:
    """track_nersemble's arguments in chip_smoke.py phase 22, on the rig of
    tools/multiview_slice.write_rig(root), MV_STEPS deep, one process."""
    argv = ["--data.root_folder", str(root / "data"), "--data.subject", "001",
            "--data.sequence", "SEN-01", "--data.no-align-cameras-to-axes",
            "--data.background_color", "None", "--model.asset_dir", str(root / "assets"),
            "--model.remove-lip-inside", "--exp.output_folder", str(out),
            "--pipeline.rgb_global_tracking.num_epochs", "1",
            "--log.interval_scalar", "50", "--log.interval_media", "100",
            "--exp.num_devices", "1"]
    for stage, n in MV_STEPS.items():
        argv += [f"--pipeline.{stage}.num_steps", str(n)]
    return argv


def mv_config(root: Path, out: Path, device: str) -> NersembleTrackingConfig:
    return parse_cli(NersembleTrackingConfig, mv_argv(root, out) + ["--device", device])


def track(cfg, native: bool) -> dict:
    tr = GlobalTracker(cfg)
    if not native:
        tr.dataset.supports_native_batch = lambda: False
    t = time.perf_counter()
    tr.optimize()
    if tr.device.type == "cuda":
        torch.cuda.synchronize()
    return {"loader": "native" if native else "pil",
            "wall_s": time.perf_counter() - t,
            "native_batches": tr.dataset.native_batches,
            "pil_batches": tr.dataset.pil_batches,
            "stage_ms": {st: tr.step_timer.median_ms(st) for st in tr.steps_by_stage}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))
    out = {"device": (torch.cuda.get_device_name(0) if dev.startswith("cuda")
                      else "cpu"), "order": ORDER}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        generate(root / "mono" / "seq", n_frames=32, size=512, n_shape=300,
                 n_expr=100, device=dev)
        write_rig(root / "mv", n_cams=16, n_frames=4, size=512, device=dev)
        for name, make in (("monocular", mono_config), ("multiview", mv_config)):
            out[name] = [track(make(root / ("mono" if name == "monocular" else "mv"),
                                    root / f"out_{name}_{i}", dev), loader == "native")
                         for i, loader in enumerate(ORDER)]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
