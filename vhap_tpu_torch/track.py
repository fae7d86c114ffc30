"""Monocular tracking CLI (vhap/track.py; vhap_tpu/track.py).

Usage:
    python -m vhap_tpu_torch.track --data.root_folder <dir> --data.sequence <name> \
        [--model.no-use-static-offset] [--w.reg_tex_tv 1e4] [--device cpu] ...

Tracks on the CUDA card unless `--device cpu` is given.
"""

from vhap_tpu_torch.config.base import BaseTrackingConfig
from vhap_tpu_torch.config.cli import parse_cli, to_yaml


def main(argv=None):
    cfg = parse_cli(BaseTrackingConfig, argv)
    print(to_yaml(cfg))
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    tracker = GlobalTracker(cfg)
    tracker.optimize(resume_state_path=cfg.exp.resume_run_state)
    return tracker


if __name__ == "__main__":
    main()
