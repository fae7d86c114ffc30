"""NeRSemble v2 multiview tracking CLI (vhap/track_nersemble_v2.py; vhap_tpu/track_nersemble_v2.py).

Usage:
    python -m vhap_tpu_torch.track_nersemble_v2 --data.root_folder <dir> \
        --data.subject <id> --data.sequence <name> [--device cpu] ...

Tracks every calibrated view of a timestep per step, on the CUDA card
unless `--device cpu` is given.
"""

from vhap_tpu_torch.config.cli import parse_cli, to_yaml
from vhap_tpu_torch.config.nersemble_v2 import NersembleV2TrackingConfig


def main(argv=None):
    cfg = parse_cli(NersembleV2TrackingConfig, argv)
    print(to_yaml(cfg))
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    tracker = GlobalTracker(cfg)
    tracker.optimize(resume_state_path=cfg.exp.resume_run_state)
    return tracker


if __name__ == "__main__":
    main()
