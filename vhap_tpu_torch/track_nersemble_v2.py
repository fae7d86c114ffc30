"""NeRSemble v2 multiview tracking CLI (vhap/track_nersemble_v2.py; vhap_tpu/track_nersemble_v2.py).

Usage:
    python -m vhap_tpu_torch.track_nersemble_v2 --data.root_folder <dir> \
        --data.subject <id> --data.sequence <name> [--device cpu] ...

Tracks every calibrated view of a timestep per step, on the CUDA card
unless `--device cpu` is given.

`--exp.num_devices N` shards each batch over N cards, one process each
(0, the default: every visible card; with `--device cpu`, N gloo
processes); a run started by torchrun joins torchrun's processes. Only
rank 0 writes. main() returns the run's summary, rank 0's when several
processes run (tracker.run_tracker).
"""

from vhap_tpu_torch.config.cli import parse_cli, to_yaml
from vhap_tpu_torch.config.nersemble_v2 import NersembleV2TrackingConfig


def main(argv=None):
    cfg = parse_cli(NersembleV2TrackingConfig, argv)
    print(to_yaml(cfg))
    from vhap_tpu_torch.tracker.tracker import run_tracker
    return run_tracker(cfg)


if __name__ == "__main__":
    main()
