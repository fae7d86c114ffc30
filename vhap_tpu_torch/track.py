"""Monocular tracking CLI (vhap/track.py; vhap_tpu/track.py).

Usage:
    python -m vhap_tpu_torch.track --data.root_folder <dir> --data.sequence <name> \
        [--model.no-use-static-offset] [--w.reg_tex_tv 1e4] [--device cpu] ...

Tracks on the CUDA card unless `--device cpu` is given.

`--exp.num_devices N` shards each batch over N cards, one process each
(0, the default: every visible card; with `--device cpu`, N gloo
processes); a run started by torchrun joins torchrun's processes. Only
rank 0 writes. main() returns the run's summary, rank 0's when several
processes run (tracker.run_tracker).
"""

from vhap_tpu_torch.config.base import BaseTrackingConfig
from vhap_tpu_torch.config.cli import parse_cli, to_yaml


def main(argv=None):
    cfg = parse_cli(BaseTrackingConfig, argv)
    print(to_yaml(cfg))
    from vhap_tpu_torch.tracker.tracker import run_tracker
    return run_tracker(cfg)


if __name__ == "__main__":
    main()
