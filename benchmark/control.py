"""The controls of a cell's comparison, read on the card at the cell's size.

    python benchmark/control.py --workload <cell> --seeds 11 12 13 [--kinds tf32 half_batch altered]

For each seed it writes the cell's scene, runs the plain reference's first
steps as the comparison's reference, and runs them again in the program's
place with one control: `tf32` (the float32 products in TF32, the nearest
precision below the configuration's float32), or a fault of
reference/check.py FAULTS planted in the step (`half_batch`, `altered`;
`unchanged` reads 1 on grad and change by construction). It prints one
JSON line per seed and control: the numbers `correct` compares, the
cell's limits they break (`failed`) and `correct`, which every control
has to turn false. It exits 1 if one did not. The benchmark's own runs
never run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def rows_of(spec, n_timesteps: int):
    """The cell's first three steps' frames, as the tracker's loop feeds them."""
    import numpy as np
    conf, traffic = spec["config"], spec["traffic"]
    if conf["scene"]["layout"] == "rig":
        return [[0]] * 3
    bs = conf["tracker"]["batch_size"]
    if traffic["loop"] == "sequential":
        return [list(range(bs))] * 3
    order = np.arange(n_timesteps)
    np.random.default_rng(0).shuffle(order)
    return [order[i * bs:(i + 1) * bs].tolist() for i in range(3)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=["tf32", "half_batch", "altered"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    import cellspec
    from reference import check
    from traffic import head as head_assets
    from traffic import scene
    spec = cellspec.cell(args.workload)
    traffic = spec["traffic"]
    dev = torch.device(args.device)
    T = cellspec.n_timesteps(spec)
    limits = spec["workload"]["limits"]
    missed = 0
    for seed in args.seeds:
        s = seed % (2 ** 62)
        base = Path(tempfile.mkdtemp(prefix="vhap_control_", dir=os.environ.get("TMPDIR")))
        try:
            asset_dir = head_assets.write_assets(base / "assets", s)
            data = scene.write_scene(base / "data", spec["config"]["scene"],
                                     spec["config"]["tracker"]["model"], T, s,
                                     asset_dir, dev)
            cfg = cellspec.tracking_config(spec, check.CLASSES, data, asset_dir,
                                           base / "output", args.device)
            rows = rows_of(spec, T)
            chips = spec["workload"]["chips"]
            gens = [s + r for r in range(chips)] if chips > 1 else s
            run = lambda **kw: check.follow(cfg, traffic["stage"],  # noqa: E731
                                            float(traffic["lr_scale"]), rows, T, gens,
                                            dev, counts=False, **kw)
            t0 = time.perf_counter()
            ref = run()
            t_ref = time.perf_counter() - t0
            for kind in args.kinds:
                other = run(tf32=True) if kind == "tf32" else run(fault=kind)
                got = check.compare(other, ref)
                failed = sorted(k for k, v in limits.items() if got[k] > v)
                missed += not failed
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "control": kind, "reference_s": t_ref, **got,
                                  "failed": failed, "correct": not failed}),
                      flush=True)
        finally:
            shutil.rmtree(base, ignore_errors=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
