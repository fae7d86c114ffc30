"""Combine multiple exported sequences of one subject into one dataset.

Counterpart of vhap_tpu/combine_nerf_datasets.py (reference:
vhap/combine_nerf_datasets.py): deterministic test-sequence sampling
seeded by the subject name, timestep re-offsetting, relative-path rewriting,
camera-8 validation holdout, canonical-param copy.

Usage: python -m vhap_tpu_torch.combine_nerf_datasets \
           --src_folders <d1> <d2> ... --tgt_folder <out> \
           [--division_mode random_group]
"""

from __future__ import annotations

import argparse
import json
import random
import shutil
from copy import deepcopy
from pathlib import Path
from typing import List, Optional


class NeRFDatasetAssembler:
    def __init__(self, src_folders: List[Path], tgt_folder: Path,
                 division_mode: str = "random_group"):
        self.src_folders = [Path(p) for p in src_folders]
        self.tgt_folder = Path(tgt_folder)
        self.num_timestep = 0

        # subject name seeds test-sequence sampling (combine_nerf_datasets.py:26-31)
        subjects = [sf.name.split("_")[0] for sf in self.src_folders]
        for s in subjects:
            assert s == subjects[0], \
                f"Cannot combine datasets from different subjects: {subjects}"
        random.seed(subjects[0])

        if division_mode == "random_single":
            self.src_folders_test = [self.src_folders.pop(
                int(random.uniform(0, 1) * len(self.src_folders)))]
        elif division_mode == "random_group":
            # one test sequence per group of 10 (combine_nerf_datasets.py:34-46)
            self.src_folders_test = []
            num_all = len(self.src_folders)
            group_size = 10
            num_test = max(1, num_all // group_size)
            indices_test = []
            for gi in range(num_test):
                idx = min(num_all - 1, random.randint(0, group_size - 1)
                          + gi * group_size)
                indices_test.append(idx)
            for idx in indices_test:
                self.src_folders_test.append(self.src_folders.pop(idx))
        elif division_mode == "last":
            self.src_folders_test = [self.src_folders.pop(-1)]
        else:
            raise ValueError(f"Unknown division mode: {division_mode}")
        self.src_folders_train = self.src_folders

    def write(self):
        self.combine_dbs(self.src_folders_train, division="train")
        self.combine_dbs(self.src_folders_test, division="test")

    def combine_dbs(self, src_folders, division: Optional[str] = None):
        db = None
        for src_folder in src_folders:
            dbi_path = src_folder / "transforms.json"
            assert dbi_path.exists(), f"Could not find {dbi_path}"
            dbi = json.load(open(dbi_path))

            dbi["timestep_indices"] = [t + self.num_timestep
                                       for t in dbi["timestep_indices"]]
            self.num_timestep += len(dbi["timestep_indices"])
            for frame in dbi["frames"]:
                frame.pop("timestep_index_original")
                frame.pop("timestep_id")
                frame["timestep_index"] = dbi["timestep_indices"][frame["timestep_index"]]
                for key in ("file_path", "flame_param_path", "fg_mask_path"):
                    frame[key] = str(Path("..") / src_folder.name / frame[key])

            if db is None:
                db = dbi
            else:
                db["frames"] += dbi["frames"]
                db["timestep_indices"] += dbi["timestep_indices"]

        self.tgt_folder.mkdir(parents=True, exist_ok=True)

        if division == "train":
            shutil.copy(src_folders[0] / "canonical_flame_param.npz",
                        self.tgt_folder / "canonical_flame_param.npz")

            db_train = {k: v for k, v in db.items()
                        if k not in ("frames", "camera_indices")}
            db_train["frames"] = []
            db_val = deepcopy(db_train)

            if len(db["camera_indices"]) > 1:
                if 8 in db["camera_indices"]:
                    db_train["camera_indices"] = [i for i in db["camera_indices"] if i != 8]
                    db_val["camera_indices"] = [8]
                else:
                    db_train["camera_indices"] = db["camera_indices"][:-1]
                    db_val["camera_indices"] = [db["camera_indices"][-1]]
            else:
                db_train["camera_indices"] = db["camera_indices"]
                db_val["camera_indices"] = []

            for frame in db["frames"]:
                if frame["camera_index"] in db_train["camera_indices"]:
                    db_train["frames"].append(frame)
                elif frame["camera_index"] in db_val["camera_indices"]:
                    db_val["frames"].append(frame)
                else:
                    raise ValueError(f"Unknown camera index: {frame['camera_index']}")

            _write_json(db_train, self.tgt_folder, "train")
            _write_json(db_val, self.tgt_folder, "val")
            (self.tgt_folder / "sequences_trainval.txt").write_text(
                "".join(f.name + "\n" for f in src_folders))
        else:
            db["timestep_indices"] = sorted(db["timestep_indices"])
            _write_json(db, self.tgt_folder, division)
            (self.tgt_folder / f"sequences_{division}.txt").write_text(
                "".join(f.name + "\n" for f in src_folders))


def _write_json(db, tgt_folder: Path, division=None):
    fname = "transforms.json" if division is None else f"transforms_{division}.json"
    with open(Path(tgt_folder) / fname, "w") as f:
        json.dump(db, f, indent=4)


def combine(src_folders: List[Path], tgt_folder: Path,
            division_mode: str = "random_group"):
    src_folders = [Path(p) for p in src_folders]
    tgt_folder = Path(tgt_folder)
    for src_folder in src_folders:
        assert src_folder.exists(), f"Error: could not find {src_folder}"
        assert src_folder.parent == tgt_folder.parent, \
            "All source folders must share the target folder's parent"
    NeRFDatasetAssembler(src_folders, tgt_folder, division_mode).write()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src_folders", type=Path, nargs="+", required=True)
    ap.add_argument("--tgt_folder", type=Path, required=True)
    ap.add_argument("--division_mode", default="random_group",
                    choices=["random_single", "random_group", "last"])
    args = ap.parse_args()
    combine(args.src_folders, args.tgt_folder, args.division_mode)


if __name__ == "__main__":
    main()
