"""Rank 0's NCCL kernel device time per step in the profiled sub-window:
the gradient all-reduce and the energy's small global reductions."""


def read(rec):
    if rec.get("world", 1) < 2 or not rec.get("kernel_s") or not rec.get("traced_steps"):
        return None
    t = sum(s for name, s in rec["kernel_s"].items() if "nccl" in name.lower())
    return 1e3 * t / rec["traced_steps"] if t > 0 else None
