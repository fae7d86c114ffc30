"""A kernel family's counted bound over its device time per step in the
profiled sub-window (its kernels found by name in the trace)."""

import costs


def share(rec, kernels, patterns):
    if "counts" not in rec or not rec.get("kernel_s") or not rec.get("traced_steps"):
        return None
    t = sum(s for name, s in rec["kernel_s"].items()
            if any(p in name for p in patterns)) / rec["traced_steps"]
    if t <= 0:
        return None
    return 100.0 * costs.kernel_bound_s(kernels, rec["counts"]) / t
