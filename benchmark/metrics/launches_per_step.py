"""Device ops per step in the profiled sub-window (kernels, copies, sets)."""


def read(rec):
    if not rec.get("traced_steps") or not rec.get("device_ops"):
        return None
    return rec["device_ops"] / rec["traced_steps"]
