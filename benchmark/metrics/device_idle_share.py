"""100 x (1 - device-busy per step / step time): busy is the union of the
device ops' intervals in the profiled sub-window's trace (the ranks' mean
when sharded), over its steps; the step time is the untraced window's
`step_ms`, since under the profiler a step takes several times as long."""


def read(rec):
    if not rec.get("busy_s") or not rec.get("traced_steps") or not rec.get("step_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_steps"] / rec["step_s"])
