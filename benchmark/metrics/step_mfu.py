"""The whole step's share of the chip's peak: the larger of its counted
float32 operations over 67 TFLOP/s and its counted bytes over 3.35 TB/s
(costs.step), over the measured time of an untraced step."""

import costs


def read(rec):
    if "counts" not in rec or not rec.get("step_s"):
        return None
    return 100.0 * costs.bound_s(*costs.step(rec["counts"]))[0] / rec["step_s"]
