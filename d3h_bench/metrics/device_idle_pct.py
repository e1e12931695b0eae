"""Percent of a step in which the device runs nothing: one less the
traced steps' busy time a step over the untraced window's step time
(the profiler's host overhead lengthens the traced window itself).
Layer: the device."""

UNIT = "%"
LAYER = "device"
MOVES = "step_ms"


def read(record: dict):
    if not record.get("kernels") or not record.get("step_ms"):
        return None
    busy_ms = record["busy_s"] * 1e3 / record["steps"]
    return 100.0 * (1.0 - busy_ms / record["step_ms"])
