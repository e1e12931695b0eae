"""Device milliseconds a step in which some operation (kernel, copy,
set) runs: the union of their intervals in the traced window, over its
steps. Layer: the device."""

UNIT = "ms"
LAYER = "device"
MOVES = "step_ms"


def read(record: dict):
    if not record.get("kernels"):
        return None
    return record["busy_s"] * 1e3 / record["steps"]
