"""Device kernels a step in the traced window. Layer: the kernels."""

UNIT = "launches"
LAYER = "kernels"
MOVES = "step_ms"


def read(record: dict):
    if not record.get("kernels"):
        return None
    return len(record["kernels"]) / record["steps"]
