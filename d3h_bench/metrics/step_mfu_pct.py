"""Percent of the card's f32 peak that a step's counted operations
(``flops.py``, a floor of the step's work) take in the untraced
window's step time. Layer: the whole step."""

UNIT = "%"
LAYER = "whole step"
MOVES = "step_ms"


def read(record: dict):
    if not record.get("kernels") or not record.get("step_ms"):
        return None
    return 100.0 * record["flops_per_step"] / (
        record["step_ms"] * 1e-3 * record["peak_flops"])
