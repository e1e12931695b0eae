"""Host milliseconds of one ``step_fn`` call, which returns before the
device finishes: the mean over the untraced window of a ``--trace 1``
run. Layer: the stage loop and the step (``train/stages.py``'s pattern,
``train/step.py``)."""

UNIT = "ms"
LAYER = "stage loop and step"
MOVES = "step_ms"


def read(record: dict):
    d = record.get("dispatch_s")
    if not d:
        return None
    return sum(d) / len(d) * 1e3
