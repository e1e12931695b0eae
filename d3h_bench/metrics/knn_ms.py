"""Device milliseconds a step of the kernels launched under the port's
``ops/knn.py:knn1`` (the collision search and the skinning weights'
transfer; both run without grad on the Python thread, so the host range
around each call holds their launches). Layer: the nearest-neighbour
search."""

UNIT = "ms"
LAYER = "collision and weight-transfer search"
MOVES = "step_ms"


def read(record: dict):
    ks = [k for k in record.get("kernels", ()) if k["knn"]]
    if not ks:
        return None
    return sum(k["dur"] for k in ks) * 1e3 / record["steps"]
