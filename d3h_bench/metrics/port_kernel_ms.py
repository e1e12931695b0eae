"""Device milliseconds a step in the port's hand-written kernels
(``csrc/*.cu``, reached through ``ops/compaction.py``, ``ops/scatter.py``,
``ops/raster_resolve.py`` and ``ops/scan.py``), by their kernel names.
Layer: the kernels."""

from d3h_bench.program import PORT_KERNELS, is_kernel

UNIT = "ms"
LAYER = "kernels"
MOVES = "step_ms"


def read(record: dict):
    ks = [k for k in record.get("kernels", ())
          if is_kernel(k["name"], PORT_KERNELS)]
    if not ks:
        return None
    return sum(k["dur"] for k in ks) * 1e3 / record["steps"]
