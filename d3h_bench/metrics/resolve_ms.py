"""Device milliseconds a step in the rasterizer's tile resolve: the
kernels of ``csrc/raster_resolve.cu`` (reached through
``ops/raster_resolve.py:resolve_tiles``), matched by the names below.
Layer: the rasterizer's tile resolve."""

UNIT = "ms"
LAYER = "rasterizer: tile resolve"
MOVES = "step_ms"
# the resolve's kernels as the profiler names them
NAMES = ("resolve_tiles_kernel", "fill_keys_kernel")


def read(record: dict):
    ks = [k for k in record.get("kernels", ())
          if any(n in k["name"] for n in NAMES)]
    if not ks:
        return None
    return sum(k["dur"] for k in ks) * 1e3 / record["steps"]
