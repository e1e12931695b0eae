"""The traced window: ``torch.profiler`` over a run of steps, read from
its Chrome trace, checked complete, and reduced to what the per-layer
readers and the result's ``breakdown`` take.

A trace is complete when every kernel launch on the host inside the
window has its kernel on the device, every step has kernels, and each
counted kernel wrapper of the port shows as many kernels of its names as
it counted launches. The profiler at times drops a trace's device rows;
an incomplete trace is taken again with more host idle on both sides of
the window (``PADS``), and each incomplete try is logged on stderr."""

from __future__ import annotations

import bisect
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from d3h_bench import program
from d3h_bench.inputs import CACHE, log
from d3h_bench.loop import sync

PADS = (0.0, 0.05, 0.25, 1.0)
WINDOW = "d3h_bench.window"
STEP = "d3h_bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


class TraceIncomplete(RuntimeError):
    pass


def _ranges(events, name) -> List[Tuple[float, float]]:
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name)


def _inside(ranges: List[Tuple[float, float]], t: float) -> int:
    """Index of the range of ``ranges`` (sorted, disjoint) holding ``t``,
    or -1."""
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i if i >= 0 and ranges[i][0] <= t <= ranges[i][1] else -1


def _inside_any(ranges, t: float) -> bool:
    """``t`` in some range of ``ranges`` (sorted by start, may nest)."""
    i = bisect.bisect_right(ranges, (t, float("inf")))
    return any(s <= t <= e for s, e in ranges[max(0, i - 8):i])


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] (microseconds) in which some interval runs."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals)) * 1e-6


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float,
              host: List[Tuple[float, float, str]], top: int = 10):
    """[(host operation, idle seconds)] of the device's idle time in
    [lo, hi], each gap booked to the innermost host operation running at
    its start; the ``top`` largest."""
    starts = [h[0] for h in host]
    gaps, t = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    by_name: Dict[str, float] = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        name = "(none)"
        while i >= 0:
            s, e, n = host[i]
            if e >= g0:
                name = n
                break
            if g0 - s > 5e6:
                break
            i -= 1
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def reduce_trace(events: list, n_steps: int,
                 counts: Optional[Dict[str, int]]) -> Tuple[dict, List[str]]:
    """(record, what is missing) of one Chrome trace's events."""
    missing = []
    win = _ranges(events, WINDOW)
    if len(win) != 1:
        return {}, [f"{len(win)} window ranges"]
    lo, hi = win[0]
    steps = _ranges(events, STEP)
    knn = _ranges(events, program.KNN_SPAN)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and e["name"] in LAUNCHES and lo <= e["ts"] <= hi
              and "correlation" in e.get("args", {})}
    dev, kernels, seen = [], [], set()
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        if e["ts"] + e["dur"] < lo or e["ts"] > hi:
            continue
        dev.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] != "kernel":
            continue
        c = e.get("args", {}).get("correlation")
        t = launch.get(c)
        seen.add(c)
        kernels.append({"name": e["name"], "dur": e["dur"] * 1e-6,
                        "step": -1 if t is None else _inside(steps, t),
                        "knn": t is not None and _inside_any(knn, t)})
    lost = [c for c in launch if c not in seen]
    if lost:
        missing.append(f"{len(lost)} of {len(launch)} launches without "
                       "their kernel")
    if len(steps) != n_steps:
        missing.append(f"{len(steps)} step ranges of {n_steps}")
    per_step = [0] * len(steps)
    for k in kernels:
        if k["step"] >= 0:
            per_step[k["step"]] += 1
    if not kernels or min(per_step, default=0) == 0:
        missing.append(f"kernels a step {per_step}")
    for wrapper, names in program.COUNTED.items():
        if counts is None:
            continue
        got = sum(program.is_kernel(k["name"], names) for k in kernels)
        if got != counts[wrapper]:
            missing.append(f"{wrapper}: {got} kernels, {counts[wrapper]} "
                           "launches counted")
    busy = union(dev)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "cuda_runtime",
                                      "user_annotation")
                  and e.get("ph") == "X" and e["name"] not in (WINDOW, STEP))
    by_kernel: Dict[str, float] = {}
    for k in kernels:
        by_kernel[k["name"]] = by_kernel.get(k["name"], 0.0) + k["dur"]
    record = {"steps": n_steps, "window_s": (hi - lo) * 1e-6,
              "busy_s": busy_seconds(busy, lo, hi), "kernels": kernels,
              "breakdown": {
                  "device_ops": sorted(by_kernel.items(),
                                       key=lambda kv: -kv[1])[:10],
                  "idle_gaps": idle_gaps(busy, lo, hi, host)}}
    return record, missing


def _profiled(fn, cuda: bool, path: str) -> list:
    """The Chrome trace events of ``fn()`` under the Kineto profiler
    (driven through ``torch.autograd``'s own calls, which skip the Python
    post-processing of ``torch.profiler.profile``)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import ProfilerActivity, ProfilerConfig, ProfilerState

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda
                                     else set())
    torch.autograd._prepare_profiler(cfg, acts)
    torch.autograd._enable_profiler(cfg, acts)
    try:
        fn()
    finally:
        result = torch.autograd._disable_profiler()
    result.save(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    return events


def traced_window(loop, n_steps: int, device) -> dict:
    """The record of ``n_steps`` traced calls of ``loop.step`` (each
    ``loop.steps_per_call`` steps), from a trace checked complete (taken
    again with ``PADS`` of host idle around the window while it is
    not)."""
    from torch.profiler import record_function

    cuda = torch.device(device).type == "cuda"
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, "trace.json")

    def window(pad):
        time.sleep(pad)
        with record_function(WINDOW):
            for _ in range(n_steps):
                with record_function(STEP):
                    loop.step()
            sync(device)
        time.sleep(pad)

    for i, pad in enumerate(PADS):
        sync(device)
        program.reset_counts()
        with program.knn_spans():
            events = _profiled(lambda: window(pad), cuda, path)
        counts = program.read_counts() if cuda else None
        record, missing = reduce_trace(events, n_steps, counts)
        if record:
            record["steps"] = n_steps * loop.steps_per_call
        if not cuda:
            return record
        if not missing:
            record["tries"] = i + 1
            return record
        names = sorted({k["name"][:80] for k in record.get("kernels", ())
                        if program.is_kernel(k["name"],
                                             program.PORT_KERNELS)})
        log(f"trace: try {i + 1} of {len(PADS)} (host pad {pad} s) "
            f"incomplete: {'; '.join(missing)}; the port's kernels seen: "
            f"{names}")
    raise TraceIncomplete(f"no complete trace in {len(PADS)} tries")
