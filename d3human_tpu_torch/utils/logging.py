"""Scalar logging, per-step timing and profiler spans (counterpart of
``d3human_tpu/utils/logging.py``): scalars stream to ``scalars.jsonl`` in
the JAX package's line format (there is no tensorboard writer here); the
step timer synchronises the device only in ``flush``; ``span`` names a
range of the program in a running profiler's trace."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


class ScalarLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self.flush()
        self._f.close()


class StepTimer:
    """Wall-clock time per iteration over windows: ``lap`` counts an
    iteration without waiting for the device; ``flush`` waits for it and
    spreads the window's time over its laps (ref train.py:789-790,
    :805-806)."""

    def __init__(self, window: int = 10):
        self.window = window
        self.durations: List[float] = []
        self._t0 = None
        self._laps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._laps = 0

    def lap(self) -> None:
        self._laps += 1

    def flush(self, result: Optional[torch.Tensor] = None) -> None:
        """Synchronise the device of ``result`` (if it is a CUDA tensor)
        and book the window's elapsed time."""
        if self._laps == 0:
            return
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        dt = (time.perf_counter() - self._t0) / self._laps
        self.durations.extend([dt] * self._laps)
        self._t0 = time.perf_counter()
        self._laps = 0

    @property
    def avg_ms(self) -> float:
        if not self.durations:
            return 0.0
        return float(np.mean(self.durations[-self.window:]) * 1000)

    def eta(self, remaining_iters: int) -> str:
        secs = remaining_iters * (self.avg_ms / 1000)
        m, s = divmod(int(secs), 60)
        h, m = divmod(m, 60)
        return f"{h:d}:{m:02d}:{s:02d}"


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` in the trace of a running profiler
    (``torch.profiler`` or the Kineto profiler under it), stamped on the
    clock of the device's kernels and copies; without one, a shared null
    context, so the program pays one check a span."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
