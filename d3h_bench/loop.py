"""The benchmark's own copy of the port's stage loop
(``train/stages.py:run_stage`` / ``run_seq_stage``): each iteration gets
its frame's target and a generator seeded by ``fold_in(stage seed,
iteration)``; the host waits for the device every ``SYNC_EVERY``
iterations and reads the scalars back every ``log_interval``. Checkpoints
and validations are left out."""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

SYNC_EVERY = 10


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed from (seed, data), independent across ``data``."""
    return int(np.random.SeedSequence([seed & (2 ** 63 - 1), data])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def iteration_generator(seed: int, it: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold_in(seed, it))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def read_scalars(metrics: dict) -> dict:
    """The 0-d entries of a step's metrics, read back in one copy."""
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0]
    if not keys:
        return {}
    vals = torch.stack([metrics[k].detach().float() for k in keys]).cpu()
    return dict(zip(keys, vals.tolist()))


class Loop:
    """One stage's iterations on one train state: ``target(it)`` gives
    iteration ``it``'s target; ``totals`` keeps every step's loss on the
    device (read once, at the end)."""

    steps_per_call = 1

    def __init__(self, step_fn: Callable, state, target: Callable[[int], dict],
                 stage_seed: int, device, log_interval: int):
        self.step_fn = step_fn
        self.state = state
        self.target = target
        self.seed = stage_seed
        self.device = device
        self.log_interval = log_interval
        self.it = 0
        self.totals: List[torch.Tensor] = []
        self.last_scalars: dict = {}

    def step(self, dispatch: Optional[list] = None) -> dict:
        it = self.it
        target = self.target(it)
        gen = iteration_generator(self.seed, it, self.device)
        t0 = time.perf_counter()
        self.state, aux = self.step_fn(self.state, target, gen)
        if dispatch is not None:
            dispatch.append(time.perf_counter() - t0)
        self.totals.append(aux["total"].detach())
        if it % SYNC_EVERY == 0 or it % self.log_interval == 0:
            sync(self.device)
        if it % self.log_interval == 0:
            self.last_scalars = read_scalars(aux)
        self.it += 1
        return aux

    def window(self, seconds: float, dispatch: Optional[list] = None):
        """Steps until ``seconds`` have passed on the host's clock, between
        two device synchronisations. Returns (steps, seconds)."""
        sync(self.device)
        it0 = self.it
        t0 = time.perf_counter()
        while True:
            self.step(dispatch)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        return self.it - it0, time.perf_counter() - t0
