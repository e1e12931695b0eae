"""Training-frame order (counterpart of ``shuffled_indexer`` in
``d3human_tpu/data/dataset.py``; the capture loaders are not ported)."""

from __future__ import annotations

import numpy as np


def shuffled_indexer(n_frames: int, seed: int = 0):
    """it -> frame: a fresh random permutation of the frames each epoch,
    as the reference's shuffling DataLoader gives (train.py:585). The
    permutation of epoch e is numpy's ``default_rng((seed, e))``, so it
    depends only on (seed, e): a resumed run replays the same order, and
    the order is the JAX package's."""
    state = {"epoch": -1, "perm": None}

    def fn(it: int) -> int:
        ep, off = divmod(int(it), n_frames)
        if ep != state["epoch"]:
            state["perm"] = np.random.default_rng(
                (seed, ep)).permutation(n_frames)
            state["epoch"] = ep
        return int(state["perm"][off])

    return fn
