"""The port's rasterizer is exact: no tile list and no list of oversize
faces is cut, however long.

Held to the benchmark's plain reference (``d3h_bench/reference``, plain
PyTorch with no capacity) and to the oracle ``rasterize_bruteforce``, in
scenes whose lists pass the 1,024 slots of the JAX package's Pallas
kernel and whose oversize faces pass its shared list of 128; and an init
step, port against reference, in a scene whose lists pass the old cut of
896 faces a tile, where the reference cut as the old binning cut fails
the benchmark's limits."""

import json
import os

import numpy as np
import pytest
import torch

from d3human_tpu_torch.ops import raster_resolve
from d3human_tpu_torch.ops.rasterizer import rasterize, rasterize_bruteforce

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "d3h_bench")


def _long_lists(seed=0, n_small=1100, n_big=150):
    """Clip-space corners and faces at 8 x 32 pixels (two tiles of 8 x 16):
    ``n_small`` faces inside the left tile, ``n_big`` across both (with
    ``bin_expand`` 1 they are oversize). Screen corners lie on a grid of a
    quarter pixel across and a sixteenth down, so every edge function is
    exact in float32 whatever the order of its operations, and each face
    is flat at a depth of its own, 100 quantization steps from the next:
    no two faces tie, in float or quantized depth."""
    rng = np.random.default_rng(seed)
    F = n_small + n_big
    x0 = rng.integers(0, 15 * 4, (n_small, 1)) / 4
    y0 = rng.integers(0, 7 * 16, (n_small, 1)) / 16
    dx = rng.integers(1, 4 * 4, (n_small, 3)) / 4
    dy = rng.integers(1, 4 * 16, (n_small, 3)) / 16
    sx = np.concatenate([x0, np.minimum(x0 + dx[:, :1], 15.75),
                         np.minimum(x0 + dx[:, 1:2], 15.75)], 1)
    sy = np.concatenate([y0, y0, np.minimum(y0 + dy[:, 2:], 7.9375)], 1)
    bx = np.stack([rng.integers(0, 14 * 4, n_big) / 4,
                   rng.integers(18 * 4, 32 * 4, n_big) / 4,
                   rng.integers(0, 32 * 4, n_big) / 4], 1)
    by = rng.integers(0, 8 * 16, (n_big, 3)) / 16
    sx, sy = np.concatenate([sx, bx]), np.concatenate([sy, by])
    # screen -> clip (w = 1): x = (ndc / 2 + 1/2) * 32, y = (1/2 - ndc / 2) * 8
    ndc_x, ndc_y = sx / 16 - 1, 1 - sy / 4
    z = (-0.5 + rng.permutation(F) * (100 / (0.5 * raster_resolve.Z_SCALE)))
    clip = np.stack([ndc_x, ndc_y, np.repeat(z[:, None], 3, 1),
                     np.ones((F, 3))], -1).astype(np.float32)
    faces = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    return (torch.as_tensor(clip.reshape(3 * F, 4)), torch.as_tensor(faces),
            torch.ones(F, dtype=torch.bool))


def _quantized(z):
    """A float depth as the binned rasterizer's key carries it."""
    zq = torch.clamp((z + 1.0) * (0.5 * raster_resolve.Z_SCALE), 0.0,
                     raster_resolve.Z_SCALE).to(torch.int64)
    return torch.where(z > 1e38, z, zq.float() / (0.5 * raster_resolve.Z_SCALE)
                       - 1.0)


@pytest.mark.parametrize("layers", [1, 3])
def test_rasterize_equals_reference_and_oracle_at_long_lists(layers):
    """A tile list of more than 1,024 faces and more than 128 live
    oversize faces: ``tri_id`` equal to the benchmark's reference (one
    layer) and to the oracle (every layer of a depth peel), ``zbuf``
    equal to theirs, the oracle's float depth put on the key's grid."""
    from d3h_bench.reference.ops import rasterizer as ref

    v, f, fv = _long_lists()
    opts = dict(tile=(8, 16), bin_expand=1)
    got = rasterize(v, f, fv, (8, 32), layers=layers, **opts)
    got = (got,) if layers == 1 else got
    assert int(got[0].n_max_tile) > 1024 and int(got[0].n_big) > 128
    oracle = rasterize_bruteforce(v, f, fv, (8, 32), layers=layers)
    oracle = (oracle,) if layers == 1 else oracle
    for a, o in zip(got, oracle):
        assert torch.equal(a.tri_id, o.tri_id)
        assert torch.equal(a.zbuf, _quantized(o.zbuf))
    hits = [int((a.tri_id > 0).sum()) for a in got]
    assert hits[0] > 200 and all(h > 0 for h in hits)
    # winners from past the Pallas kernel's 1,024 slots and from the
    # shared list both
    order = ref.rasterize(v, f, fv, (8, 32), **opts)
    if layers == 1:
        assert torch.equal(got[0].tri_id, order.tri_id)
        assert torch.equal(got[0].zbuf, order.zbuf)
        assert int(order.n_max_tile) == int(got[0].n_max_tile)
        assert int(order.n_big) == int(got[0].n_big)
    cut = ref.rasterize(v, f, fv, (8, 32), truncate=True, **opts)
    assert not torch.equal(cut.tri_id, got[0].tri_id)


def _dense_cell(root):
    """A CPU-sized init cell whose tile lists pass the old cut of 896
    faces (a finer lattice, a narrower SDF MLP than the benchmark's, 48²),
    limited as the benchmark's ``f3c.init``; its files under ``root``."""
    with open(os.path.join(BENCH, "tests", "data", "configs",
                           "tiny.json")) as fh:
        cfg = json.load(fh)
    cfg.update(gshell_grid=32, train_res=[48, 48], texture_res=[48, 48])
    cfg["field"]["d_hidden"] = 64
    cfg["geometry"].update(max_verts=32768, max_tets=32768)
    cfg["bench"]["cache_name"] = "tiny_dense_32"
    with open(os.path.join(BENCH, "workloads", "f3c.init.json")) as fh:
        limits = json.load(fh)["limits"]
    with open(os.path.join(BENCH, "tests", "data", "traffic",
                           "init.json")) as fh:
        traffic = json.load(fh)
    files = {"configs/tiny_dense.json": cfg, "traffic/init.json": traffic,
             "workloads/tiny_dense.init.json": dict(
                 config="tiny_dense", traffic="init", chips=1,
                 why="CPU test", limits=limits)}
    for name, data in files.items():
        os.makedirs(os.path.join(root, os.path.dirname(name)), exist_ok=True)
        with open(os.path.join(root, name), "w") as fh:
            json.dump(data, fh)
    return limits


@pytest.fixture(scope="module")
def dense_step(tmp_path_factory, monkeypatch_module):
    """The port's first init step on the dense cell, recorded as the
    benchmark records it (``check.Record``, one step), its inputs and the
    parameters it started from."""
    from d3h_bench import check, program, registry
    from d3h_bench.inputs import make_inputs
    from d3h_bench.loop import Loop
    from d3h_bench.reference.model import target_fn

    root = str(tmp_path_factory.mktemp("cells"))
    limits = _dense_cell(root)
    monkeypatch_module.setattr(check, "CHECK_STEPS", 1)
    torch.manual_seed(0)
    cell = registry.workload("tiny_dense.init", root)
    cpu = torch.device("cpu")
    inputs = make_inputs(cell, 2 ** 33 + 17, cpu)
    start = {p: t.detach().clone() for p, t in check.leaves(inputs.params)}
    state, step_fn = program.build(inputs, cell["config_file"], cpu)
    loop = Loop(step_fn, state, target_fn(inputs), inputs.seeds["stage"],
                cpu, inputs.cfg.stages.log_interval)
    prog = check.Record()
    prog.take(loop, start)
    assert loop.last_scalars["n_max_tile"] > 2 * 896
    return dict(inputs=inputs, start=start, prog=prog, limits=limits)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_init_step_past_the_old_cut_matches_the_reference(dense_step):
    """The port's init step, lists of more than twice 896 faces, within
    ``f3c.init``'s limits of the reference without a capacity."""
    from d3h_bench import check

    d = dense_step
    ref = check.reference_record(d["inputs"], d["start"],
                                 torch.device("cpu"))
    gaps, _ = check.gaps(d["prog"], ref)
    assert check.verdict(gaps, d["limits"]), gaps


def test_init_step_past_the_old_cut_fails_the_truncated_reference(
        dense_step):
    """The reference cut as the old binning cut (896 faces a tile, 128
    oversize ones) fails the same limits: the cut is what the check
    sees."""
    from d3h_bench import check

    d = dense_step
    ref = check.reference_record(d["inputs"], d["start"],
                                 torch.device("cpu"), {"truncate": True})
    gaps, _ = check.gaps(d["prog"], ref)
    assert not check.verdict(gaps, d["limits"]), gaps
