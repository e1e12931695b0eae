"""The port's bench (``d3human_tpu_torch/bench.py``) against the
repository's JAX ``bench.py``, imported as it is, at the small scale with a
short capsule seed on both sides: ``build`` field by field (config, lattice,
capsule target, mSDF, target dict, camera) for the init and the split
stage, one init step and one ``BENCH_FWDONLY`` tick of each package from
the JAX bench's parameters with the JAX draws injected, and every config
attribute chain the port's bench reads."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from torch_parity import (
    BENCH_COUNT, bench_key, bench_scalars, build_both, compare_scalars,
    compare_step, init_draws, jax_state_at, port_cfg_of, port_state_from_jax,
    to_numpy,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tet_cache")
    return {stage: build_both(tmp, BENCH_STAGE=stage)
            for stage in ("init", "split")}


@pytest.mark.parametrize("stage", ["init", "split"])
def test_build_matches_jax(builds, stage):
    """Config field by field, the cropped lattice exact, the capsule target
    and the mSDF within 1e-6, the target dict bit for bit, the camera
    within 1e-6."""
    (jstate, _, jtarget, jex), (pstate, _, ptarget, pex), caps = \
        builds[stage]
    want_cfg = port_cfg_of(jex["cfg"])
    for f in dataclasses.fields(want_cfg):
        assert getattr(pex["cfg"], f.name) == getattr(want_cfg, f.name), \
            f.name
    assert pex["stage"] == jex["stage"] == stage
    assert pex["grid_crop"] == jex["grid_crop"] == 0.1
    jg, pg = jex["model"].grid, pex["model"].grid
    assert tuple(pg.dims) == tuple(jg.dims)
    for k in ("verts", "tets", "edges", "tet_edges"):
        np.testing.assert_array_equal(to_numpy(getattr(pg, k)),
                                      np.asarray(getattr(jg, k)), err_msg=k)
    np.testing.assert_allclose(caps["port"], caps["jax"], rtol=0, atol=1e-6)
    assert (caps["jax"] > 0).sum() > 100          # a surface in the lattice
    np.testing.assert_allclose(to_numpy(pstate.params["geometry"]["msdf"]),
                               np.asarray(jstate.params["geometry"]["msdf"]),
                               rtol=0, atol=1e-6)
    assert set(ptarget) == set(jtarget)
    assert ptarget["frame_idx"] == int(jtarget["frame_idx"]) == 0
    for k, v in jtarget.items():
        if k != "frame_idx":
            np.testing.assert_array_equal(to_numpy(ptarget[k]), np.asarray(v),
                                          err_msg=k)
    for k in ("mvp", "campos"):
        np.testing.assert_allclose(to_numpy(getattr(pex["scene"], k)),
                                   np.asarray(jtarget[k]), rtol=0,
                                   atol=1e-6)
    assert tuple(pex["scene"].resolution) == (256, 256)


def test_init_step_matches_jax(builds):
    """One init step of each bench from the JAX bench's parameters at the
    optimizer count of its first timed step, the JAX draws of that step
    injected: scalars rel 5e-3, every leaf's gradient rel-L2 1e-3 and the
    parameters after the step as ``compare_step`` holds them; the SDF, the
    deformation and the pose moved."""
    from d3human_tpu_torch.train.optim import named_leaves

    (jstate, jstep, jtarget, jex), (_, pstep, ptarget, pex), _ = \
        builds["init"]
    key = bench_key()
    state = port_state_from_jax("init", jstate, jex, pex, BENCH_COUNT)
    before = {k: v.clone() for k, v in named_leaves(state.params)}
    state, m = pstep(state, ptarget, None,
                     draws=init_draws(jex["cfg"], key))
    jnew, jaux = jstep(jax_state_at(jstate, BENCH_COUNT), jtarget, key)
    got = bench_scalars(m)
    compare_scalars(got, bench_scalars(jax.device_get(jaux)))
    assert got["n_cross"] > 0 and 0 < got["cap_cov"] < 1
    assert {"sdf_net", "deform", "pose"} <= compare_step(
        state, before, jnew, grad_tol=1e-3)


def test_fwdonly_tick_matches_jax(tmp_path):
    """BENCH_FWDONLY=1: the loss tick alone, from the JAX bench's
    parameters with its draws: every scalar rel 5e-3 (counters exact), and
    neither package's state moves."""
    from d3human_tpu_torch.train.optim import named_leaves

    (jstate, jstep, jtarget, jex), (_, pstep, ptarget, pex), _ = build_both(
        tmp_path, BENCH_STAGE="init", BENCH_FWDONLY="1")
    key = bench_key()
    state = port_state_from_jax("init", jstate, jex, pex, BENCH_COUNT)
    before = {k: v.clone() for k, v in named_leaves(state.params)}
    out, m = pstep(state, ptarget, None, draws=init_draws(jex["cfg"], key))
    jout, jaux = jstep(jax_state_at(jstate, BENCH_COUNT), jtarget, key)
    assert out is state and out.step == BENCH_COUNT and out.opt.count == \
        BENCH_COUNT
    assert all(torch.equal(t, before[k])
               for k, t in named_leaves(state.params))
    assert int(jout.step) == BENCH_COUNT
    compare_scalars(bench_scalars(m), bench_scalars(jax.device_get(jaux)))
    assert not any(t.requires_grad for t in m.values()
                   if isinstance(t, torch.Tensor))


def _chains(tree):
    """Attribute chains rooted at ``Config()``, at a name ``cfg`` or at a
    subscript ``[...]["cfg"]``: [(root, [attr, ...])]."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        chain, cur = [], node
        while isinstance(cur, ast.Attribute):
            chain.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Call) and isinstance(cur.func, ast.Name) \
                and cur.func.id == "Config":
            yield "Config()", chain[::-1]
        elif isinstance(cur, ast.Name) and cur.id == "cfg":
            yield "cfg", chain[::-1]
        elif isinstance(cur, ast.Subscript) and isinstance(
                cur.slice, ast.Constant) and cur.slice.value == "cfg":
            yield "extras['cfg']", chain[::-1]


def test_bench_config_attribute_paths_exist():
    """The counterpart of test_bench_guard's check: every config attribute
    chain in the port's bench.py exists on the port's default Config."""
    from d3human_tpu_torch.config import Config

    tree = ast.parse((ROOT / "d3human_tpu_torch" / "bench.py").read_text())
    cfg, checked = Config(), 0
    for root, chain in _chains(tree):
        obj = cfg
        for attr in chain:
            if callable(getattr(type(obj), attr, None)):
                break                    # a method such as Config.replace
            assert hasattr(obj, attr), f"{root}.{'.'.join(chain)}"
            obj = getattr(obj, attr)
        checked += 1
    assert checked >= 5
