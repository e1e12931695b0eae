"""The port's bench against the repository's JAX ``bench.py`` (imported as
it is) at the small scale, the split and the seq stage: one split step of
each bench from the JAX bench's parameters with the JAX draws injected,
and ``build_seq("small")``: config, template exact, frame 0's target, one
seq step. (``test_torch_bench.py`` holds ``build`` and the init step; the
two files run on separate workers.)"""

import numpy as np
import pytest
import torch

import jax

from torch_parity import (
    BENCH_COUNT, bench_env, bench_key, bench_scalars, build_both,
    compact_draw_shapes, compare_scalars, compare_step, jax_bench,
    jax_state_at, port_cfg_of, port_state_from_jax, render_draws,
    split_draws, to_numpy,
)

torch.set_num_threads(1)

# The texture's hash tables start at ~1e-4, so the bench's texture is
# nearly constant and the material-smoothness term |kd(p + jitter) -
# kd(p)| sits at float32 noise: its value agrees to 1e-7, but the signs of
# its gradient are noise (the term's table gradient differs by 3 % rel-L2
# between the packages, the image terms' by 2e-5), and Adam's step follows
# those signs. test_torch_split_step.py holds the tables' gradients where
# the texture carries signal.
TEX_NOISE = ("material/encoder/table",)
TEMPLATE_FIELDS = ("v", "f", "v_labels", "face_labels", "body_vidx",
                   "cloth_vidx", "body_f", "connected_faces")


def test_split_step_matches_jax(tmp_path):
    """One split step (both halves) of each bench from the JAX bench's
    parameters at the optimizer count of its first timed step, the JAX
    draws injected: scalars rel 5e-3, the parameters after the step as
    ``compare_step`` holds them but the texture's hash tables (TEX_NOISE);
    the mSDF, the deformation, the texture and the pose moved."""
    from d3human_tpu_torch.train.optim import named_leaves

    (jstate, jstep, jtarget, jex), (_, pstep, ptarget, pex), _ = build_both(
        tmp_path, BENCH_STAGE="split")
    state = port_state_from_jax("split", jstate, jex, pex, BENCH_COUNT)
    before = {k: v.clone() for k, v in named_leaves(state.params)}
    state, m = pstep(state, ptarget, None,
                     draws=split_draws(jex["cfg"], bench_key()))
    jnew, jaux = jstep(jax_state_at(jstate, BENCH_COUNT), jtarget,
                       bench_key())
    got = bench_scalars(m)
    compare_scalars(got, bench_scalars(jax.device_get(jaux)))
    for half in ("cloth", "body"):
        assert got[f"{half}_n_cross"] > 0
        assert 0 < got[f"{half}_cap_cov"] < 1
    assert {"msdf", "deform", "material", "pose"} <= compare_step(
        state, before, jnew, noise=TEX_NOISE)


@pytest.fixture(scope="module")
def seq_builds():
    from d3human_tpu_torch import bench as pbench

    with pytest.MonkeyPatch.context() as mp:
        bench_env(mp)
        j = jax_bench().build_seq("small")
        p = pbench.build_seq("small", "cpu")
    return j, p


def test_build_seq_matches_jax(seq_builds):
    """The seq config field by field, the template's arrays exact (the
    body subdivided twice, faces labelled by height), frame 0's target
    from the oracle rasterizer (masks exact, buffers abs 1e-4: a
    sliver's interpolated colour differs by up to 2e-5)."""
    (_, jstep, jtarget, jex), (_, _, ptarget, pex) = seq_builds
    assert pex["cfg"] == port_cfg_of(jex["cfg"])
    jt, pt = jstep.consts["template"], pex["template"]
    for k in TEMPLATE_FIELDS:
        np.testing.assert_array_equal(to_numpy(getattr(pt, k)),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    assert pt.w_pts is None and jt.w_pts is None
    assert pt.f.shape[0] == 552 * 4 ** 2
    assert ptarget["frame_idx"] == int(jtarget["frame_idx"]) == 0
    for k in ("all_img", "cloth_img", "body_img", "all_normal",
              "cloth_normal", "body_normal", "mvp", "campos"):
        np.testing.assert_allclose(to_numpy(ptarget[k]),
                                   np.asarray(jtarget[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(to_numpy(ptarget["all_img"][..., 3]),
                                  np.asarray(jtarget["all_img"][..., 3]))
    assert to_numpy(ptarget["all_img"][..., 3]).sum() > 1000


def test_seq_step_matches_jax(seq_builds):
    """One seq step of each bench from the JAX bench's parameters at the
    optimizer count of its first timed step, the render's JAX draws
    injected: scalars rel 5e-3, the parameters after the step as
    ``compare_step`` holds them but the texture's hash tables (TEX_NOISE;
    no bound on the gradients either: the collision term, weighted 1e5,
    picks another nearest body face on near-ties, and its nonrigid
    gradients differ by ~5 % rel-L2); the nonrigid MLP and the texture
    moved."""
    from d3human_tpu.models.perceptual import ConvPerceptual
    from d3human_tpu_torch.train.optim import named_leaves

    (jstate, jstep, jtarget, jex), (_, pstep, ptarget, pex) = seq_builds
    # the JAX seq bench keeps its perceptual filters inside its step: the
    # same seeded init
    jex = dict(jex, perc_params=ConvPerceptual().init())
    state = port_state_from_jax("seq", jstate, jex, pex, BENCH_COUNT)
    before = {k: v.clone() for k, v in named_leaves(state.params)}
    draws = {"render": render_draws(bench_key(),
                                    *compact_draw_shapes(jex["cfg"]))}
    state, m = pstep(state, ptarget, None, draws=draws)
    jnew, jaux = jstep(jax_state_at(jstate, BENCH_COUNT), jtarget,
                       bench_key())
    got = bench_scalars(m)
    compare_scalars(got, bench_scalars(jax.device_get(jaux)))
    assert 0 < got["cap_cov"] < 1
    assert {"nonrigid", "material"} <= compare_step(state, before, jnew,
                                                    noise=TEX_NOISE)

