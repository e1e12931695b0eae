"""The port's body-model loaders against the JAX package's on the CPU:
``create`` for the five families of ``tests/test_body_model_families.py``
(SMPL, SMPL+H, SMPL-X, MANO, FLAME, each in its official npz layout,
the root's parent stored as uint32 -1) and ``load_smplx_npz``; the
tables exact, ``forward``'s vertices, joints and transforms within rel
1e-5; the lookup order and the errors."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# family -> (V, J, shape columns, expression columns at 300)
FAMILIES = {
    "smpl": (32, 24, 10, 0),
    "smplh": (32, 52, 16, 0),
    "smplx": (32, 55, 300, 50),
    "mano": (16, 16, 10, 0),
    "flame": (20, 5, 300, 100),
}
TABLES = ("v_template", "shapedirs", "posedirs", "J_regressor",
          "lbs_weights")


def _write_family_npz(path, V, J, n_shape, n_expr, seed=0):
    rng = np.random.default_rng(seed)
    parents = np.asarray([-1] + [(j - 1) // 2 for j in range(1, J)])
    kintree = np.stack([parents, np.arange(J)], 0).astype(np.int64)
    kintree[0, 0] = 2 ** 32 - 1            # as in the official files
    reg = rng.random((J, V)) ** 4
    w = rng.random((V, J)) ** 4
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path,
             v_template=rng.normal(size=(V, 3)).astype(np.float32) * 0.1,
             shapedirs=rng.normal(size=(V, 3, n_shape + n_expr)).astype(
                 np.float32) * 0.01,
             posedirs=rng.normal(size=(V, 3, (J - 1) * 9)).astype(
                 np.float32) * 1e-2,
             J_regressor=(reg / reg.sum(1, keepdims=True)).astype(np.float32),
             weights=(w / w.sum(1, keepdims=True)).astype(np.float32),
             f=rng.integers(0, V, (40, 3)).astype(np.int64),
             kintree_table=kintree)


def _inputs(jm, J, seed=1):
    rng = np.random.default_rng(seed)
    B = 2
    return dict(
        betas=rng.normal(size=(B, jm.num_betas)).astype(np.float32),
        root_pose=rng.normal(size=(B, 3)).astype(np.float32) * 0.3,
        body_pose=rng.normal(size=(B, max(J * 3 - 3, 3))).astype(
            np.float32) * 0.3,
        expression=rng.normal(size=(B, jm.num_expr)).astype(np.float32),
        transl=rng.normal(size=(B, 3)).astype(np.float32))


def _compare(m, jm, J):
    """Tables exact; forward within rel 1e-5 of the largest value."""
    assert (m.parents, m.num_betas, m.num_expr, m.num_verts,
            m.num_joints) == (jm.parents, jm.num_betas, jm.num_expr,
                              jm.num_verts, jm.num_joints)
    for k in TABLES:
        np.testing.assert_array_equal(getattr(m, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    np.testing.assert_array_equal(m.faces, jm.faces)
    x = _inputs(jm, J)
    want = jm.forward(**{k: jnp.asarray(v) for k, v in x.items()})
    got = m.forward(**{k: torch.from_numpy(v) for k, v in x.items()})
    for name, g, w in zip(("verts", "joints", "A"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_create_matches_jax(family, tmp_path):
    from d3human_tpu.models.smplx.model import create as jcreate
    from d3human_tpu_torch.models.smplx.model import create

    V, J, n_shape, n_expr = FAMILIES[family]
    gender = "right" if family == "mano" else "neutral"
    _write_family_npz(str(tmp_path / family
                          / f"{family.upper()}_{gender.upper()}.npz"),
                      V, J, n_shape, n_expr)
    m = create(str(tmp_path), family, gender, device="cpu")
    assert m.parents[0] == -1 and m.num_joints == J
    _compare(m, jcreate(str(tmp_path), family, gender), J)


def test_load_smplx_npz_matches_jax(tmp_path):
    """The SMPL-X reader keeps the stored root parent (as JAX does) and
    cuts the 350 columns to 100 shape + 50 expression."""
    from d3human_tpu.models.smplx.model import load_smplx_npz as jload
    from d3human_tpu_torch.models.smplx.model import load_smplx_npz

    V, J, n_shape, n_expr = FAMILIES["smplx"]
    _write_family_npz(str(tmp_path / "SMPLX_FEMALE.npz"), V, J, n_shape,
                      n_expr)
    m = load_smplx_npz(str(tmp_path), "female", device="cpu")
    assert m.shapedirs.shape == (V, 3, 150) and m.num_expr == 50
    _compare(m, jload(str(tmp_path), "female"), J)


def test_create_flat_layout_and_errors(tmp_path):
    """The flat layout after ``<model_type>/``; an unknown family and a
    missing file raise as in JAX; explicit widths win."""
    from d3human_tpu.models.smplx.model import create as jcreate
    from d3human_tpu_torch.models.smplx.model import create

    V, J, n_shape, n_expr = FAMILIES["smpl"]
    _write_family_npz(str(tmp_path / "SMPL_NEUTRAL.npz"), V, J, n_shape,
                      n_expr)
    m = create(str(tmp_path), "smpl", "neutral", num_betas=4, device="cpu")
    assert m.num_betas == 4
    _compare(m, jcreate(str(tmp_path), "smpl", "neutral", num_betas=4), J)
    with pytest.raises(ValueError, match="nope"):
        create(str(tmp_path), "nope", device="cpu")
    with pytest.raises(FileNotFoundError, match="FLAME_NEUTRAL.npz"):
        create(str(tmp_path), "flame", "neutral", device="cpu")
