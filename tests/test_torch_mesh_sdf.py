"""The port's K-nearest search, mesh SDF, native engine and field set-up
against the JAX package (CPU, plain kernel versions), and the two repairs
of the port: the SMPL-X offsets and the chunked SDF query with the JAX
package's default ``geometry.sdf_chunk``. Inputs come from one numpy seed
and go through both sides."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_pipeline import icosphere
from torch_parity import jax_small, load_jax_engine, port_small, to_np

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    j = jax_small()
    return j, port_small(j)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat_layers(net):
    return np.concatenate([np.asarray(_np(lay[k])).reshape(-1)
                           for lay in net["layers"] for k in ("w", "b")])


# ---------------------------------------------------------------- knn

def _tied_sets(M, seed):
    """Refs on a coarse lattice (exact in float32, many equal distances),
    each point twice at two indices, and queries on the same lattice (some
    on a ref: distance exactly 0 to both twins)."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-3, 4, (M // 2, 3)).astype(np.float32) * 0.25
    ref = np.concatenate([half, half[rng.permutation(len(half))]])
    if len(ref) < M:
        ref = np.concatenate([ref, ref[:M - len(ref)]])
    q = rng.integers(-4, 5, (70, 3)).astype(np.float32) * 0.25
    q[:10] = ref[rng.integers(0, M, 10)]
    valid = rng.random(M) > 0.2
    return q, ref, valid


@pytest.mark.parametrize("valid_mask", [False, True])
@pytest.mark.parametrize("M", [64, 160])      # 1 and 3 blocks of 64 refs
@pytest.mark.parametrize("k", [1, 8])
def test_knn_matches_jax_with_ties(k, M, valid_mask):
    """Indices equal (ties: the lower index first), distances abs 1e-6
    (+inf at the same places), the gradient of a weighted sum of the
    distances rel-L2 1e-5 for the queries and the refs."""
    from d3human_tpu.ops.knn import knn as jknn
    from d3human_tpu_torch.ops.knn import knn

    q, ref, valid = _tied_sets(M, seed=k + M)
    valid = valid if valid_mask else None
    w = np.random.default_rng(1).uniform(0.5, 1.5, (len(q), k)).astype(
        np.float32)

    def jloss(q, r):
        sq, idx = jknn(q, r, k=k, block=64,
                       ref_valid=None if valid is None else jnp.asarray(
                           valid))
        return jnp.sum(jnp.where(jnp.isfinite(sq), sq * w, 0.0)), (sq, idx)

    (jg_q, jg_r), (jsq, jidx) = jax.grad(jloss, argnums=(0, 1),
                                         has_aux=True)(jnp.asarray(q),
                                                       jnp.asarray(ref))
    tq = torch.as_tensor(q).requires_grad_(True)
    tr = torch.as_tensor(ref).requires_grad_(True)
    sq, idx = knn(tq, tr, k=k, block=64,
                  ref_valid=None if valid is None else torch.as_tensor(valid))
    torch.where(torch.isfinite(sq), sq * torch.as_tensor(w), 0.0).sum() \
        .backward()
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    jsq = np.asarray(jsq)
    assert (np.isinf(_np(sq)) == np.isinf(jsq)).all()
    fin = np.isfinite(jsq)
    np.testing.assert_allclose(_np(sq)[fin], jsq[fin], rtol=0, atol=1e-6)
    # the lattice makes exact ties: the test sees them
    d = np.sort(((q[:, None] - ref[None]) ** 2).sum(-1), axis=1)[:, :k + 1]
    assert (np.diff(d, axis=1) == 0).any()
    for got, want in ((tq.grad, jg_q), (tr.grad, jg_r)):
        assert _rel_l2(_np(got), np.asarray(want)) <= 1e-5


def test_knn_k1_equals_knn1():
    from d3human_tpu_torch.ops.knn import knn, knn1

    q, ref, _ = _tied_sets(160, seed=3)
    sq, idx = knn(torch.as_tensor(q), torch.as_tensor(ref), k=1, block=64)
    sq1, idx1 = knn1(torch.as_tensor(q), torch.as_tensor(ref), block=64)
    assert torch.equal(idx[:, 0], idx1) and torch.equal(sq[:, 0], sq1)


def test_knn_scratch_is_bounded(monkeypatch):
    """The query blocks hold at most SCRATCH_ELEMS distances each, and the
    answer does not depend on them."""
    from d3human_tpu_torch.ops import knn as K

    q, ref, valid = _tied_sets(160, seed=4)
    want = K.knn(torch.as_tensor(q), torch.as_tensor(ref), k=8, block=64,
                 ref_valid=torch.as_tensor(valid))
    monkeypatch.setattr(K, "SCRATCH_ELEMS", 64 * 20)
    seen = []
    real = torch.Tensor.addmm_

    def spy(d, *a, **kw):
        seen.append(d.numel())
        return real(d, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "addmm_", spy)
    got = K.knn(torch.as_tensor(q), torch.as_tensor(ref), k=8, block=64,
                ref_valid=torch.as_tensor(valid))
    assert max(seen) <= 64 * 20 and len(seen) > 3
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# ---------------------------------------------------------------- mesh SDF

def _sdf_cases():
    from d3human_tpu_torch.models.smplx.model import synthetic_body_model
    from d3human_tpu_torch.ops.tet_grid import make_tet_grid

    rng = np.random.default_rng(0)
    v, f = icosphere(radius=0.5, n=2)
    pts = rng.uniform(-0.8, 0.8, (1500, 3)).astype(np.float32)
    body = synthetic_body_model(device="cpu")
    bv = _np(body.v_template)
    grid = make_tet_grid(res=12, bounds=((-0.6, -0.8, -0.4),
                                         (0.6, 0.8, 0.4)),
                         y_offset=0.0, scale=1.0, device="cpu")
    return {"icosphere": (pts, v, f),
            "synthetic body": (_np(grid.verts), bv, np.asarray(body.faces))}


@pytest.mark.parametrize("case", ["icosphere", "synthetic body"])
@pytest.mark.parametrize("conv", ["neg_inside", "pos_inside"])
def test_mesh_sdf_matches_jax(case, conv):
    """abs 1e-6, signs equal where |sdf| > 1e-4; in blocks of 500 points
    on both sides (the lattice case: 2,197 points, 5 blocks)."""
    from d3human_tpu.ops.mesh_sdf import mesh_sdf as jsdf
    from d3human_tpu_torch.ops.mesh_sdf import mesh_sdf

    pts, v, f = _sdf_cases()[case]
    want = np.asarray(jsdf(jnp.asarray(pts), jnp.asarray(v),
                           jnp.asarray(f, jnp.int32), k=8,
                           sign_convention=conv, block=500))
    got = _np(mesh_sdf(torch.as_tensor(pts), torch.as_tensor(v),
                       torch.as_tensor(f), k=8, sign_convention=conv,
                       block=500))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    far = np.abs(want) > 1e-4
    assert (np.sign(got[far]) == np.sign(want[far])).all()
    assert (want > 0).any() and (want < 0).any()


def test_point_triangle_matches_jax():
    """Every Voronoi region of the closest-point routine: points around
    random triangles, closest points and squared distances abs 1e-6."""
    from d3human_tpu.ops.mesh_sdf import _point_triangle as jpt
    from d3human_tpu_torch.ops.mesh_sdf import _point_triangle

    rng = np.random.default_rng(5)
    tri = rng.standard_normal((400, 3, 3)).astype(np.float32)
    p = rng.standard_normal((400, 3)).astype(np.float32) * 2
    want = jpt(*(jnp.asarray(a) for a in (p, tri[:, 0], tri[:, 1],
                                          tri[:, 2])))
    got = _point_triangle(*(torch.as_tensor(a) for a in (
        p, tri[:, 0], tri[:, 1], tri[:, 2])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def jax_engine():
    """The JAX package's committed library, loaded as it is (never
    rebuilt)."""
    return load_jax_engine()[0]


@pytest.mark.parametrize("conv", ["neg_inside", "pos_inside", "unsigned"])
def test_native_engine_equals_jax_engine(jax_engine, conv):
    """Same source, same flags: distances, closest points and faces equal
    bit for bit, on a watertight sphere and on an open random soup, with 1
    and 4 threads."""
    from d3human_tpu_torch.native.meshsdf import MeshSDF

    rng = np.random.default_rng(6)
    sv, sf = icosphere(radius=0.5, n=3)
    soup_v = rng.standard_normal((80, 3)).astype(np.float32)
    soup_f = rng.integers(0, 80, (60, 3))
    p = rng.uniform(-1.2, 1.2, (3000, 3)).astype(np.float32)
    for v, f in ((sv, sf), (soup_v, soup_f)):
        for threads in (1, 4):
            want = jax_engine.MeshSDF(v, f).query(
                p, sign_convention=conv, return_closest=True,
                n_threads=threads)
            got = MeshSDF(v, f).query(p, sign_convention=conv,
                                      return_closest=True, n_threads=threads)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_native_engine_builds_into_the_port(tmp_path):
    from d3human_tpu_torch import native

    lib = native.build_lib("meshsdf")
    assert lib == native.lib_path("meshsdf")
    assert lib.parent.name == "build" and lib.exists()
    assert not (native.SRC / "libmeshsdf.so").exists()


def test_mesh_sdf_host_engines():
    """The native engine answers (counted); the tensor op answers only
    when the engine cannot be built or loaded (counted, said on stderr),
    within the JAX test's 5e-3 of the engine with signs equal where
    |sdf| > 0.01; an error inside a query is raised."""
    import d3human_tpu_torch.native.meshsdf as N
    from d3human_tpu_torch.native import BuildError
    from d3human_tpu_torch.ops import mesh_sdf as M

    pts, v, f = _sdf_cases()["icosphere"]
    before = dict(M.ENGINE_COUNTS)
    host = M.mesh_sdf_host(pts, v, f, device="cpu")
    assert M.ENGINE_COUNTS["native"] == before["native"] + 1
    np.testing.assert_array_equal(host, N.MeshSDF(v, f).query(pts))

    def broken():
        raise BuildError("no compiler")

    orig = N._load
    N._load = broken
    try:
        dev = M.mesh_sdf_host(pts, v, f, device="cpu")
    finally:
        N._load = orig
    assert M.ENGINE_COUNTS["device"] == before["device"] + 1
    assert np.abs(dev - host).max() < 5e-3
    far = np.abs(host) > 0.01
    assert (np.sign(dev[far]) == np.sign(host[far])).all()
    with pytest.raises(ValueError):
        M.mesh_sdf_host(pts[:, :2], v, f, device="cpu")
    assert M.ENGINE_COUNTS["device"] == before["device"] + 1


# ---------------------------------------------------------------- fields

def test_smpl_template_sdf_matches_jax(both):
    j, p = both
    want = np.asarray(j["model"].smpl_template_sdf())
    got = _np(p["model"].smpl_template_sdf())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    far = np.abs(want) > 1e-4
    assert (np.sign(got[far]) == np.sign(want[far])).all()
    assert (want > 0).any() and (want < 0).any()


def test_pretrain_sdf_and_nonrigid_zero_match_jax(both):
    """5 full-batch Adam steps from the same parameters: the fitted MLPs
    rel-L2 1e-4; the nonrigid MLP's output falls, the other leaves are
    the same objects."""
    j, p = both
    jm, pm = j["model"], p["model"]
    jg, pg = j["params"]["geometry"], p["params"]["geometry"]
    tgt = jm.smpl_template_sdf()
    jout, jloss = jm.pretrain_sdf(jg, tgt, steps=5)
    pout, ploss = pm.pretrain_sdf(pg, torch.as_tensor(np.array(tgt)),
                                  steps=5)
    assert _rel_l2(_flat_layers(pout["sdf_net"]),
                   _flat_layers(to_np(jout["sdf_net"]))) <= 1e-4
    assert ploss == pytest.approx(jloss, rel=1e-4)

    jz = jm.pretrain_nonrigid_zero(jg, steps=5)
    pz = pm.pretrain_nonrigid_zero(pg, steps=5)
    assert _rel_l2(_flat_layers(pz["nonrigid"]),
                   _flat_layers(to_np(jz["nonrigid"]))) <= 1e-4
    code = torch.zeros((1, 1, p["cfg"].field.pose_code_dim))

    def mean_sq(net):
        return float((pm.nonrigid.apply(net, pm.grid.verts, code) ** 2)
                     .mean())

    assert mean_sq(pz["nonrigid"]) < mean_sq(pg["nonrigid"])
    assert all(pz[k] is pg[k] for k in pg if k != "nonrigid")


def test_reinit_fields_shapes_and_ranges(both):
    _, p = both
    pm, pg = p["model"], p["params"]["geometry"]
    out = pm.reinit_fields(torch.Generator().manual_seed(3), pg)
    assert out["msdf"].shape == pg["msdf"].shape
    assert float(out["msdf"].min()) >= -0.01 and float(out["msdf"].max()) <= 1
    assert not torch.equal(out["msdf"], pg["msdf"])
    for new, old in zip(out["sdf_net"]["layers"], pg["sdf_net"]["layers"]):
        for k in ("w", "b"):
            assert new[k].shape == old[k].shape
            assert torch.isfinite(new[k]).all()
        assert not torch.equal(new["w"], old["w"])
    assert all(out[k] is pg[k] for k in pg if k not in ("msdf", "sdf_net"))
    again = pm.reinit_fields(torch.Generator().manual_seed(3), pg)
    assert torch.equal(again["msdf"], out["msdf"])


# ---------------------------------------------------------------- repairs

def test_chunked_query_sdf_matches_jax_and_unchunked(both):
    """sdf_chunk = 100 over the 729 lattice vertices (8 chunks, the last
    padded): forward abs 1e-6 against the JAX package's chunked query and
    the port's unchunked one; the gradient of a weighted sum over the
    sdf_net leaves rel-L2 1e-5 against both."""
    from d3human_tpu.models.geometry import GeometryModel as JModel
    from d3human_tpu_torch.config import from_jax_config
    from d3human_tpu_torch.models.geometry import GeometryModel

    j, p = both
    jcfg = dataclasses.replace(j["cfg"], geometry=dataclasses.replace(
        j["cfg"].geometry, sdf_chunk=100))
    jm = JModel(jcfg, j["model"].grid, j["model"].deformer, j["model"].canon)
    pm = p["model"]
    chunked = GeometryModel(from_jax_config(jcfg), pm.grid, pm.deformer,
                            pm.canon)
    assert chunked.cfg.geometry.sdf_chunk == 100
    assert pm.cfg.geometry.sdf_chunk == 0
    pts = np.asarray(j["model"].grid.verts)
    w = np.random.default_rng(7).standard_normal(len(pts)).astype(np.float32)
    jg = j["params"]["geometry"]

    def jloss(net):
        return jnp.sum(jm.query_sdf({"sdf_net": net}, jnp.asarray(pts)) * w)

    jgrad = _flat_layers(to_np(jax.grad(jloss)(jg["sdf_net"])))
    jout = np.asarray(jm.query_sdf(jg, jnp.asarray(pts)))
    outs, grads = [], []
    for model in (chunked, pm):
        net = {"layers": [{k: t.clone().requires_grad_(True)
                           for k, t in lay.items()}
                          for lay in p["params"]["geometry"]["sdf_net"][
                              "layers"]]}
        out = model.query_sdf({"sdf_net": net}, torch.as_tensor(pts))
        (out * torch.as_tensor(w)).sum().backward()
        outs.append(_np(out))
        grads.append(np.concatenate([_np(lay[k].grad).reshape(-1)
                                     for lay in net["layers"]
                                     for k in ("w", "b")]))
    assert outs[0].shape == (len(pts),)
    for got in outs:
        np.testing.assert_allclose(got, jout, rtol=0, atol=1e-6)
    for got in grads:
        assert _rel_l2(got, jgrad) <= 1e-5
    assert _rel_l2(grads[0], grads[1]) <= 1e-5


def test_geometry_model_from_jax_default_config(both):
    """The JAX default Config() converts and builds a GeometryModel with
    the JAX package's sdf_chunk of 131,072; its query runs (unchunked
    below the chunk, as in JAX)."""
    from d3human_tpu.config import Config as JConfig
    from d3human_tpu_torch.config import Config, from_jax_config
    from d3human_tpu_torch.models.geometry import GeometryModel

    _, p = both
    cfg = from_jax_config(JConfig())
    assert cfg.geometry.sdf_chunk == JConfig().geometry.sdf_chunk == 131072
    assert Config().geometry.sdf_chunk == 131072
    pm = p["model"]
    model = GeometryModel(cfg, pm.grid, pm.deformer, pm.canon)
    params = model.init_params(torch.Generator().manual_seed(0), n_images=2)
    out = model.query_sdf(params, pm.grid.verts)
    assert out.shape == (pm.grid.n_verts,) and torch.isfinite(out).all()


def test_smplx_offsets_match_jax(both):
    """SMPLXModel.forward and lbs_forward with nonzero face, joint and
    locator offsets: abs 1e-5 against the JAX package, and the offsets
    move the result."""
    j, p = both
    jmodel, pmodel = j["scene"].model, p["scene"].model
    rng = np.random.default_rng(8)
    V, J = pmodel.v_template.shape[0], pmodel.num_joints
    offs = {"face_offset": rng.normal(size=(1, V, 3)) * 0.01,
            "joint_offset": rng.normal(size=(1, J, 3)) * 0.02,
            "locator_offset": rng.normal(size=(1, J, 3)) * 0.02}
    offs = {k: v.astype(np.float32) for k, v in offs.items()}
    betas = (rng.normal(size=(1, pmodel.num_betas)) * 0.5).astype(np.float32)
    body = (rng.normal(size=(1, 63)) * 0.2).astype(np.float32)
    root = (rng.normal(size=(1, 3)) * 0.2).astype(np.float32)
    want = jmodel.forward(jnp.asarray(betas), jnp.asarray(root),
                          jnp.asarray(body),
                          **{k: jnp.asarray(v) for k, v in offs.items()})
    got = pmodel.forward(torch.as_tensor(betas), torch.as_tensor(root),
                         torch.as_tensor(body),
                         **{k: torch.as_tensor(v) for k, v in offs.items()})
    plain = pmodel.forward(torch.as_tensor(betas), torch.as_tensor(root),
                           torch.as_tensor(body))
    for g, w, n in zip(got, want, plain):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-5)
        assert np.abs(_np(g) - _np(n)).max() > 1e-3

    pts = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    jpose = dict(j["params"]["pose"], **{k: jnp.asarray(v)
                                        for k, v in offs.items()})
    ppose = dict(p["params"]["pose"], **{k: torch.as_tensor(v)
                                        for k, v in offs.items()})
    want = j["model"].pose_verts(jnp.asarray(pts), jpose, 1)
    got = p["model"].pose_verts(torch.as_tensor(pts), ppose, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    plain = p["model"].pose_verts(torch.as_tensor(pts), p["params"]["pose"],
                                  1)
    assert np.abs(_np(got) - _np(plain)).max() > 1e-3
