"""The reference-format (unstructured) tet grid in the port against the JAX
package, on the small scene's lattice written as a reference-format npz
(``vertices`` = v / 1.2 with y + 0.1919, ``indices``): the loader's arrays,
the G-Shell extraction and ``sdf_reg_loss`` on the gather branches, the
init and split ticks with the JAX draws injected, the port's unstructured
path against its lattice path on the same verts and tets, and a CPU
rehearsal of ``chip_smoke.py``'s ``ref_grid`` phases."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (
    IT, JAX_RASTER_OPTS, KEY, RASTER_OPTS, eik_draws, jax_small,
    jax_split_small, port_small, split_draws,
)

torch.set_num_threads(1)

EXACT = ("n_cross", "n_valid_tets", "n_big_faces", "n_max_tile")


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _write_ref(path, jgrid):
    from d3human_tpu_torch.ops.tet_grid import save_reference_tet_grid

    save_reference_tet_grid(str(path), np.asarray(jgrid.verts),
                            np.asarray(jgrid.tets))
    return str(path)


def _on_ref_grid(j, p, path):
    """Both packages' models on the grid read from ``path``."""
    from d3human_tpu.models.geometry import GeometryModel as JGeometryModel
    from d3human_tpu.ops.tet_grid import load_reference_tet_grid as jload
    from d3human_tpu_torch.models.geometry import GeometryModel
    from d3human_tpu_torch.ops.tet_grid import load_reference_tet_grid

    jm, pm = j["model"], p["model"]
    return (dict(j, model=JGeometryModel(j["cfg"], jload(path), jm.deformer,
                                         jm.canon)),
            dict(p, model=GeometryModel(p["cfg"], load_reference_tet_grid(
                path, device="cpu"), pm.deformer, pm.canon)))


@pytest.fixture(scope="module")
def init_pair(tmp_path_factory):
    j = jax_small()
    path = _write_ref(tmp_path_factory.mktemp("ref") / "tet_grid.npz",
                      j["model"].grid)
    return (j, port_small(j)) + _on_ref_grid(j, port_small(j), path) + (
        path,)


@pytest.fixture(scope="module")
def split_pair(tmp_path_factory):
    j = jax_split_small()
    j["cfg"] = dataclasses.replace(j["cfg"], optim=dataclasses.replace(
        j["cfg"].optim, warmup_iter=0, clip_max_norm=1.0))
    path = _write_ref(tmp_path_factory.mktemp("ref") / "tet_grid.npz",
                      j["model"].grid)
    return _on_ref_grid(j, port_small(j), path)


def test_load_reference_tet_grid_matches_jax(init_pair):
    """Both loaders give equal arrays (dtypes too); dims None; the tets are
    the lattice's and the positions within 1e-7 of it after the round
    trip; the port's in-memory ``unstructured`` of the lattice is the same
    grid."""
    from d3human_tpu.ops.tet_grid import load_reference_tet_grid as jload
    from d3human_tpu_torch.ops.tet_grid import (
        load_reference_tet_grid, unstructured,
    )

    j, p, _, _, path = init_pair
    a, b = jload(path), load_reference_tet_grid(path, device="cpu")
    assert a.dims is None and b.dims is None and b.vert_dims is None
    for name in ("verts", "tets", "edges", "tet_edges"):
        want = np.asarray(getattr(a, name))
        got = _np(getattr(b, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, name)
    lattice = p["model"].grid
    assert torch.equal(b.tets, lattice.tets)
    assert float((b.verts - lattice.verts).abs().max()) <= 1e-7
    assert b.n_edges == lattice.n_edges
    u = unstructured(lattice)
    assert u.dims is None and u.verts is lattice.verts
    for name in ("edges", "tet_edges"):
        assert torch.equal(getattr(u, name), getattr(b, name)), name


def test_load_reference_tet_grid_refuses_malformed_files(tmp_path):
    """A file whose arrays have the wrong shapes, or whose indices leave
    the vertex range, is refused before anything reaches a device."""
    from d3human_tpu_torch.ops.tet_grid import load_reference_tet_grid

    v = np.zeros((5, 3), np.float32)
    t = np.asarray([[0, 1, 2, 3], [1, 2, 3, 4]])
    for name, arrays in (("flat", dict(vertices=v.ravel(), indices=t)),
                         ("tris", dict(vertices=v, indices=t[:, :3])),
                         ("range", dict(vertices=v, indices=t + 1)),
                         ("negative", dict(vertices=v, indices=t - 1))):
        path = tmp_path / f"{name}.npz"
        np.savez(path, **arrays)
        with pytest.raises(ValueError):
            load_reference_tet_grid(str(path), device="cpu")


def test_unique_edges_generic_matches_jax():
    """A random tet soup (shared and repeated edges, unsorted corners):
    edges and tet edges equal to the JAX package's."""
    from d3human_tpu.ops.tet_grid import _unique_edges_generic as jue
    from d3human_tpu_torch.ops.tet_grid import _unique_edges_generic

    rng = np.random.default_rng(5)
    tets = np.stack([rng.choice(40, 4, replace=False) for _ in range(200)])
    want, got = jue(tets), _unique_edges_generic(tets)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    e = got[0]
    assert (e[:, 0] < e[:, 1]).all()
    assert (np.diff(e[:, 0] * 40 + e[:, 1]) > 0).all()


def _extract_inputs(j):
    g = j["params"]["geometry"]
    model = j["model"]
    v_def = model.deformed_grid(g)
    sdf = model.query_sdf(g, v_def)
    msdf = jnp.tanh(3.0 * v_def[:, 1] + 0.2)
    return np.array(v_def), np.array(sdf), np.array(msdf)


def test_gshell_extract_pair_unstructured_matches_jax(init_pair):
    """The gather branches of the extraction: counts exact, integer buffers
    exact, float buffers abs 1e-6, both halves."""
    from d3human_tpu.ops.marching_tets import gshell_extract_pair as jpair
    from d3human_tpu_torch.ops.marching_tets import gshell_extract_pair

    _, _, jr, pr, _ = init_pair
    pos, sdf, msdf = _extract_inputs(jr)
    mv, mt = jr["cfg"].geometry.max_verts, jr["cfg"].geometry.max_tets
    want = jpair(jr["model"].grid, jnp.asarray(pos), jnp.asarray(sdf),
                 jnp.asarray(msdf), mv, mt)
    got = gshell_extract_pair(pr["model"].grid, torch.as_tensor(pos),
                              torch.as_tensor(sdf), torch.as_tensor(msdf),
                              mv, mt)
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), rtol=0,
                               atol=1e-6)
    for g, w in zip(got[:2], want[:2]):
        assert int(g.n_cross) == int(w.n_cross) > 0
        assert int(g.n_valid_tets) == int(w.n_valid_tets) > 0
        assert int(g.face_valid.sum()) == int(w.face_valid.sum()) > 0
        for name in ("faces", "face_valid", "vert_valid", "faces_wt",
                     "face_wt_valid"):
            np.testing.assert_array_equal(_np(getattr(g, name)),
                                          np.asarray(getattr(w, name)), name)
        for name in ("verts", "verts_wt", "msdf_aug", "msdf_wt"):
            np.testing.assert_allclose(_np(getattr(g, name)),
                                       np.asarray(getattr(w, name)), rtol=0,
                                       atol=1e-6, err_msg=name)


def test_sdf_reg_loss_unstructured_matches_jax(init_pair):
    """Value rel 1e-6 and gradient rel-L2 1e-5 (the port's endpoint gathers
    add in the scatter's order, JAX's indexing in its own)."""
    from d3human_tpu.ops.marching_tets import sdf_reg_loss as jreg
    from d3human_tpu_torch.ops.marching_tets import sdf_reg_loss

    _, _, jr, pr, _ = init_pair
    _, sdf, _ = _extract_inputs(jr)
    want, jg = jax.value_and_grad(jreg)(jnp.asarray(sdf), jr["model"].grid)
    x = torch.as_tensor(sdf).requires_grad_(True)
    got = sdf_reg_loss(x, pr["model"].grid)
    (tg,) = torch.autograd.grad(got, x)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    assert float(np.abs(np.asarray(jg)).max()) > 0
    assert _rel_l2(_np(tg), np.asarray(jg)) <= 1e-5


def _leaf_grads(tree):
    from d3human_tpu_torch.train.optim import named_leaves

    return {k: v.numpy() for k, v in named_leaves(
        jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree))}


def _check_tick(got, want, grads, jgrads, paths, exact_key):
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        if exact_key(k):
            assert g == w, (k, g, w)
        else:
            assert g == pytest.approx(w, rel=5e-3, abs=1e-6), (k, g, w)
    nonzero = 0
    for k in paths:
        w = jgrads[k]
        g = np.zeros_like(w) if grads[k] is None else grads[k].numpy()
        if np.linalg.norm(w) == 0:
            assert np.linalg.norm(g) == 0, k
            continue
        nonzero += 1
        assert _rel_l2(g, w) <= 1e-3, (k, _rel_l2(g, w))
    return nonzero


def test_tick_init_unstructured_matches_jax(init_pair):
    """``tick_init`` on the reference-format grid with the JAX eikonal draws
    injected: counters exact, scalars rel 5e-3, every gradient leaf rel-L2
    1e-3."""
    from d3human_tpu.train import losses as JL
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import loss_and_grads

    _, _, j, p, _ = init_pair

    def loss(params):
        out = JL.tick_init(jax.random.PRNGKey(KEY), j["model"],
                           params["geometry"], params["pose"], j["tex"],
                           params["material"], j["perceptual"],
                           j["perc_params"], j["target"], jnp.int32(IT),
                           j["cfg"], JAX_RASTER_OPTS)
        return out["total"], {k: v for k, v in out.items()
                              if jnp.ndim(v) == 0}

    jg, want = jax.jit(jax.grad(loss, has_aux=True))(j["params"])
    paths = [k for k, _ in named_leaves(p["params"])]
    got, tg = loss_and_grads(
        "init", p["model"], p["tex"], p["perceptual"], p["perc_params"],
        p["params"], p["target"], IT, p["cfg"], paths, RASTER_OPTS,
        draws={"eik": eik_draws(p["cfg"].geometry.n_eikonal_samples)})
    assert float(got["n_cross"]) > 0
    assert _check_tick(got, want, tg, _leaf_grads(jg), paths,
                       lambda k: k in EXACT) >= 10


def test_tick_split_unstructured_matches_jax(split_pair):
    """``tick_split`` on the reference-format grid with the JAX draws
    injected: counters exact, scalars rel 5e-3, gradients rel-L2 1e-3."""
    from d3human_tpu.train import losses as JL
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import loss_and_grads

    j, p = split_pair

    def loss(params):
        out = JL.tick_split(
            jax.random.PRNGKey(KEY), j["model"], params["geometry"],
            params["pose"], j["tex"], params["material"], j["perceptual"],
            j["perc_params"], j["target"], jnp.int32(IT), j["cfg"],
            JAX_RASTER_OPTS)
        return out["total"], out

    jg, want = jax.jit(jax.grad(loss, has_aux=True))(j["params"])
    paths = [k for k, t in named_leaves(p["params"])
             if t.is_floating_point()]
    got, tg = loss_and_grads(
        "split", p["model"], p["tex"], p["perceptual"], p["perc_params"],
        p["params"], p["target"], IT, p["cfg"], paths, RASTER_OPTS,
        draws=split_draws(j["cfg"]))
    for half in ("cloth", "body"):
        assert got[f"{half}_n_cross"] > 0 and got[f"{half}_cap_cov"] > 0
    assert _check_tick(got, want, tg, _leaf_grads(jg), paths,
                       lambda k: k.split("_", 1)[-1] in EXACT) >= 10


def test_unstructured_path_equals_lattice_path(init_pair):
    """The port on the reference-format grid against the port on the
    lattice it was written from: the extraction's counts, faces and
    positions equal (the vertex slots follow the edge order, so vertices
    are compared by the faces that use them), ``sdf_reg_loss`` and its
    gradient within float32 sums in another order, and the init tick's
    counters exact, its scalars rel 1e-5."""
    from d3human_tpu_torch.ops.marching_tets import (
        gshell_extract_pair, sdf_reg_loss,
    )
    from d3human_tpu_torch.ops.tet_grid import unstructured
    from d3human_tpu_torch.train.losses import tick_init

    _, p, _, _, _ = init_pair
    lattice = p["model"].grid
    pos, sdf, msdf = (torch.as_tensor(a) for a in _extract_inputs(
        init_pair[0]))
    mv, mt = p["cfg"].geometry.max_verts, p["cfg"].geometry.max_tets
    want = gshell_extract_pair(lattice, pos, sdf, msdf, mv, mt)
    got = gshell_extract_pair(unstructured(lattice), pos, sdf, msdf, mv, mt)
    for g, w in zip(got[:2], want[:2]):
        assert int(g.n_cross) == int(w.n_cross) > 0
        assert int(g.n_valid_tets) == int(w.n_valid_tets) > 0
        assert torch.equal(g.face_valid, w.face_valid)
        live = g.face_valid
        assert torch.equal(g.verts[g.faces[live].long()],
                           w.verts[w.faces[live].long()])
        assert int(g.vert_valid.sum()) == int(w.vert_valid.sum())
    x = sdf.clone().requires_grad_(True)
    y = sdf.clone().requires_grad_(True)
    lw, lg = sdf_reg_loss(x, lattice), sdf_reg_loss(y, unstructured(lattice))
    assert float(lg.detach()) == pytest.approx(float(lw.detach()), rel=1e-6)
    (gw,), (gg,) = torch.autograd.grad(lw, x), torch.autograd.grad(lg, y)
    assert torch.allclose(gg, gw, rtol=1e-6, atol=1e-9)

    def tick(model):
        with torch.no_grad():
            return tick_init(None, model, p["params"]["geometry"],
                             p["params"]["pose"], p["tex"],
                             p["params"]["material"], p["perceptual"],
                             p["perc_params"], p["target"], IT, p["cfg"],
                             RASTER_OPTS, draws={"eik": eik_draws(
                                 p["cfg"].geometry.n_eikonal_samples)})

    from d3human_tpu_torch.models.geometry import GeometryModel

    m = p["model"]
    a = tick(m)
    b = tick(GeometryModel(p["cfg"], unstructured(lattice), m.deformer,
                           m.canon))
    for k in a:
        if k in EXACT or k.startswith("cap_"):
            assert float(b[k]) == float(a[k]), k
        else:
            assert float(b[k]) == pytest.approx(float(a[k]), rel=1e-5), k


def test_chip_smoke_ref_grid_rehearsal(tmp_path):
    """``chip_smoke.py``'s ``ref_grid`` phases at the CPU-sized scale: the
    cropped lattice against its unstructured grid step by step, the round
    trips through reference-format files, the uncropped lattice's steps,
    and the kernel call sites they record (the extraction's two first_k
    sites and the endpoint gathers' backward among them)."""
    import chip_smoke

    sc = chip_smoke.build_scene("tiny", "cpu", seed_steps=30)
    ref = chip_smoke.phase_ref_grid(sc, str(tmp_path))
    assert ref["grid"]["n_edges"] == sc["n_edges"]
    assert ref["counts"]["n_cross"] > 0
    for stage, n in chip_smoke.REF_STEPS:
        assert len(ref["steps"][stage]["ms"]) == n
        assert ref["steps"][stage]["grad"] <= chip_smoke.REF_GRAD_TOL
    sites = ref["inputs"]["first_k_indices"]
    assert {s for s in sites if s.startswith("marching_tets.py")} != set()
    assert any(s.startswith("scatter.py") for s in
               ref["inputs"]["coo_scatter_add"])
    whole = chip_smoke.phase_ref_grid_uncropped("tiny", "cpu", 30,
                                                str(tmp_path))
    assert whole["grid"]["n_verts"] == 9 ** 3
    assert whole["grid"]["n_tets"] == 6 * 8 ** 3
    assert len(whole["init_ms"]) == chip_smoke.INIT_STEPS
    assert whole["counts"]["n_cross"] > 0
    assert set(whole["inputs"]) == {"first_k_indices", "coo_scatter_add",
                                    "resolve_tiles"}
