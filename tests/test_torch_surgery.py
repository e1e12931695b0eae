"""The port's host surgery between the split and the seq stage against the
JAX package (CPU, plain kernel versions): mesh files, compaction and
welding, connected components, the close-hole pass, the template
surgery (open-edge trim, distance cut, collision push-in, watertight
re-extraction, merge), the split stage's mesh export, and the seq
template built from the merge with one seq tick on it. Inputs come from
one numpy seed or the small scene's split halves and go through both
sides; the files each side writes are compared."""

import os

import numpy as np
import pytest
import torch

import jax

from test_pipeline import icosphere
from torch_parity import (
    IT, JAX_RASTER_OPTS, KEY, RASTER_OPTS, compact_draw_shapes,
    jax_split_small, load_jax_engine, port_small, render_draws, to_np,
)

torch.set_num_threads(1)

# the merged template's longest tile list here is 27,886 faces: the JAX
# side gets a capacity that cuts nothing, on its XLA path (the Pallas
# kernel holds 1,024 slots a tile)
MERGE_JAX_RASTER_OPTS = dict(JAX_RASTER_OPTS, max_faces_per_tile=28672,
                             backend="xla")


@pytest.fixture(scope="module", autouse=True)
def jax_engine_as_committed():
    """The JAX package's merge and re-extraction query its mesh-SDF
    engine. Load that engine from its committed library for the module
    and keep its ``build_lib`` from building: it returns the committed
    path and records the call. After the module no call was made and the
    library's bytes and mtime are unchanged."""
    J, lib = load_jax_engine()
    before = (lib.read_bytes(), lib.stat().st_mtime_ns)
    calls, orig = [], J.build_lib
    J.build_lib = lambda name, force=False: calls.append(name) or str(lib)
    try:
        yield
    finally:
        J.build_lib = orig
    assert calls == []
    assert (lib.read_bytes(), lib.stat().st_mtime_ns) == before


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _soup():
    """Four spheres (one holey, two joined through a shared vertex) and an
    open strip of two triangles: four components and open rims."""
    parts = [icosphere(0.3, (0, 0, 0), 2), icosphere(0.2, (1, 0, 0), 1),
             icosphere(0.05, (0.32, 0, 0), 0), icosphere(0.1, (0, 1, 0), 1),
             (np.asarray([[2, 0, 0], [2.1, 0, 0], [2, 0.1, 0],
                          [2.1, 0.1, 0.05]], np.float32),
              np.asarray([[0, 1, 2], [1, 3, 2]]))]
    vs, fs, off = [], [], 0
    for v, f in parts:
        vs.append(v)
        fs.append(f + off)
        off += len(v)
    fs[0] = fs[0][7:]                                      # a hole
    fs[3][0, 0] = fs[1][0, 0]                              # a shared vertex
    return (np.concatenate(vs).astype(np.float32),
            np.concatenate(fs).astype(np.int64))


# ---------------------------------------------------------------- io

@pytest.mark.parametrize("extra", ["plain", "normals", "uv"])
def test_write_obj_text_identical_and_round_trip(tmp_path, extra):
    from d3human_tpu.utils import io as J
    from d3human_tpu_torch.utils import io as P

    v, f = _soup()
    rng = np.random.default_rng(1)
    kw = {"plain": {}, "normals": {"normals": rng.normal(size=v.shape)},
          "uv": {"uv": rng.random((len(v), 2)),
                 "uv_idx": f[:, ::-1].copy()}}[extra]
    J.write_obj(str(tmp_path / "j.obj"), v, f, **kw)
    P.write_obj(str(tmp_path / "p.obj"), torch.as_tensor(v),
                torch.as_tensor(f), **kw)
    assert (tmp_path / "p.obj").read_bytes() == (tmp_path / "j.obj") \
        .read_bytes()
    for a, b in zip(P.load_obj(str(tmp_path / "p.obj")),
                    J.load_obj(str(tmp_path / "j.obj"))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    pv, pf = P.load_obj(str(tmp_path / "p.obj"))
    np.testing.assert_array_equal(pf, f)
    np.testing.assert_allclose(pv, v, rtol=0, atol=5e-7)


@pytest.mark.parametrize("colors", [False, True])
def test_ply_bytes_identical_and_round_trip(tmp_path, colors):
    from d3human_tpu.utils import io as J
    from d3human_tpu_torch.utils import io as P

    v, f = _soup()
    c = np.random.default_rng(2).random((len(v), 3)) if colors else None
    J.write_ply(str(tmp_path / "j.ply"), v, f, vert_colors=c)
    P.write_ply(str(tmp_path / "p.ply"), v, f, vert_colors=c)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply") \
        .read_bytes()
    pv, pf = P.read_ply(str(tmp_path / "p.ply"))
    np.testing.assert_array_equal(pv, v)
    np.testing.assert_array_equal(pf, f)
    for a, b in zip((pv, pf), J.read_ply(str(tmp_path / "j.ply"))):
        assert a.dtype == b.dtype


def test_compact_and_weld_mesh_bit_for_bit():
    from d3human_tpu.utils import io as J
    from d3human_tpu_torch.utils import io as P

    rng = np.random.default_rng(3)
    v = rng.integers(0, 6, (300, 3)).astype(np.float32) * 0.1
    v[::7] += 3e-7                                  # coincide at 1e-6
    f = rng.integers(0, 300, (500, 3))
    valid = rng.random(500) > 0.3
    for a, b in zip(P.compact_mesh(torch.as_tensor(v), torch.as_tensor(f),
                                   torch.as_tensor(valid)),
                    J.compact_mesh(v, f, valid)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    got, want = P.weld_mesh(v, f), J.weld_mesh(v, f)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert len(got[0]) < len(np.unique(f))


# ---------------------------------------------------------------- components

def test_connected_and_face_components_equal_jax():
    from d3human_tpu.ops.mesh_ops import connected_components as jcc
    from d3human_tpu.pipeline import template as JT
    from d3human_tpu_torch.ops.mesh_ops import connected_components
    from d3human_tpu_torch.pipeline import template as PT

    v, f = _soup()
    got = connected_components(f, len(v))
    np.testing.assert_array_equal(got, jcc(f, len(v)))
    assert len(np.unique(got[np.unique(f)])) == 4
    np.testing.assert_array_equal(PT._face_components(len(v), f),
                                  JT._face_components(len(v), f))


def test_split_and_reassign_components_equal_jax():
    """The JAX test's case (a cloth island hugging the body moves to the
    body) plus a body island nearer the cloth and a floater that is
    dropped: every array equal."""
    from d3human_tpu.pipeline import components as J
    from d3human_tpu_torch.pipeline import components as P

    bv, bf = icosphere(radius=0.5, n=2)
    b2v, b2f = icosphere(radius=0.06, center=(0.0, 0.62, 0), n=1)
    b3v, b3f = icosphere(radius=0.02, center=(0.0, -0.9, 0), n=0)
    cv1, cf1 = icosphere(radius=0.6, n=2)
    cv2, cf2 = icosphere(radius=0.05, center=(0.5, 0, 0), n=1)
    n0, n1 = len(bv), len(bv) + len(b2v)
    bv = np.concatenate([bv, b2v, b3v])
    bf = np.concatenate([bf, b2f + n0, b3f + n1])
    cv = np.concatenate([cv1, cv2])
    cf = np.concatenate([cf1, cf2 + len(cv1)])
    for a, b in zip(P.split_components(bv, bf), J.split_components(bv, bf)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    got = P.reassign_components(bv, bf, cv, cf, min_keep_faces=10)
    want = J.reassign_components(bv, bf, cv, cf, min_keep_faces=10)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert len(got[1]) == len(icosphere(n=2)[1]) + len(cf2)
    assert len(got[3]) == len(cf1) + len(b2f)
    src = np.random.default_rng(4).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(P._nearest_dist(src, cv, block=7),
                                  J._nearest_dist(src, cv))


def test_head_bbox_equals_jax():
    from d3human_tpu.pipeline import components as J
    from d3human_tpu_torch.pipeline import components as P

    v = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    for frac in (0.2, 0.0):
        np.testing.assert_array_equal(P.head_bbox(v, frac),
                                      J.head_bbox(v, frac))
    np.testing.assert_array_equal(P.head_bbox(v[:0]), J.head_bbox(v[:0]))


def test_trim_open_edges_and_distance_cut_equal_jax():
    from d3human_tpu.pipeline import template as J
    from d3human_tpu_torch.pipeline import template as P

    v, f = _soup()
    np.testing.assert_array_equal(P.find_open_edges(f), J.find_open_edges(f))
    for iters in (1, 2, 3):
        np.testing.assert_array_equal(P.trim_open_edges(f, iters),
                                      J.trim_open_edges(f, iters))
    sv, sf = icosphere(radius=0.5, n=2)
    ref = np.concatenate([sv[sv[:, 1] > 0.25], sv[sv[:, 1] < -0.45][:2]])
    for thresh in (0.12, 0.0, 0.03):
        got = P.distance_cut(sv, sf, ref, thresh=thresh, device="cpu")
        np.testing.assert_array_equal(got, J.distance_cut(sv, sf, ref,
                                                          thresh=thresh))
    assert len(P.distance_cut(sv, sf, ref, thresh=0.12, device="cpu")) > 0


def test_push_body_inside_cloth_matches_jax():
    from d3human_tpu.pipeline import template as J
    from d3human_tpu_torch.pipeline import template as P

    bv, bf = icosphere(radius=0.46, n=2)
    cv, cf = icosphere(radius=0.45, n=2)
    cf = cf[cv[cf].mean(1)[:, 1] > 0]
    want = J.push_body_inside_cloth(bv, bf, cv, cf, influence=0.1)
    got = P.push_body_inside_cloth(bv, bf, cv, cf, influence=0.1,
                                   device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (np.abs(got - bv).max(1) > 1e-4).sum() >= 5


def _match_verts(got, want, atol=1e-5):
    """(perm, matched): perm[i] is the ``want`` vertex nearest ``got[i]``,
    matched where it lies within ``atol`` (max norm). The weld numbers
    vertices in the order of their positions rounded to 1e-6, so positions
    an ulp apart on the two sides can swap two neighbours."""
    from scipy.spatial import cKDTree

    d, perm = cKDTree(want).query(got, p=np.inf)
    return perm, d <= atol


def _exact_perm(got, want):
    """``_match_verts`` where every vertex must match, one to one."""
    perm, matched = _match_verts(got, want)
    assert len(got) == len(want) and matched.all()
    assert len(np.unique(perm)) == len(perm)
    assert (perm != np.arange(len(perm))).mean() < 0.01
    return perm


@pytest.mark.parametrize("caps", [8192, 512])
def test_rewatertight_matches_jax(caps):
    """grid_res 24 on a holey sphere: vertex and face counts exact, verts
    abs 1e-5 and faces exact once the vertices are matched by position;
    with 512 the capacities overflow and are doubled on both sides."""
    from d3human_tpu.pipeline import template as J
    from d3human_tpu_torch.pipeline import template as P

    v, f = icosphere(radius=0.4, n=2)
    holey = f[:-20]
    wv, wf = J.rewatertight(v, holey, grid_res=24, max_verts=caps,
                            max_tets=caps)
    gv, gf = P.rewatertight(v, holey, grid_res=24, max_verts=caps,
                            max_tets=caps, device="cpu")
    assert len(gf) == len(wf) > 100
    np.testing.assert_array_equal(_exact_perm(gv, wv)[gf], wf)


# ---------------------------------------------------------------- the route

@pytest.fixture(scope="module")
def split_small():
    j = jax_split_small()
    return j, port_small(j)


def test_export_stage_meshes_match_jax(split_small, tmp_path):
    """Both halves and the watertight mesh of the small split scene: faces
    exact, verts abs 1e-5, all three non-empty."""
    from d3human_tpu.train.stages import export_stage_meshes as jexport
    from d3human_tpu_torch.train.stages import export_stage_meshes
    from d3human_tpu_torch.utils import io as P

    j, p = split_small
    want = jexport(j["model"], j["params"], str(tmp_path / "j"), "final")
    got = export_stage_meshes(p["model"], p["params"], str(tmp_path / "p"),
                              "final")
    assert set(got) == set(want) == {"cloth", "body", "watertight"}
    for k in want:
        assert os.path.basename(got[k]) == os.path.basename(want[k])
        gv, gf = P.load_obj(got[k])
        wv, wf = P.load_obj(want[k])
        assert len(gf) > 0
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def route(split_small, tmp_path_factory):
    """The JAX package's route (train_d3h.py) on both sides from the same
    inputs: the small split scene's halves (exported by the JAX package),
    the close hole, the canonical template as smpl_template.obj, the merge
    at grid_res 24; and the JAX test's spheres merged the same way."""
    from d3human_tpu.pipeline import components as JC
    from d3human_tpu.pipeline import template as JT
    from d3human_tpu.train.stages import export_stage_meshes as jexport
    from d3human_tpu.utils import io as JIO
    from d3human_tpu_torch.pipeline import components as PC
    from d3human_tpu_torch.pipeline import template as PT

    j, _ = split_small
    root = tmp_path_factory.mktemp("route")
    halves = jexport(j["model"], j["params"], str(root / "split"), "final")
    smpl = str(root / "smpl_template.obj")
    JIO.write_obj(smpl, np.asarray(j["scene"].canon.vs_template[0]),
                  np.asarray(j["scene"].model.faces))
    ch = {side: mod.process_close_hole(str(root / f"ch_{side}"),
                                       halves["body"], halves["cloth"])
          for side, mod in (("jax", JC), ("port", PC))}

    sph = root / "spheres"
    sph.mkdir()
    bv, bf = icosphere(radius=0.4, n=2)
    cv, cf = icosphere(radius=0.45, n=2)
    cf = cf[np.asarray([c[1] > 0 for c in cv[cf].mean(1)])]
    sv, sf = icosphere(radius=0.38, n=2)
    for name, (a, b) in (("b", (bv, bf)), ("c", (cv, cf)), ("s", (sv, sf))):
        JIO.write_obj(str(sph / f"{name}.obj"), a, b)
    np.savez(str(sph / "bbox.npz"), bbox=JC.head_bbox(bv))

    cases = {
        "split halves": dict(body_obj=ch["jax"]["body"],
                             cloth_obj=ch["jax"]["cloth"], grid_res=24,
                             smpl_obj=smpl, bbox_npz=ch["jax"]["bbox"]),
        "spheres": dict(body_obj=str(sph / "b.obj"),
                        cloth_obj=str(sph / "c.obj"), grid_res=24,
                        cover_eps=0.09, smpl_obj=str(sph / "s.obj"),
                        bbox_npz=str(sph / "bbox.npz"), trim_iters=1),
    }
    merges = {}
    for name, kw in cases.items():
        d = root / name.replace(" ", "_")
        merges[name] = (JT.merge_body_cloth(str(d / "jax"), **kw),
                        PT.merge_body_cloth(str(d / "port"), device="cpu",
                                            **kw))
    return dict(halves=halves, ch=ch, merges=merges,
                spheres=cases["spheres"])


def test_process_close_hole_files_identical(route):
    ch = route["ch"]
    for k in ("body", "cloth"):
        with open(ch["port"][k], "rb") as a, open(ch["jax"][k], "rb") as b:
            assert a.read() == b.read(), k
    np.testing.assert_array_equal(np.load(ch["port"]["bbox"])["bbox"],
                                  np.load(ch["jax"]["bbox"])["bbox"])


def _npz(path):
    return dict(np.load(path))


def _inside_agreement(got, want, perm, matched):
    """Share of the matched body vertices (port vertex i is JAX vertex
    perm[i]) on the same side of the cloth on both sides."""
    idx = np.nonzero(matched)[0]
    return (np.isin(idx, got["inside_body_index"])
            == np.isin(perm[idx], want["inside_body_index"])).mean()


def test_merge_body_cloth_matches_jax_on_spheres(route):
    """The JAX test's spheres with a SMPL stand-in and a head box: every
    npz array with the JAX package's dtype, v abs 1e-5, the faces and the
    face labels exact once the vertices are matched by position, both
    labels non-empty, the branch and the counts reported.

    The inside/outside sets come from the sign of the watertight cloth's
    SDF. The cloth is an open shell, so its re-extraction is a thin closed
    sheet whose two sides are near-equidistant from many body vertices,
    and the engine breaks such ties by face order, which the weld's vertex
    order sets: the re-extractions agree to 6e-8, yet 24 of their 6,860
    vertices swap places on the two sides. So the sets are held exact on
    one input (the JAX package's body vertices against its watertight
    cloth, through the port's engine), and the merges' sets to 99% of the
    body vertices (66 of 8,108 differ)."""
    from d3human_tpu.pipeline import template as JT
    from d3human_tpu.utils import io as JIO
    from d3human_tpu_torch.ops.mesh_sdf import mesh_sdf_host
    from d3human_tpu_torch.pipeline import template as PT

    want, got = route["merges"]["spheres"]
    assert got["branch"] == "watertight_cloth"
    zg, zw = _npz(got["mesh"]), _npz(want["mesh"])
    ig, iw = _npz(got["indices"]), _npz(want["indices"])
    for a, b in ((zg, zw), (ig, iw)):
        assert set(a) == set(b)
        assert all(a[k].dtype == b[k].dtype for k in b)
    perm = _exact_perm(zg["v"], zw["v"])
    np.testing.assert_array_equal(perm[zg["f"]], zw["f"])
    np.testing.assert_array_equal(zg["face_labels"], zw["face_labels"])
    lab = zg["face_labels"]
    assert (lab == 0).any() and (lab == 1).any()
    c = got["counts"]
    nb = c["body_verts"]
    assert (c["merged_faces"], c["merged_verts"]) == (len(zg["f"]),
                                                      len(zg["v"]))
    assert c["inside_body_verts"] + c["outside_body_verts"] == nb \
        == len(np.unique(zg["f"][lab == 0]))
    assert len(ig["inside_body_index"]) > 0
    assert len(ig["outside_body_index"]) > 0
    assert _inside_agreement(ig, iw, perm[:nb], np.ones(nb, bool)) >= 0.99

    cv, cf = JIO.load_obj(route["spheres"]["cloth_obj"])
    wcv, wcf = JT.rewatertight(cv, cf, grid_res=24)
    gcv, gcf = PT.rewatertight(cv, cf, grid_res=24, device="cpu")
    np.testing.assert_array_equal(_exact_perm(gcv, wcv)[gcf], wcf)
    sd = mesh_sdf_host(zw["v"][:nb], wcv, wcf, sign_convention="pos_inside",
                       device="cpu")
    np.testing.assert_array_equal(np.nonzero(sd > 0)[0],
                                  iw["inside_body_index"])
    np.testing.assert_array_equal(np.nonzero(sd <= 0)[0],
                                  iw["outside_body_index"])


def test_merge_body_cloth_on_split_halves_matches_jax(route):
    """The small split scene's halves through train_d3h.py's route. Up
    to the decimation the two sides agree: the re-extracted body soup has
    the same counts, faces exact and verts abs 1e-5 once matched, and the
    decimation of one input is bit for bit. The vertex clustering snaps to
    a 512-cell grid, so a vertex whose position differs by an ulp on a
    cell border joins another cell: after it, at most 0.1% of the body's
    vertices, faces and inside/outside labels differ (the labels of 11 of
    the 33,236 matched body vertices on this scene); the cloth part is
    passed through exactly."""
    from d3human_tpu.pipeline import template as JT
    from d3human_tpu.utils import io as JIO
    from d3human_tpu_torch.pipeline import template as PT

    want, got = route["merges"]["split halves"]
    assert got["branch"] == "watertight_cloth"
    c = got["counts"]
    assert c["smpl_patch_faces"] == 0          # no SMPL face under the cloth

    # the stages up to the decimation, from the same soup
    bv, bf = JIO.load_obj(route["ch"]["jax"]["body"])
    bf = JT.trim_open_edges(bf, iters=2)
    wv, wf = JT.rewatertight(bv, bf, grid_res=24)
    gv, gf = PT.rewatertight(bv, bf, grid_res=24, device="cpu")
    np.testing.assert_array_equal(_exact_perm(gv, wv)[gf], wf)
    assert len(gf) == c["watertight_faces"]
    for a, b in zip(PT.cluster_decimate(wv, wf, n_cells=512,
                                        target_faces=300_000),
                    JT.cluster_decimate(wv, wf, n_cells=512,
                                        target_faces=300_000)):
        np.testing.assert_array_equal(a, b)

    # the merge
    zg, zw = _npz(got["mesh"]), _npz(want["mesh"])
    ig, iw = _npz(got["indices"]), _npz(want["indices"])
    assert all(zg[k].dtype == zw[k].dtype for k in zw)
    nb_g = c["body_verts"]
    nb_w = len(zw["v"]) - (len(zg["v"]) - nb_g)       # the same cloth
    lab_g, lab_w = zg["face_labels"], zw["face_labels"]
    assert abs(nb_g - nb_w) <= 1e-3 * nb_w
    assert abs(int((lab_g == 0).sum()) - int((lab_w == 0).sum())) \
        <= 1e-3 * (lab_w == 0).sum()
    np.testing.assert_array_equal(zg["v"][nb_g:], zw["v"][nb_w:])
    np.testing.assert_array_equal(zg["f"][lab_g == 1] - nb_g,
                                  zw["f"][lab_w == 1] - nb_w)
    perm, matched = _match_verts(zg["v"][:nb_g], zw["v"][:nb_w])
    assert matched.mean() >= 0.999
    assert _inside_agreement(ig, iw, perm, matched) >= 1 - 1e-3
    assert len(ig["inside_body_index"]) and len(ig["outside_body_index"])
    assert c["inside_body_verts"] + c["outside_body_verts"] == nb_g


def test_seq_template_and_tick_on_the_merge_match_jax(split_small, route):
    """build_seq_template of the small scene's merge (the JAX package's
    files) equals the JAX package's through template_from_jax; one seq tick
    on it against the JAX tick with the same draws: every key rel 5e-3,
    the counters exact (the seq tests' tolerances). The template of the
    port's own merge gives a tick with finite losses and covered
    pixels."""
    from d3human_tpu.pipeline.template import build_seq_template as jbuild
    from d3human_tpu.train import losses as JL
    from d3human_tpu_torch.convert import template_from_jax
    from d3human_tpu_torch.pipeline.template import build_seq_template
    from d3human_tpu_torch.train.step import stage_tick

    j, p = split_small
    want_mesh, got_mesh = route["merges"]["split halves"]
    jt = jbuild(os.path.dirname(want_mesh["mesh"]))
    pt = build_seq_template(os.path.dirname(want_mesh["mesh"]), device="cpu")
    conv = template_from_jax(to_np(jt), "cpu")
    for name in ("v", "f", "v_labels", "face_labels", "body_vidx",
                 "cloth_vidx", "body_f", "connected_faces"):
        g, w = getattr(pt, name), getattr(conv, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert pt.w_pts is None
    assert len(pt.body_vidx) > 0 and len(pt.cloth_vidx) > 0

    want = jax.jit(lambda params: JL.tick_seq(
        jax.random.PRNGKey(KEY), j["model"], params["geometry"],
        params["pose"], j["tex"], params["material"], j["perceptual"],
        j["perc_params"], jt, j["target"], IT, j["cfg"],
        MERGE_JAX_RASTER_OPTS))(j["params"])
    draws = {"render": render_draws(jax.random.PRNGKey(KEY),
                                    *compact_draw_shapes(j["cfg"]))}
    own = build_seq_template(os.path.dirname(got_mesh["mesh"]), device="cpu")
    outs = []
    for template in (pt, own):
        with torch.no_grad():
            outs.append({k: float(v) for k, v in stage_tick(
                "seq", p["model"], p["tex"], p["perceptual"],
                p["perc_params"], p["params"], p["target"], IT, p["cfg"],
                RASTER_OPTS, draws=draws, template=template).items()})
    got = outs[0]
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), got[k]
        if k in ("n_big_faces", "n_max_tile"):
            assert g == w, (k, g, w)
        else:
            assert g == pytest.approx(w, rel=5e-3, abs=1e-6), (k, g, w)
    for out in outs:
        assert out["cap_cov"] > 0
        assert all(np.isfinite(v) for v in out.values())
