"""The port's seq-stage slice against the JAX package on the small scene
(``__graft_entry__._small_setup(n_frames=2)`` with the synthetic body as
the merged template, its faces labelled by the scene's garment band, the
target JAX's ``frame_target(0)``), with the JAX package's random draws
injected: ``DeformMLP``, the smoothness and collision losses, the host-side
template builders, the blocked ``knn1``, ``seq_deformed``, ``tick_seq`` and
its gradients, one ``make_train_step("seq")`` step and the seq optimizer
groups."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (
    IT, JAX_RASTER_OPTS, KEY, RASTER_OPTS, compact_draw_shapes, port_small,
    render_draws, to_np,
)

torch.set_num_threads(1)

EXACT = ("n_big_faces", "n_max_tile")


# ---------------------------------------------------------------- helpers

def _jax_template(v, f, face_labels, v_labels, w_pts=None):
    """A JAX ``SeqTemplate`` of a labelled mesh (as bench.py builds it)."""
    from d3human_tpu.models.geometry import SeqTemplate
    from d3human_tpu.ops.mesh_ops import find_connected_faces

    connected, _ = find_connected_faces(f)
    return SeqTemplate(
        v=jnp.asarray(v), f=jnp.asarray(f, jnp.int32),
        v_labels=jnp.asarray(v_labels),
        face_labels=jnp.asarray(face_labels, jnp.int32),
        body_vidx=jnp.asarray(np.nonzero(v_labels == 0)[0], jnp.int32),
        cloth_vidx=jnp.asarray(np.nonzero(v_labels == 1)[0], jnp.int32),
        body_f=jnp.asarray(f[face_labels == 0], jnp.int32),
        connected_faces=jnp.asarray(connected, jnp.int32), w_pts=w_pts)


def _any_cloth_labels(f, face_labels, n_verts):
    v_labels = np.zeros(n_verts, np.int64)
    v_labels[np.unique(f[face_labels == 1])] = 1
    return v_labels


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _flat(tree):
    from d3human_tpu_torch.train.optim import named_leaves

    return {k: v.numpy() for k, v in named_leaves(_to_torch(tree))}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _rel_max(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def _seq_draws(cfg, key=KEY):
    """The render's normals ``tick_seq`` draws from ``PRNGKey(key)``: the
    tick hands its key to the render unsplit (losses.py:371)."""
    return {"render": render_draws(jax.random.PRNGKey(key),
                                   *compact_draw_shapes(cfg))}


def _with_optim(cfg):
    """No warm-up: the schedule starts at lr 0 otherwise."""
    return dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, warmup_iter=0))


@pytest.fixture(scope="module")
def both():
    """(JAX dict with its template, the port's dict with its template)."""
    from __graft_entry__ import _small_setup

    cfg, scene, model, tex, perceptual, perc_params, params = \
        _small_setup(n_frames=2)
    v = np.asarray(scene.model.v_template)
    f = np.asarray(scene.model.faces)
    labels = scene.garment_faces
    template = _jax_template(v, f, labels,
                             _any_cloth_labels(f, labels, len(v)))
    # the reference's table init is ~1e-4, which leaves the albedo flat at
    # 0.5 and the material's gradient all rounding: scale it up so the
    # texture carries signal
    params = dict(params, material=dict(params["material"]))
    params["material"]["encoder"] = dict(
        params["material"]["encoder"],
        table=[t * 3e3 for t in params["material"]["encoder"]["table"]])
    j = dict(cfg=_with_optim(cfg), scene=scene, model=model, tex=tex,
             perceptual=perceptual, perc_params=perc_params, params=params,
             target=scene.frame_target(0), template=template)
    return j, _port(j)


def _port(j):
    from d3human_tpu_torch.convert import template_from_jax

    p = port_small(j)
    p["template"] = template_from_jax(to_np(j["template"]), "cpu")
    return p


@pytest.fixture(scope="module")
def jax_grad(both):
    """One compiled (grads, aux) of the JAX tick."""
    from d3human_tpu.train import losses as JL

    j, _ = both

    def loss(params, it):
        out = JL.tick_seq(
            jax.random.PRNGKey(KEY), j["model"], params["geometry"],
            params["pose"], j["tex"], params["material"], j["perceptual"],
            j["perc_params"], j["template"], j["target"], it, j["cfg"],
            JAX_RASTER_OPTS)
        return out["total"], out

    return jax.jit(jax.grad(loss, has_aux=True))(j["params"], jnp.int32(IT))


@pytest.fixture(scope="module")
def subdivided():
    """The bench's template recipe at 2 subdivisions, no decimation:
    (v, f, face labels, vertex labels) as numpy, from the port."""
    from d3human_tpu_torch.data.synthetic import make_scene, seq_bench_template

    t = seq_bench_template(make_scene(device="cpu"), n_subdiv=2,
                           target_faces=None, device="cpu")
    return (t.v.numpy(), t.f.numpy().astype(np.int64),
            t.face_labels.numpy().astype(np.int64), t.v_labels.numpy())


# ---------------------------------------------------------------- modules

def test_deform_mlp_matches_jax():
    """DeformMLP: the pose code first in the input, the skip layer takes
    the encoding alone; the same weights give the same offsets (rel 1e-5),
    and both packages build the same layer shapes at full width."""
    from d3human_tpu.models.fields import DeformMLP as JaxDeformMLP
    from d3human_tpu_torch.models.fields import DeformMLP

    rng = np.random.default_rng(0)
    x = rng.uniform(-0.8, 0.8, (257, 3)).astype(np.float32)
    code = (0.1 * rng.normal(size=(1, 1, 136))).astype(np.float32)
    kw = dict(n_freq=8, d_hidden=32, n_hidden=3, skip_in=(1,), pose_dim=136)
    jm, pm = JaxDeformMLP(**kw), DeformMLP(**kw)
    shapes = [(187, 32), (32, 32), (32 + 51, 32), (32, 32), (32, 3)]
    assert [tuple(lay["w"].shape) for lay in pm.init(
        torch.Generator().manual_seed(0), "cpu")["layers"]] == shapes
    layers = [{"w": rng.uniform(-0.2, 0.2, s).astype(np.float32),
               "b": rng.uniform(-0.2, 0.2, s[1:]).astype(np.float32)}
              for s in shapes]
    want = np.asarray(jax.jit(jm.apply)({"layers": layers}, jnp.asarray(x),
                                        jnp.asarray(code)))
    got = pm.apply(_to_torch({"layers": layers}), torch.as_tensor(x),
                   torch.as_tensor(code)).numpy()
    assert got.shape == (257, 3)
    assert _rel_max(got, want) <= 1e-5
    full_j = jax.eval_shape(JaxDeformMLP().init, jax.random.PRNGKey(0))
    full_p = DeformMLP().init(torch.Generator().manual_seed(0), "cpu")
    assert ([tuple(np.shape(lay["w"])) for lay in full_j["layers"]]
            == [tuple(lay["w"].shape) for lay in full_p["layers"]])


@pytest.mark.parametrize("deform", [False, True])
def test_bf16_mlps_match_jax(deform):
    """MLP and DeformMLP with use_bfloat16 (bf16 products, float32
    accumulation, float32 bias and output layer) against JAX's on the
    CPU, weights scaled x3 so the hidden layers saturate less: output and
    point gradient within rel-L2 1e-3 and within a tenth of JAX's own
    bf16-to-float32 distance. Not 1e-5: a hidden value whose float32 sum
    lies at a bf16 rounding tie rounds the other way in the other
    package's accumulation order, which moves it by 2^-8 of itself."""
    from d3human_tpu.models.fields import MLP as JaxMLP
    from d3human_tpu.models.fields import DeformMLP as JaxDeformMLP
    from d3human_tpu_torch.models.fields import MLP, DeformMLP

    rng = np.random.default_rng(4)
    kw = dict(n_freq=6, d_hidden=64, n_hidden=4, skip_in=(2,))
    jcls, pcls = (JaxDeformMLP, DeformMLP) if deform else (JaxMLP, MLP)
    if deform:
        kw.update(n_freq=8, pose_dim=136)
    params = jax.tree.map(lambda a: a * 3.0, jcls(**kw).init(
        jax.random.PRNGKey(1)))
    x = rng.uniform(-0.8, 0.8, (513, 3)).astype(np.float32)
    extra = ((0.1 * rng.normal(size=(1, 1, 136))).astype(np.float32),) \
        if deform else ()

    def jax_run(bf16):
        m = jcls(use_bfloat16=bf16, **kw)

        def f(xx):
            y = m.apply(params, xx, *map(jnp.asarray, extra))
            return (y * y).sum(), y

        (_, y), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(x))
        return np.asarray(y), np.asarray(g)

    want, want32 = jax_run(True), jax_run(False)
    xt = torch.as_tensor(x).requires_grad_(True)
    y = pcls(use_bfloat16=True, **kw).apply(
        _to_torch(params), xt, *map(torch.as_tensor, extra))
    (y * y).sum().backward()
    for got, w, w32 in zip((y.detach().numpy(), xt.grad.numpy()), want,
                           want32):
        assert _rel_l2(got, w) <= min(1e-3, 0.1 * _rel_l2(w, w32))


def test_smoothness_and_collision_losses_match_jax(subdivided):
    """laplacian_uniform_loss, normal_consistency_loss and collision_loss
    on a perturbed template (8,832 faces, so the collision search walks
    two reference blocks): values rel 1e-5, gradients w.r.t. the vertices
    rel-L2 1e-4. The collision's body faces index all vertices here, so
    no id is clamped and no two face centres tie (the tick's clamped ids
    make degenerate duplicates, whose near-ties the two packages' float
    rounding may break apart differently)."""
    from d3human_tpu.models.geometry import collision_loss as jax_colli
    from d3human_tpu.ops import mesh_ops as jm
    from d3human_tpu_torch.models.geometry import collision_loss
    from d3human_tpu_torch.ops import mesh_ops as pm

    v, f, labels, v_labels = subdivided
    connected, _ = pm.find_connected_faces(f)
    rng = np.random.default_rng(1)
    pos = (v + 0.004 * rng.normal(size=v.shape)).astype(np.float32)
    cloth = np.nonzero(v_labels == 1)[0]
    body_f = f[labels == 0]

    jax_fns = {
        "laplacian": lambda x: jm.laplacian_uniform_loss(x, jnp.asarray(f)),
        "normal_consistency": lambda x: jm.normal_consistency_loss(
            x, jnp.asarray(f), jnp.asarray(connected)),
        "collision": lambda x: jax_colli(x[cloth], x,
                                         jnp.asarray(body_f), 0.005),
    }
    tf, tc = torch.as_tensor(f), torch.as_tensor(connected)
    port_fns = {
        "laplacian": lambda x: pm.laplacian_uniform_loss(x, tf),
        "normal_consistency": lambda x: pm.normal_consistency_loss(x, tf, tc),
        "collision": lambda x: collision_loss(
            x[torch.as_tensor(cloth)], x, torch.as_tensor(body_f), 0.005),
    }
    jax_out = jax.jit(lambda x: {name: jax.value_and_grad(fn)(x)
                                 for name, fn in jax_fns.items()})(
        jnp.asarray(pos))
    for name, (want, jg) in jax_out.items():
        x = torch.as_tensor(pos).requires_grad_(True)
        got = port_fns[name](x)
        (tg,) = torch.autograd.grad(got, x)
        got = got.detach()
        assert float(want) > 0, name
        assert float(got) == pytest.approx(float(want), rel=1e-5), name
        assert _rel_l2(tg.numpy(), np.asarray(jg)) <= 1e-4, name


def test_host_template_builders_equal_jax(subdivided, tmp_path):
    """find_connected_faces, midpoint_subdivide_in_bbox (part of the mesh
    in the box: border T-junctions), cluster_decimate (coarsening to a face
    budget) and build_seq_template from a written npz: equal arrays."""
    from d3human_tpu.ops.mesh_ops import find_connected_faces as jax_cf
    from d3human_tpu.pipeline import template as jt
    from d3human_tpu_torch.ops.mesh_ops import find_connected_faces
    from d3human_tpu_torch.pipeline import template as pt

    v, f, labels, _ = subdivided
    for a, b in zip(find_connected_faces(f), jax_cf(f)):
        assert np.array_equal(a, b)
    box = (np.array([-1.0, 0.2, -1.0]), np.array([1.0, 1.0, 1.0]))
    got, want = pt.midpoint_subdivide_in_bbox(v, f, box), \
        jt.midpoint_subdivide_in_bbox(v, f, box)
    assert len(f) < len(got[1]) < 4 * len(f)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got, want = pt.cluster_decimate(v, f, n_cells=96, target_faces=3000), \
        jt.cluster_decimate(v, f, n_cells=96, target_faces=3000)
    assert len(got[1]) <= 3000
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    np.savez(tmp_path / "merge_body_cloth.npz", v=v, f=f, face_labels=labels)
    want = jt.build_seq_template(str(tmp_path))
    got = pt.build_seq_template(str(tmp_path), device="cpu")
    for field in dataclasses.fields(got):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if b is None:
            assert a is None
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, field.name
        assert np.array_equal(a.numpy(), b), field.name


@pytest.mark.parametrize("M", [100, 1000, 4096, 5000, 9000])
def test_knn1_blocked_equals_unblocked_and_jax(M):
    """knn1 over reference blocks of 1,000 (M not a multiple of it, or
    below it) against one block of all M, and against JAX knn on points
    without ties: equal indices and distances. Exact ties (duplicated
    references in other blocks) go to the lower index."""
    from d3human_tpu.ops.knn import knn
    from d3human_tpu_torch.ops.knn import knn1

    rng = np.random.default_rng(M)
    q = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (M, 3)).astype(np.float32)
    tq, tr = torch.as_tensor(q), torch.as_tensor(r)
    d_one, i_one = knn1(tq, tr, block=M)
    d_blk, i_blk = knn1(tq, tr, block=1000)
    assert torch.equal(i_one, i_blk) and torch.equal(d_one, d_blk)
    jd, ji = knn(jnp.asarray(q), jnp.asarray(r), k=1)
    assert np.array_equal(i_blk.numpy(), np.asarray(ji)[:, 0])
    assert np.allclose(d_blk.numpy(), np.asarray(jd)[:, 0], rtol=1e-6,
                       atol=1e-7)

    # every winner copied to the end: the copies tie exactly and lose
    dup = torch.cat([tr, tr[i_one]])
    _, i_dup = knn1(tq, dup, block=1000)
    assert torch.equal(i_dup, i_one)


def test_knn1_scratch_is_bounded(monkeypatch):
    """No distance block wider than the reference block, and none larger
    than SCRATCH_ELEMS floats: the query blocks shrink to fit."""
    from torch.overrides import TorchFunctionMode

    from d3human_tpu_torch.ops import knn as knn_mod

    class Shapes(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and out.dim() == 2:
                self.seen.append(tuple(out.shape))
            return out

    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.uniform(-1, 1, (900, 3)).astype(np.float32))
    r = torch.as_tensor(rng.uniform(-1, 1, (2500, 3)).astype(np.float32))
    want = knn_mod.knn1(q, r, block=2500)
    monkeypatch.setattr(knn_mod, "SCRATCH_ELEMS", 64 * 256)
    with Shapes() as mode:
        got = knn_mod.knn1(q, r, block=256)
    blocks = [s for s in mode.seen if s[1] > 3]
    assert blocks and max(s[1] for s in blocks) <= 256
    assert max(s[0] * s[1] for s in blocks) <= 64 * 256
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("static", [False, True])
def test_seq_deformed_matches_jax(both, static):
    """Posed template and offsets rel 1e-5, with the skinning weights
    transferred at the deformed positions (None) or once at the rest
    template (static; the weights themselves within rel 1e-6: JAX's
    K-neighbour blend of one neighbour rounds them by an ulp or so)."""
    j, p = both
    jt, pt = j["template"], p["template"]
    if static:
        jw = jax.jit(j["model"].static_skin_weights)(jt.v)
        pw = p["model"].static_skin_weights(pt.v)
        assert _rel_max(pw.numpy(), np.asarray(jw)) <= 1e-6
        jt = dataclasses.replace(jt, w_pts=jw)
        pt = dataclasses.replace(pt, w_pts=pw)
    want_posed, want_delta = jax.jit(j["model"].seq_deformed)(
        j["params"]["geometry"], jt, j["params"]["pose"], 0)
    with torch.no_grad():
        posed, delta = p["model"].seq_deformed(
            p["params"]["geometry"], pt, p["params"]["pose"], 0)
    assert _rel_max(posed.numpy(), np.asarray(want_posed)) <= 1e-5
    assert _rel_max(delta.numpy(), np.asarray(want_delta)) <= 1e-5


# ---------------------------------------------------------------- slice

def test_tick_seq_and_gradients_match_jax(both, jax_grad):
    """Every key rel 5e-3 (counters exact); the gradients of the nonrigid
    MLP and of fix_code rel-L2 1e-3; the leaves no forward path reads
    (body_nonrigid, cond, render_cond) get no gradient, zero in JAX."""
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import loss_and_grads

    j, p = both
    jg, want = jax_grad
    paths = [k for k, t in named_leaves(p["params"]) if t.is_floating_point()]
    got, tg = loss_and_grads(
        "seq", p["model"], p["tex"], p["perceptual"], p["perc_params"],
        p["params"], p["target"], IT, p["cfg"], paths, RASTER_OPTS,
        draws=_seq_draws(j["cfg"]), template=p["template"])
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        if k in EXACT:
            assert g == w, (k, g, w)
        else:
            assert g == pytest.approx(w, rel=5e-3, abs=1e-6), (k, g, w)
    for k in ("cap_cov", "laplacian_loss", "colli_loss", "nds_normal_loss",
              "cloth_msk_loss", "mtl_smooth_loss", "delta_loss"):
        assert got[k] > 0, k
    jg = _flat(jg)
    checked = 0
    for k in paths:
        if "geometry/nonrigid" in k or k == "geometry/fix_code":
            assert np.linalg.norm(jg[k]) > 0, k
            assert _rel_l2(tg[k].numpy(), jg[k]) <= 1e-3, k
            checked += 1
        elif any(n in k for n in ("body_nonrigid", "cond", "render_cond")):
            assert tg[k] is None and np.linalg.norm(jg[k]) == 0, k
    assert checked == 2 * (p["cfg"].field.n_hidden + 2) + 1


def test_seq_train_step_matches_jax(both, jax_grad):
    """One seq step from step 0 (no warm-up): every parameter within rel-L2
    1e-4 of the JAX package's optimizer applied to its own gradients, every
    leaf of the frozen group (pose included) unchanged bit for bit, the
    nonrigid MLP and the material moved."""
    import optax
    from d3human_tpu.train import step as JS
    from d3human_tpu_torch.train.optim import named_leaves, param_label
    from d3human_tpu_torch.train.step import init_state, make_train_step

    j, _ = both
    p = _port(j)                          # fresh: the step updates in place
    jstate, tx = JS.init_state("seq", j["params"], j["cfg"])
    jg, jaux = jax_grad
    updates, _ = jax.jit(tx.update)(jg, jstate.opt_state, j["params"])
    want = _flat(JS._post_step(optax.apply_updates(j["params"], updates),
                               j["model"]))

    before = {k: v.clone() for k, v in named_leaves(p["params"])}
    state = init_state("seq", p["params"], p["cfg"])
    step_fn = make_train_step("seq", p["model"], p["tex"], p["perceptual"],
                              p["perc_params"], p["cfg"], RASTER_OPTS,
                              template=p["template"])
    state, m = step_fn(state, p["target"], None, draws=_seq_draws(j["cfg"]))
    assert state.step == 1 and state.opt.count == 1
    moved, frozen = set(), 0
    for k, t in named_leaves(state.params):
        if not t.is_floating_point():
            continue
        if param_label("seq", k) == "frozen":
            assert torch.equal(t, before[k]), k
            frozen += 1
        w = want[k]
        if np.linalg.norm(w) == 0:
            assert np.linalg.norm(t.numpy()) == 0, k
        else:
            assert _rel_l2(t.numpy(), w) <= 1e-4, (k, _rel_l2(t.numpy(), w))
        if not torch.equal(t, before[k]):
            moved.add(k.split("/")[1] if k.startswith("geometry")
                      else k.split("/")[0])
    assert moved == {"nonrigid", "material"}
    assert frozen > 10
    assert float(m["total"]) == pytest.approx(float(jaux["total"]), rel=5e-3)


def test_seq_step_transfers_static_weights_once(both):
    """Weights transferred once at the rest template (as the stage driver
    does under stages.seq_static_skin_weights) and carried by the template
    are the ones the step uses: its loss equals the tick's on that
    template, and differs from the per-step transfer."""
    from d3human_tpu_torch.train.step import (
        init_state, make_train_step, stage_tick,
    )

    j, _ = both
    p = _port(j)
    draws = _seq_draws(j["cfg"])
    static = dataclasses.replace(p["template"], w_pts=p["model"]
                                 .static_skin_weights(p["template"].v))
    with torch.no_grad():
        want, per_step = (float(stage_tick(
            "seq", p["model"], p["tex"], p["perceptual"], p["perc_params"],
            p["params"], p["target"], 0, p["cfg"], RASTER_OPTS, draws=draws,
            template=t)["total"]) for t in (static, p["template"]))
    step_fn = make_train_step("seq", p["model"], p["tex"], p["perceptual"],
                              p["perc_params"], p["cfg"], RASTER_OPTS,
                              template=static)
    _, m = step_fn(init_state("seq", p["params"], p["cfg"]), p["target"],
                   None, draws=draws)
    assert float(m["total"]) == want != per_step


@pytest.mark.parametrize("stage", ["init", "split", "seq"])
def test_geometry_labels_equal_jax(both, stage):
    """The label of every geometry leaf equals JAX _geometry_label of its
    path; in seq the pose is frozen, the material and light keep theirs."""
    from d3human_tpu.train.optim import _geometry_label
    from d3human_tpu_torch.train.optim import param_label

    j, _ = both
    n = 0
    for path, _leaf in jax.tree_util.tree_flatten_with_path(
            j["params"])[0]:
        ks = jax.tree_util.keystr(path)
        port_path = "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                             for e in path)
        top = port_path.split("/", 1)[0]
        got = param_label(stage, port_path)
        if top == "geometry":
            assert got == _geometry_label(stage, ks), port_path
            n += 1
        elif top == "pose":
            assert got == ("frozen" if stage == "seq" else "pose")
        else:
            assert got == top
    assert n > 20
    if stage == "seq":
        labels = {param_label("seq", f"geometry/{k}")
                  for k in ("nonrigid/layers/0/w", "body_nonrigid/layers/0/b",
                            "cond", "render_cond")}
        assert labels == {"x1e-2"}
        assert param_label("seq", "geometry/fix_code") == "frozen"


def test_chip_smoke_seq_rehearsal():
    """chip_smoke.py's seq set-up at its CPU-sized scale through the path
    the script drives on the card: one seq step from the generator (loss
    keys finite, the counters the script checks) and the tick with the
    script's injected draws, twice alike."""
    import chip_smoke
    from d3human_tpu_torch.train.step import stage_tick

    sc = chip_smoke.build_scene("tiny", "cpu", seed_steps=0)
    info = chip_smoke.add_seq(sc, "tiny")
    assert info["n_faces"] == len(sc["seq_template"].f) > 0
    gen = torch.Generator().manual_seed(0)
    state, m = chip_smoke.stage_step_fn(sc, "seq")(sc["seq_state"],
                                                   sc["target"], gen)
    assert state.step == 1
    chip_smoke.check_step_metrics("seq", chip_smoke.scalars(m), "seq")
    cfg, raster_opts = chip_smoke.stage_cfg(sc, "seq")
    outs = []
    for _ in range(2):
        with torch.no_grad():
            outs.append(chip_smoke.scalars(stage_tick(
                "seq", sc["model"], sc["tex"], sc["perceptual"],
                sc["perc_params"], sc["params"], sc["target"], 7, cfg,
                raster_opts, draws=chip_smoke.tick_draws(cfg, "seq", seed=1),
                template=sc["seq_template"])))
    assert outs[0] == outs[1]
    assert all(math.isfinite(v) for v in outs[0].values())


def test_chip_smoke_small_bf16_rehearsal():
    """chip_smoke.py's small_bf16 check with the CPU as the device: the
    comparison is then exact, and the bf16 MLP stands apart from the
    float32 one."""
    import chip_smoke

    out = chip_smoke.phase_small_bf16(1024, "cpu")
    assert set(out["rel_l2"].values()) == {0.0}
    assert min(out["bf16_vs_f32"].values()) > 1e-4


def test_chip_smoke_parallel_rehearsal(tmp_path):
    """chip_smoke.py's parallel_seq and dp_step phases on the tiny scene on
    a gloo group of one (the runner bit for bit its serial loops, the DP
    update within 1e-5 of its oracle, checked inside), and
    parallel_world2 (world 2 bit for bit world 1 on the CPU)."""
    import torch.distributed as dist

    import chip_smoke

    sc = chip_smoke.build_scene("tiny", "cpu", seed_steps=50)
    chip_smoke.add_seq(sc, "tiny")
    assert chip_smoke.init_world1("cpu", str(tmp_path / "group"))
    try:
        par = chip_smoke.phase_parallel_seq(sc, "cpu")
        dp = chip_smoke.phase_dp_step(sc, "cpu")
    finally:
        dist.destroy_process_group()
    assert par["group"] and par["bitwise"] and par["frames_differ_in"] > 0
    assert dp["init"]["bitwise"] and dp["split"]["bitwise"]
    inputs = chip_smoke.merge_recorded(par["inputs"], dp["inputs"])
    assert set(inputs) == {"first_k_indices", "coo_scatter_add",
                           "resolve_tiles"}
    w2 = chip_smoke.phase_parallel_world2(chip_smoke.world2_scene("cpu"),
                                          "cpu", str(tmp_path / "w2"),
                                          "tiny")
    assert w2["bitwise"]


def test_chip_smoke_field_setup_and_surgery_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's field_setup, surgery and surgery_seq_step phases at
    the CPU-sized scale through the functions the script runs on the card:
    the checks of each phase hold, the field set-up leaves the scene's
    parameters as they were, the surgery's template carries both labels
    and every host SDF query went to the native engine, the recorded
    kernel inputs cover every first_k and scatter call of the surgery (the
    extraction's two compactions and corner count, auto_normals' sums),
    and a seq step on it (on a copy of the parameters) gives finite losses
    and covered pixels."""
    import chip_smoke
    from d3human_tpu_torch.ops import compaction, scatter
    from d3human_tpu_torch.train.optim import named_leaves

    sc = chip_smoke.build_scene("tiny", "cpu", seed_steps=50)
    chip_smoke.add_seq(sc, "tiny")
    before = {k: v.clone() for k, v in named_leaves(sc["params"])}
    fs = chip_smoke.phase_field_setup(sc, "tiny", steps=3)
    assert fs["chunked_forward_rel"] <= 1e-6
    assert fs["chunked_grad_rel_l2"] <= 1e-5
    assert fs["points"] > fs["sdf_chunk"]
    assert fs["pretrain_sdf_loss"][1] < fs["pretrain_sdf_loss"][0]
    plain = {"first_k_indices": 0, "coo_scatter_add": 0}

    def counted(kernel, fn):
        def run(*args, **kw):
            plain[kernel] += 1
            return fn(*args, **kw)
        return run

    # on CPU tensors the wrappers run their plain versions
    monkeypatch.setattr(compaction, "first_k_plain", counted(
        "first_k_indices", compaction.first_k_plain))
    monkeypatch.setattr(scatter, "coo_scatter_add_plain", counted(
        "coo_scatter_add", scatter.coo_scatter_add_plain))
    sur = chip_smoke.phase_surgery(sc, str(tmp_path / "surgery"))
    monkeypatch.undo()
    template = sur.pop("template")
    inputs = sur.pop("inputs")
    assert {k: sum(s["calls"] for s in v.values())
            for k, v in inputs.items()} == plain
    assert min(plain.values()) > 0
    sites = {k: sorted(site.split(":")[0] for site in v)
             for k, v in inputs.items()}
    assert sites == {"first_k_indices": ["marching_tets.py"] * 2,
                     "coo_scatter_add": ["marching_tets.py", "mesh_ops.py"]}
    for s in inputs["first_k_indices"].values():
        mask, k, fill = s["args"]
        assert fill == mask.numel() and k > 0
    for site, s in inputs["coo_scatter_add"].items():
        r = chip_smoke.check_scatter_values(site, *s["args"])
        assert r["bitwise"] and r["kernel_vs_float64"] <= r["float32_bound_max"]
    assert template.f.shape[0] < 1 << 20
    assert len(template.body_vidx) > 0 and len(template.cloth_vidx) > 0
    ssc = chip_smoke.surgery_scene(sc, template)
    state, m = chip_smoke.stage_step_fn(ssc, "seq")(
        ssc["seq_state"], ssc["target"], torch.Generator().manual_seed(0))
    assert state.step == 1
    chip_smoke.check_step_metrics("seq", chip_smoke.scalars(m), "surgery")
    for k, v in named_leaves(sc["params"]):
        assert torch.equal(v, before[k]), k
