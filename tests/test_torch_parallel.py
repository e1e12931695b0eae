"""The port's parallel paths (``d3human_tpu_torch/parallel/`` and
``train/stages.py:run_seq_stage_parallel``) against the JAX package's
``parallel/`` on the small scenes of the parity tests: the seq runner on
``test_torch_seq_step.py``'s scene (the body as the template) with JAX's
per-frame draws injected, the DP step on ``torch_parity.jax_small``'s
init scene with JAX's per-example draws; world 2 (two gloo processes,
``chip_smoke.spawn_parallel``) against world 1 bit for bit; the JAX
optimizer choices of both paths, each by its own test; the driver's
padding and files. The JAX side runs on the virtual CPU devices of
``tests/conftest.py`` with the raster options of ``tests/test_parallel.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_seq_step import _flat, _port, _rel_l2, both  # noqa: F401
from torch_parity import (
    KEY, RASTER_OPTS, compact_draw_shapes, init_draws, jax_small, port_small,
    render_draws, to_np,
)

torch.set_num_threads(1)

N_FRAMES, N_ITERS, B = 2, 2, 4


def _port_target(jt):
    t = {k: torch.as_tensor(np.array(v)) for k, v in jt.items()}
    t["frame_idx"] = int(jt["frame_idx"])
    return t


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _assert_params_close(got, want, tol):
    """Every floating leaf of ``got`` (the port's tree) within rel-L2
    ``tol`` of ``want`` (a flat JAX tree); zero where JAX's is zero."""
    from d3human_tpu_torch.train.optim import named_leaves

    n = 0
    for k, t in named_leaves(got):
        if not t.is_floating_point():
            continue
        w, g = want[k], t.detach().numpy()
        if np.linalg.norm(w) == 0:
            assert np.linalg.norm(g) == 0, k
        else:
            assert _rel_l2(g, w) <= tol, (k, _rel_l2(g, w))
            n += 1
    assert n > 10


def _assert_trees_equal(got, want):
    from d3human_tpu_torch.train.optim import named_leaves

    w = dict(named_leaves(want))
    g = dict(named_leaves(got))
    assert set(g) == set(w)
    for k in w:
        assert torch.equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def seq_case(both):  # noqa: F811
    """(JAX dict, port dict, JAX targets, the port's targets, the draws of
    frame f's iteration it as JAX's runner makes them)."""
    j, p = both
    jt = [j["scene"].frame_target(f) for f in range(N_FRAMES)]
    keys = jax.random.split(jax.random.PRNGKey(KEY), N_FRAMES)
    shapes = compact_draw_shapes(j["cfg"])

    def draws(f, it):
        return {"render": render_draws(jax.random.fold_in(keys[f], it),
                                       *shapes)}

    return j, p, jt, [_port_target(t) for t in jt], draws


@pytest.fixture(scope="module")
def init_case():
    """The init scene in both packages, no warm-up in the schedule and
    ``clip_max_norm`` 0 (the DP step clips at 1.0 all the same), B
    targets (frames 0, 1, 0, 1) and JAX's per-example keys."""
    j = jax_small()
    j["cfg"] = dataclasses.replace(j["cfg"], optim=dataclasses.replace(
        j["cfg"].optim, warmup_iter=0, clip_max_norm=0.0))
    p = port_small(j)
    jt = [j["scene"].frame_target(i % j["scene"].n_frames) for i in range(B)]
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    return j, p, jt, [_port_target(t) for t in jt], keys


@pytest.fixture(scope="module")
def jax_runner(seq_case):
    """JAX make_parallel_seq_runner on 2 CPU devices: (per-frame params as
    numpy, totals [N_FRAMES, N_ITERS])."""
    from d3human_tpu.parallel.frames import make_parallel_seq_runner
    from d3human_tpu.parallel.mesh import make_frame_mesh

    j, _, jt, _, _ = seq_case
    launch, _ = make_parallel_seq_runner(
        j["model"], j["tex"], j["perceptual"], j["perc_params"],
        j["template"], j["cfg"], N_FRAMES, N_ITERS,
        mesh=make_frame_mesh(2), raster_opts=RASTER_OPTS)
    per_frame, totals = launch(j["params"], _stack(jt),
                               jax.random.PRNGKey(KEY))
    return to_np(per_frame), np.asarray(totals)


@pytest.fixture(scope="module")
def port_runner(seq_case):
    """The port's runner at world 1 (no process group) with JAX's draws."""
    from d3human_tpu_torch.parallel.frames import make_parallel_seq_runner

    _, p, _, pt, draws = seq_case
    launch, mesh = make_parallel_seq_runner(
        p["model"], p["tex"], p["perceptual"], p["perc_params"],
        p["template"], p["cfg"], N_FRAMES, N_ITERS, raster_opts=RASTER_OPTS)
    assert mesh.world == 1 and mesh.group is None
    return launch(p["params"], pt, 0, draws=draws)


@pytest.fixture(scope="module")
def jax_dp(init_case):
    """One JAX make_dp_train_step("init") over B examples on 4 CPU
    devices: (params as numpy, aux)."""
    from d3human_tpu.parallel.frames import make_dp_train_step
    from d3human_tpu.parallel.mesh import make_data_mesh
    from d3human_tpu.train.step import TrainState

    j, _, jt, _, keys = init_case
    dp_step, tx, _, _ = make_dp_train_step(
        "init", j["model"], j["tex"], j["perceptual"], j["perc_params"],
        j["cfg"], raster_opts=RASTER_OPTS, mesh=make_data_mesh(4))
    state = TrainState(params=j["params"], opt_state=tx.init(j["params"]),
                       step=jnp.zeros((), jnp.int32))
    new_state, aux = dp_step(state, _stack(jt), keys)
    return to_np(new_state.params), to_np(aux)


def _dp_job(init_case):
    j, p, _, pt, keys = init_case
    return dict(stage="init", cfg=p["cfg"], targets=pt,
                draws=[init_draws(j["cfg"], keys[i]) for i in range(B)],
                step=0, model=p["model"], tex=p["tex"],
                perceptual=p["perceptual"], perc_params=p["perc_params"],
                params=p["params"], raster_opts=RASTER_OPTS)


@pytest.fixture(scope="module")
def world2(seq_case, init_case, tmp_path_factory):
    """The runner (generator draws), the DP step (JAX's draws) and the
    driver (3 frames) in two gloo processes, and the runner and the DP
    step in this process (world 1, no group): (rank results, world 1
    results, the driver's out dir)."""
    import chip_smoke

    j, p, _, pt, _ = seq_case
    root = tmp_path_factory.mktemp("world2")
    cfg = dataclasses.replace(p["cfg"], stages=dataclasses.replace(
        p["cfg"].stages, seq_iters_first=2, seq_max_frames=3,
        log_interval=1))
    seq = dict(model=p["model"], tex=p["tex"], perceptual=p["perceptual"],
               perc_params=p["perc_params"], params=p["params"],
               raster_opts=RASTER_OPTS, template=p["template"])
    job = dict(runner=dict(seq, cfg=p["cfg"], targets=pt, seed=3,
                           n_iters=N_ITERS),
               dp=_dp_job(init_case),
               driver=dict(seq, cfg=cfg, targets=pt + [pt[0]], seed=3,
                           save_path=str(root / "seq")))
    ranks = chip_smoke.spawn_parallel(2, job, str(root / "spawn"))
    w1 = chip_smoke.parallel_jobs({k: job[k] for k in ("runner", "dp")})
    return ranks, w1, str(root / "seq")


# ---------------------------------------------------------------- mesh

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_shard_leading_blocks_equal_jax_shards(n_dev):
    """Each rank's block of a leading axis of 8 is the index range of its
    device's shard under JAX's ``shard_leading`` (NamedSharding P(axis))."""
    from d3human_tpu.parallel.mesh import make_frame_mesh
    from d3human_tpu.parallel.mesh import shard_leading as jax_shard
    from d3human_tpu_torch.parallel.mesh import Mesh, shard_leading

    mesh = make_frame_mesh(n_dev)
    x = jax.device_put(jnp.arange(8), jax_shard(mesh, "frames"))
    devs = list(mesh.devices.flat)
    want = {}
    for s in x.addressable_shards:
        sl = s.index[0]
        want[devs.index(s.device)] = range(sl.start or 0,
                                           8 if sl.stop is None else sl.stop)
    got = {r: shard_leading(Mesh("frames", n_dev, r, torch.device("cpu")), 8)
           for r in range(n_dev)}
    assert got == want
    with pytest.raises(ValueError):
        shard_leading(Mesh("frames", 3, 0, torch.device("cpu")), 8)


# ---------------------------------------------------------------- runner

def test_runner_matches_jax(seq_case, jax_runner, port_runner):
    """The port's runner at world 1 with JAX's per-frame draws
    (``fold_in(split(key, n_frames)[f], it)``) against JAX
    ``make_parallel_seq_runner`` on 2 CPU devices, 2 frames x 2
    iterations: each frame's parameters rel-L2 1e-4 a leaf, the totals
    rel 5e-3; the two frames end apart."""
    from d3human_tpu_torch.convert import stacked_params_from_jax

    jp, jtot = jax_runner
    per_frame, totals = port_runner
    assert tuple(totals.shape) == (N_FRAMES, N_ITERS) == jtot.shape
    np.testing.assert_allclose(totals.numpy(), jtot, rtol=5e-3)
    for f in range(N_FRAMES):
        want = _flat(stacked_params_from_jax(jp, f, "cpu"))
        _assert_params_close(per_frame[f], want, 1e-4)
    a, b = (_flat(stacked_params_from_jax(jp, f, "cpu")) for f in (0, 1))
    assert any(not np.array_equal(a[k], b[k]) for k in a if "nonrigid" in k)


def test_runner_frames_are_independent_serial_loops(seq_case):
    """Each frame of the runner is a serial loop of make_train_step("seq")
    from its own copy of the shared parameters with a fresh optimizer and
    the same draws, bit for bit, and the shared parameters stay as they
    were."""
    from d3human_tpu_torch.parallel.frames import make_parallel_seq_runner
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import init_state, make_train_step

    j, _, _, pt, draws = seq_case
    p = _port(j)                        # fresh: the steps update in place
    before = {k: v.clone() for k, v in named_leaves(p["params"])}
    args = (p["model"], p["tex"], p["perceptual"], p["perc_params"])
    launch, _ = make_parallel_seq_runner(*args, p["template"], p["cfg"],
                                         N_FRAMES, N_ITERS,
                                         raster_opts=RASTER_OPTS)
    per_frame, totals = launch(p["params"], pt, 0, draws=draws)
    for k, v in named_leaves(p["params"]):
        assert torch.equal(v, before[k]), k
    step_fn = make_train_step("seq", *args, p["cfg"], RASTER_OPTS,
                              template=p["template"])
    for f in range(N_FRAMES):
        state = init_state("seq", _clone(p["params"]), p["cfg"])
        for it in range(N_ITERS):
            state, m = step_fn(state, pt[f], None, draws=draws(f, it))
            assert float(m["total"]) == float(totals[f, it])
        _assert_trees_equal(per_frame[f], state.params)


def _clone(tree):
    from d3human_tpu_torch.parallel.frames import replicate_for_frames

    return replicate_for_frames(tree, 1)[0]


def test_runner_world2_equals_world1(world2):
    """Two gloo ranks, one frame each, against world 1 on the same
    generators: rank 0 holds both frames bit for bit, rank 1 only its
    own, both the totals of every frame."""
    ranks, w1, _ = world2
    r0, r1 = ranks[0]["runner"], ranks[1]["runner"]
    for f in range(N_FRAMES):
        _assert_trees_equal(r0[0][f], w1["runner"][0][f])
    assert r1[0][0] is None and r1[0][1] is not None
    assert torch.equal(r0[1], w1["runner"][1])
    assert torch.equal(r1[1], w1["runner"][1])


# ---------------------------------------------------------------- DP step

@pytest.mark.parametrize("world", [1, 2])
def test_dp_step_matches_jax(world, jax_dp, world2):
    """The port's make_dp_train_step("init") over B = 4 examples with
    JAX's per-example draws, at world 1 and on each rank of world 2,
    against JAX make_dp_train_step on 4 CPU devices: parameters rel-L2
    1e-4 a leaf, the totals [B] rel 5e-3; world 2 equals world 1 bit for
    bit."""
    ranks, w1, _ = world2
    jp, jaux = jax_dp
    want = _flat(jp)
    results = [w1["dp"]] if world == 1 else [r["dp"] for r in ranks]
    for params, metrics in results:
        _assert_params_close(params, want, 1e-4)
        assert tuple(metrics["total"].shape) == (B,)
        np.testing.assert_allclose(metrics["total"].numpy(), jaux["total"],
                                   rtol=5e-3)
        if world == 2:
            _assert_trees_equal(params, w1["dp"][0])
            for k, v in w1["dp"][1].items():
                assert torch.equal(metrics[k], v), k


def test_dp_step_equals_serial_mean_grad_oracle(init_case, world2):
    """World 1's DP step against B loss_and_grads at step 0, their plain
    mean and one step of the DP step's own optimizer: the update within
    rel-L2 1e-5 a leaf (the DP step sums pairwise)."""
    from d3human_tpu_torch.parallel.frames import make_dp_train_step
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import _post_step, loss_and_grads

    j, p, _, pt, keys = init_case
    _, w1, _ = world2
    _, opt_factory, _, _ = make_dp_train_step(
        "init", p["model"], p["tex"], p["perceptual"], p["perc_params"],
        p["cfg"], raster_opts=RASTER_OPTS)
    params = _clone(p["params"])
    before = dict(named_leaves(_clone(params)))
    opt = opt_factory(params)
    grads = [loss_and_grads(
        "init", p["model"], p["tex"], p["perceptual"], p["perc_params"],
        params, pt[i], 0, p["cfg"], opt.trainable_paths(), RASTER_OPTS,
        draws=init_draws(j["cfg"], keys[i]))[1] for i in range(B)]
    mean = {}
    for k in grads[0]:
        gs = [g[k] for g in grads if g[k] is not None]
        mean[k] = sum(gs) / B if gs else None
    opt.step(params, mean)
    _post_step(params, p["model"])
    got = dict(named_leaves(w1["dp"][0]))
    moved = 0
    for k, v in named_leaves(params):
        if not v.is_floating_point():
            continue
        want, have = v - before[k], got[k] - before[k]
        if float(want.abs().max()) == 0:
            assert float(have.abs().max()) == 0, k
            continue
        assert _rel_l2(have.numpy(), want.numpy()) <= 1e-5, k
        moved += 1
    assert moved > 5


# ---------------------------------------------------------------- optimizers

def _random_grads(opt, params, seed):
    """A gradient for every trainable leaf, ~N(0, 1): global norms >> 1."""
    from d3human_tpu_torch.train.optim import named_leaves

    leaves = dict(named_leaves(params))
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(leaves[k].shape, generator=gen)
            for k in opt.trainable_paths()}


def _jax_update(tx, jparams, grads):
    """JAX's optimizer update of ``jparams`` for the port's flat grads."""
    import optax

    flat, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    g = []
    for path, leaf in flat:
        k = "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in path)
        g.append(jnp.asarray(grads[k].numpy()) if k in grads
                 else jnp.zeros_like(leaf))
    jg = jax.tree_util.tree_unflatten(treedef, g)
    updates, _ = jax.jit(tx.update)(jg, tx.init(jparams), jparams)
    return _flat(optax.apply_updates(jparams, updates))


def _port_update(opt, params, grads):
    p = _clone(params)
    opt.step(p, grads)
    return p


@pytest.mark.parametrize("knob", [
    ("clip_max_norm", 0.0), ("init_lr_scale", 0.1), ("sdf_lr_mult", 0.5)])
def test_dp_optimizer_is_the_jax_dp_steps(knob, init_case):
    """The DP step's optimizer is the JAX DP step's (frames.py:165-167):
    ``make_optimizer("init", lr_pos, ...)`` with the geometry clipped at
    1.0 whatever clip_max_norm says, no init_lr_scale and the default
    sdf_lr_mult. With the knob set, its update of random gradients (norm
    >> 1) equals JAX's within rel-L2 1e-5 a leaf and differs from the
    serial init step's optimizer, which reads the knob."""
    from d3human_tpu.parallel.frames import make_dp_train_step as jax_dp
    from d3human_tpu.parallel.mesh import make_data_mesh
    from d3human_tpu_torch.config import from_jax_config
    from d3human_tpu_torch.parallel.frames import make_dp_train_step
    from d3human_tpu_torch.train.step import init_state

    j, p, _, _, _ = init_case
    name, value = knob
    jcfg = dataclasses.replace(j["cfg"], optim=dataclasses.replace(
        j["cfg"].optim, **{"clip_max_norm": 1.0, name: value}))
    cfg = from_jax_config(jcfg)
    _, tx, _, _ = jax_dp("init", j["model"], j["tex"], j["perceptual"],
                         j["perc_params"], jcfg, raster_opts=RASTER_OPTS,
                         mesh=make_data_mesh(1))
    _, opt_factory, _, _ = make_dp_train_step(
        "init", p["model"], p["tex"], p["perceptual"], p["perc_params"],
        cfg, raster_opts=RASTER_OPTS)
    opt = opt_factory(p["params"])
    assert all(g["clip"] == 1.0 for k, g in opt.groups.items()
               if k in ("x1", "xsdf", "x1e-2", "x1e-3"))
    grads = _random_grads(opt, p["params"], seed=5)
    got = _port_update(opt, p["params"], grads)
    _assert_params_close(got, _jax_update(tx, j["params"], grads), 1e-5)
    serial = _port_update(init_state("init", p["params"], cfg).opt,
                          p["params"], grads)
    from d3human_tpu_torch.train.optim import named_leaves

    s = dict(named_leaves(serial))
    assert any(not torch.equal(t, s[k]) for k, t in named_leaves(got)
               if "sdf_net" in k or "deform" in k)


def test_runner_optimizer_passes_clip_but_not_sdf_lr_mult(seq_case):
    """The runner's per-frame optimizer is the JAX runner's
    (frames.py:65-68): ``make_optimizer("seq", ...)`` with the config's
    clip_max_norm and the default sdf_lr_mult (its sdf group at
    lr_pos x 1e-2 whatever sdf_lr_mult says; the seq stage trains no
    sdf_net leaf); its update of random gradients equals JAX's within
    rel-L2 1e-5."""
    from d3human_tpu.train.optim import make_optimizer, resolve_lrs
    from d3human_tpu_torch.config import from_jax_config
    from d3human_tpu_torch.parallel.frames import _parallel_optimizer

    j, p, _, _, _ = seq_case
    jcfg = dataclasses.replace(j["cfg"], optim=dataclasses.replace(
        j["cfg"].optim, clip_max_norm=0.5, sdf_lr_mult=0.5))
    cfg = from_jax_config(jcfg)
    lr_pos, lr_mat, lr_lgt = resolve_lrs(jcfg.optim.learning_rate)
    o = jcfg.optim
    tx = make_optimizer("seq", lr_pos, lr_mat, lr_lgt, o.warmup_iter,
                        o.hashgrid_grad_scale, o.light_grad_scale,
                        geo_clip_norm=o.clip_max_norm)
    opt = _parallel_optimizer("seq", p["params"], cfg, o.clip_max_norm)
    assert opt.groups["xsdf"]["lr"] == lr_pos * 1e-2
    assert opt.groups["x1e-2"]["clip"] == 0.5
    grads = _random_grads(opt, p["params"], seed=6)
    _assert_params_close(_port_update(opt, p["params"], grads),
                         _jax_update(tx, j["params"], grads), 1e-5)


# ---------------------------------------------------------------- driver

def test_run_seq_stage_parallel_world2_files(world2):
    """3 frames over 2 gloo ranks (padded to 4): delta/0..2.npz with the
    offsets and the visible triangles, fine_all_0..2.ply, the loss_log at
    frame * 100000 + it, no file for the pad (the mirror of
    tests/test_parallel.py::test_run_seq_stage_parallel_artifacts)."""
    import json

    from d3human_tpu_torch.utils import io as mesh_io

    _, _, out = world2
    for f in range(3):
        with np.load(os.path.join(out, "delta", f"{f}.npz")) as z:
            assert sorted(z.files) == ["delta", "visible_triangles"]
            delta = z["delta"]
            assert z["visible_triangles"].dtype == np.int32
        assert delta.ndim == 2 and delta.shape[1] == 3
        v, faces = mesh_io.read_ply(os.path.join(out, f"fine_all_{f}.ply"))
        assert len(v) == len(delta) and len(faces) > 0
    assert not os.path.exists(os.path.join(out, "delta", "3.npz"))
    assert not os.path.exists(os.path.join(out, "fine_all_3.ply"))
    with open(os.path.join(out, "loss_log", "scalars.jsonl")) as fh:
        steps = [json.loads(ln)["step"] for ln in fh]
    assert steps == [f * 100000 + it for f in range(3) for it in range(2)]


def test_padded_slot_reoptimizes_the_last_frame(seq_case, tmp_path,
                                                monkeypatch):
    """Rank 1 of 2 (the layout faked, no group) over 3 frames holds frame 2
    and the pad, which re-optimizes frame 2's target (the JAX driver pads
    with min(f, n_frames - 1) too, though its comment says frame 0); it
    writes frame 2's files only, and no loss_log (rank 0's)."""
    from d3human_tpu_torch.parallel import mesh as mesh_mod
    from d3human_tpu_torch.parallel.mesh import Mesh
    from d3human_tpu_torch.train.stages import run_seq_stage_parallel

    _, p, _, pt, _ = seq_case
    cfg = dataclasses.replace(p["cfg"], stages=dataclasses.replace(
        p["cfg"].stages, seq_iters_first=1, seq_max_frames=3))
    monkeypatch.setattr(mesh_mod, "make_frame_mesh", lambda *a, **kw: Mesh(
        "frames", 2, 1, torch.device("cpu")))
    asked = []

    def frame_targets(f):
        asked.append(f)
        return pt[f % 2]

    out = str(tmp_path / "seq")
    per_frame = run_seq_stage_parallel(
        p["params"], p["template"], frame_targets, 5, cfg, out, 0,
        p["model"], p["tex"], p["perceptual"], p["perc_params"],
        raster_opts=RASTER_OPTS)
    assert asked == [2, 2]
    assert per_frame[0] is None and per_frame[3] is not None
    assert sorted(os.listdir(os.path.join(out, "delta"))) == ["2.npz"]
    assert sorted(os.listdir(out)) == ["delta", "fine_all_2.ply"]
