"""The port's split-stage slice as a whole against the JAX package on the
small scene (one dense and one hashed texture level, an mSDF field cut at
mid height), with the JAX package's random draws injected: ``tick_split``
at it=7, its gradients, the signed-view oracle of the mesh-mSDF
regularizer, and one ``make_train_step("split")`` step."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (
    IT, JAX_RASTER_OPTS, KEY, RASTER_OPTS, jax_split_small, port_small,
    split_draws,
)

torch.set_num_threads(1)

EXACT = ("n_cross", "n_valid_tets", "n_big_faces", "n_max_tile")


def _with_optim(cfg):
    """No warm-up (the schedule starts at lr 0 otherwise, and a step would
    move nothing) and the full-width configs' gradient clip."""
    return dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, warmup_iter=0, clip_max_norm=1.0))


@pytest.fixture(scope="module")
def both():
    j = jax_split_small()
    j["cfg"] = _with_optim(j["cfg"])
    return j, port_small(j)


@pytest.fixture(scope="module")
def jax_value_and_grad(both):
    """One compiled (aux, grads) of the JAX tick for any iteration."""
    from d3human_tpu.train import losses as JL

    j, _ = both

    def loss(params, it):
        out = JL.tick_split(
            jax.random.PRNGKey(KEY), j["model"], params["geometry"],
            params["pose"], j["tex"], params["material"], j["perceptual"],
            j["perc_params"], j["target"], it, j["cfg"], JAX_RASTER_OPTS)
        return out["total"], out

    return jax.jit(jax.grad(loss, has_aux=True))


def _flat(tree):
    from d3human_tpu_torch.train.optim import named_leaves

    return {k: v.numpy() for k, v in named_leaves(
        jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree))}


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_tick_split_and_gradients_match_jax(both, jax_value_and_grad):
    """Counters exact, every scalar rel 5e-3, gradients of msdf, deform,
    material and pose rel-L2 1e-3; frozen-by-structure leaves (sdf_net
    included: it is trained in init only, but its gradient exists) too."""
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import loss_and_grads

    j, p = both
    jg, want = jax_value_and_grad(j["params"], jnp.int32(IT))
    paths = [k for k, t in named_leaves(p["params"])
             if t.is_floating_point()]
    got, tg = loss_and_grads(
        "split", p["model"], p["tex"], p["perceptual"], p["perc_params"],
        p["params"], p["target"], IT, p["cfg"], paths, RASTER_OPTS,
        draws=split_draws(j["cfg"]))
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        if k.split("_", 1)[-1] in EXACT:
            assert g == w, (k, g, w)
        else:
            assert g == pytest.approx(w, rel=5e-3, abs=1e-6), (k, g, w)
    for half in ("cloth", "body"):
        assert got[f"{half}_n_cross"] > 0 and got[f"{half}_cap_cov"] > 0
        assert got[f"{half}_mtl_smooth_loss"] > 0
    jg = _flat(jg)
    checked = set()
    for k in paths:
        w = jg[k]
        g = np.zeros_like(w) if tg[k] is None else tg[k].numpy()
        if np.linalg.norm(w) == 0:
            assert np.linalg.norm(g) == 0, k
            continue
        assert _rel_l2(g, w) <= 1e-3, (k, _rel_l2(g, w))
        checked.add(k.split("/")[1] if k.startswith("geometry") else
                    k.split("/")[0])
    assert {"msdf", "deform", "material", "pose", "sdf_net"} <= checked
    assert np.linalg.norm(jg["light/base"]) == 0


def test_split_msdf_reg_uses_signed_view(both):
    """The open/close regularizers act on each half's OWN sign-corrected
    mSDF view: the two halves' values differ, and the body's open term
    equals the one recomputed from its own msdf_aug."""
    from d3human_tpu_torch.train.losses import _huber_sum, tick_split

    j, p = both
    cfg = dataclasses.replace(p["cfg"], loss=dataclasses.replace(
        p["cfg"].loss, msdf_reg_close_scale=0.0))
    with torch.no_grad():
        out = tick_split(None, p["model"], p["params"]["geometry"],
                         p["params"]["pose"], p["tex"],
                         p["params"]["material"], p["perceptual"],
                         p["perc_params"], p["target"], IT, cfg, RASTER_OPTS,
                         draws=split_draws(j["cfg"]))
        full = tick_split(None, p["model"], p["params"]["geometry"],
                          p["params"]["pose"], p["tex"],
                          p["params"]["material"], p["perceptual"],
                          p["perc_params"], p["target"], IT, p["cfg"],
                          RASTER_OPTS, draws=split_draws(j["cfg"]))
        _, body = p["model"].get_meshes_pair(p["params"]["geometry"],
                                             p["params"]["pose"], 0)
    assert float(full["cloth_mesh_msdf_reg_loss"]) != float(
        full["body_mesh_msdf_reg_loss"])
    # the close term adds to the open term, and stays out of the total
    assert float(full["body_mesh_msdf_reg_loss"]) > float(
        out["body_mesh_msdf_reg_loss"])
    assert float(full["total"]) == float(out["total"])
    regscale = (64.0 / cfg.geometry.grid_res) ** 3
    want_open = cfg.loss.msdf_reg_open_scale * regscale * float(
        _huber_sum(body.mesh.msdf_aug.clamp_min(-1e-3), -1e-3))
    assert float(out["body_mesh_msdf_reg_loss"]) == pytest.approx(
        want_open, rel=1e-6)
    raw_view = cfg.loss.msdf_reg_open_scale * regscale * float(
        _huber_sum((-body.mesh.msdf_aug).clamp_min(-1e-3), -1e-3))
    assert float(out["body_mesh_msdf_reg_loss"]) != pytest.approx(
        raw_view, rel=1e-3)


def test_split_train_step_matches_jax(both, jax_value_and_grad):
    """One step from step 0: every parameter after the step within rel-L2
    1e-4 of the JAX package's (its optimizer applied to its own
    gradients), sdf_net unchanged bit for bit, the light clamped."""
    import optax
    from d3human_tpu.train import step as JS
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import init_state, make_train_step

    j, _ = both
    p = port_small(j)                    # fresh: the step updates in place
    # a probe below the clamp, so the post-step clamp shows
    jparams = dict(j["params"])
    jparams["light"] = {"base": j["params"]["light"]["base"].at[0, 0].set(0.0)}
    p["params"]["light"]["base"][0, 0] = 0.0

    jstate, tx = JS.init_state("split", jparams, j["cfg"])
    jg, jaux = jax_value_and_grad(jparams, jnp.int32(0))
    updates, _ = tx.update(jg, jstate.opt_state, jparams)
    want = _flat(JS._post_step(optax.apply_updates(jparams, updates),
                               j["model"]))

    before = {k: v.clone() for k, v in named_leaves(p["params"])}
    state = init_state("split", p["params"], p["cfg"])
    step_fn = make_train_step("split", p["model"], p["tex"], p["perceptual"],
                              p["perc_params"], p["cfg"], RASTER_OPTS)
    state, m = step_fn(state, p["target"], None, draws=split_draws(j["cfg"]))
    assert state.step == 1 and state.opt.count == 1
    moved = set()
    for k, t in named_leaves(state.params):
        if not t.is_floating_point():
            continue
        w = want[k]
        if "sdf_net" in k:
            assert torch.equal(t, before[k]), k
        if np.linalg.norm(w) == 0:
            assert np.linalg.norm(t.numpy()) == 0, k
        else:
            assert _rel_l2(t.numpy(), w) <= 1e-4, (k, _rel_l2(t.numpy(), w))
        if not torch.equal(t, before[k]):
            moved.add(k.split("/")[1] if k.startswith("geometry")
                      else k.split("/")[0])
    assert {"msdf", "deform", "material", "pose", "light"} <= moved
    assert float(state.params["light"]["base"].min()) == pytest.approx(1e-4)
    gm = np.asarray(jg["geometry"]["msdf"])
    assert float(m["msdf_grad_norm"]) == pytest.approx(
        float(np.linalg.norm(gm)), rel=1e-3)
    assert float(m["msdf_grad_absmax"]) == pytest.approx(
        float(np.abs(gm).max()), rel=1e-3)
    assert float(m["total"]) == pytest.approx(float(jaux["total"]), rel=5e-3)


def test_split_step_with_generator_is_finite_and_repeatable():
    """Without injected draws the numbers come from the generator: two runs
    from one seed agree bit for bit, another seed differs."""
    from d3human_tpu_torch.train.step import init_state, make_train_step

    j = jax_split_small()
    totals = []
    for seed in (0, 0, 1):
        p = port_small(j)
        step_fn = make_train_step("split", p["model"], p["tex"],
                                  p["perceptual"], p["perc_params"], p["cfg"],
                                  RASTER_OPTS)
        state = init_state("split", p["params"], p["cfg"])
        _, m = step_fn(state, p["target"], torch.Generator().manual_seed(seed))
        assert all(math.isfinite(float(v)) for v in m.values())
        totals.append(float(m["total"]))
    assert totals[0] == totals[1] != totals[2]
