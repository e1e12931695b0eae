"""The port's init-stage slice as a whole against the JAX package:
``tick_init`` at it=7, key 3, init_shading off, on the small scene with
the JAX eikonal draws injected (the golden test's tolerance), its
gradients against ``jax.grad``, and 20 CPU training steps."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (
    IT, JAX_RASTER_OPTS, KEY, RASTER_OPTS, eik_draws, jax_small, port_small,
)

torch.set_num_threads(1)

EXACT = ("n_cross", "n_valid_tets", "n_big_faces", "n_max_tile")


@pytest.fixture(scope="module")
def both():
    j = jax_small()
    return j, port_small(j)


def _jax_tick(j, params):
    from d3human_tpu.train import losses as JL

    return JL.tick_init(jax.random.PRNGKey(KEY), j["model"], params["geometry"],
                        params["pose"], j["tex"], j["params"]["material"],
                        j["perceptual"], j["perc_params"], j["target"],
                        jnp.int32(IT), j["cfg"], JAX_RASTER_OPTS)


def test_tick_init_matches_jax(both):
    from d3human_tpu_torch.train.losses import tick_init

    j, p = both
    want = jax.jit(lambda pr: {k: v for k, v in _jax_tick(j, pr).items()
                               if jnp.ndim(v) == 0})(j["params"])
    got = tick_init(None, p["model"], p["params"]["geometry"],
                    p["params"]["pose"], p["tex"], p["params"]["material"],
                    p["perceptual"], p["perc_params"], p["target"], IT,
                    p["cfg"], RASTER_OPTS, draws={"eik": eik_draws(
                        p["cfg"].geometry.n_eikonal_samples)})
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k].detach())
        if k in EXACT:
            assert g == w, (k, g, w)
        else:
            assert g == pytest.approx(w, rel=5e-3, abs=1e-5), (k, g, w)
    assert float(got["n_cross"]) > 0


def test_tick_init_with_shading_matches_jax():
    """init_shading on: the render samples the texture (shaded compacted
    branch without smoothness consumers) and img_loss gains its tonemapped
    image term. Counters exact, scalars rel 5e-3; the total does not move."""
    import dataclasses

    from d3human_tpu.train import losses as JL
    from d3human_tpu_torch.train.losses import tick_init
    from torch_parity import init_draws, jax_split_small

    j = jax_split_small()
    j["cfg"] = dataclasses.replace(j["cfg"], render=dataclasses.replace(
        j["cfg"].render, init_shading=True))
    p = port_small(j)
    assert p["cfg"].render.init_shading
    want = jax.jit(lambda pr: {
        k: v for k, v in JL.tick_init(
            jax.random.PRNGKey(KEY), j["model"], pr["geometry"], pr["pose"],
            j["tex"], pr["material"], j["perceptual"], j["perc_params"],
            j["target"], jnp.int32(IT), j["cfg"], JAX_RASTER_OPTS).items()
        if jnp.ndim(v) == 0})(j["params"])

    def tick(cfg):
        with torch.no_grad():
            return tick_init(None, p["model"], p["params"]["geometry"],
                             p["params"]["pose"], p["tex"],
                             p["params"]["material"], p["perceptual"],
                             p["perc_params"], p["target"], IT, cfg,
                             RASTER_OPTS, draws=init_draws(j["cfg"]))

    got = tick(p["cfg"])
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        if k in EXACT:
            assert g == w, (k, g, w)
        else:
            assert g == pytest.approx(w, rel=5e-3, abs=1e-5), (k, g, w)
    lean = tick(dataclasses.replace(p["cfg"], render=dataclasses.replace(
        p["cfg"].render, init_shading=False)))
    assert float(got["img_loss"]) > float(lean["img_loss"]) > 0
    assert float(got["total"]) == pytest.approx(float(lean["total"]),
                                                rel=1e-6)


def test_init_gradients_match_jax(both):
    """Every gradient leaf of the init step within rel-L2 1e-3."""
    from d3human_tpu_torch.train.optim import named_leaves
    from d3human_tpu_torch.train.step import loss_and_grads

    j, p = both
    jg = jax.jit(jax.grad(lambda pr: _jax_tick(j, pr)["total"]))(j["params"])
    jg = {k: np.array(v) for k, v in named_leaves(
        jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jg))}
    paths = [k for k, _ in named_leaves(p["params"])]
    assert set(paths) == set(jg)
    _, tg = loss_and_grads(
        "init", p["model"], p["tex"], p["perceptual"], p["perc_params"],
        p["params"], p["target"], IT, p["cfg"], paths, RASTER_OPTS,
        draws={"eik": eik_draws(p["cfg"].geometry.n_eikonal_samples)})
    nonzero = 0
    for k in paths:
        want = jg[k]
        got = np.zeros_like(want) if tg[k] is None else tg[k].numpy()
        scale = np.linalg.norm(want)
        if scale == 0:
            assert np.linalg.norm(got) == 0, k
            continue
        nonzero += 1
        assert np.linalg.norm(got - want) <= 1e-3 * scale, k
    assert nonzero >= 10


def test_init_total_decreases_over_20_steps():
    """20 CPU steps from a warm-started lr (the schedule's peak), on fresh
    parameters (the steps update them in place)."""
    from d3human_tpu_torch.train.step import init_state, make_train_step

    p = port_small(jax_small())
    state = init_state("init", p["params"], p["cfg"])
    state.step = p["cfg"].optim.warmup_iter
    step_fn = make_train_step("init", p["model"], p["tex"], p["perceptual"],
                              p["perc_params"], p["cfg"], RASTER_OPTS)
    gen = torch.Generator().manual_seed(0)
    metrics = []
    for _ in range(20):
        state, m = step_fn(state, p["target"], gen)
        metrics.append({k: float(v) for k, v in m.items()})
    assert all(math.isfinite(m["total"]) for m in metrics)
    assert metrics[-1]["msk_loss"] < metrics[0]["msk_loss"]
    assert metrics[-1]["total"] < metrics[0]["total"]


def test_chip_smoke_scene_rehearsal(tmp_path):
    """chip_smoke.py's scene set-up at its CPU-sized scale, through every
    path the script drives: an init step, a split step, the ticks with the
    script's injected draws, and the checked validation render; then the
    paths of the environment-light render (``small_pbr`` against itself,
    ``pbr``), the MobileNetV2 backbone (its features and one init and one
    split step) and the API-only modules (``aux``)."""
    import chip_smoke
    from d3human_tpu_torch.train.step import stage_tick

    sc = chip_smoke.build_scene("tiny", "cpu", seed_steps=30)
    gen = torch.Generator().manual_seed(0)
    for stage, key in (("init", "state"), ("split", "split_state")):
        state, m = chip_smoke.stage_step_fn(sc, stage)(sc[key], sc["target"],
                                                       gen)
        assert state.step == 1
        chip_smoke.check_step_metrics(stage, chip_smoke.scalars(m), stage)
        with torch.no_grad():
            out = chip_smoke.scalars(stage_tick(
                stage, sc["model"], sc["tex"], sc["perceptual"],
                sc["perc_params"], sc["params"], sc["target"], 7, sc["cfg"],
                sc["raster_opts"],
                draws=chip_smoke.tick_draws(sc["cfg"], stage, seed=1)))
        assert all(math.isfinite(v) for v in out.values())
    assert "msdf_grad_norm" in m
    for name, sign in (("cloth", 1.0), ("body", -1.0)):
        info = chip_smoke.check_validation(
            sc, name, *chip_smoke.validation_render(sc, sign, gen))
        assert len(info["layer_pixels"]) == chip_smoke.VAL_LAYERS
        assert 0 < info["alpha_mean"] < 1
    chip_smoke.phase_small_pbr(sc, sc)
    pbr = chip_smoke.phase_pbr(sc, "cpu")
    assert set(pbr["launches"]) == {"first_k_indices", "coo_scatter_add",
                                    "resolve_tiles", "resolve_tiles_peel",
                                    "inclusive_scan"}
    # the recorder saw every kernel's wrapper on the path
    assert set(pbr["inputs"]) == {"first_k_indices", "coo_scatter_add",
                                  "resolve_tiles_indexed"}
    msc = chip_smoke.mobilenet_scene(sc, "cpu")
    assert max(chip_smoke.mobilenet_features_err(msc, "cpu")) == 0.0
    for stage, key in (("init", "state"), ("split", "split_state")):
        _, m = chip_smoke.stage_step_fn(msc, stage)(msc[key], msc["target"],
                                                    gen)
        m = chip_smoke.scalars(m)
        chip_smoke.check_step_metrics(stage, m, f"mobilenet {stage}")
        assert all(v > 0 for k, v in m.items() if k.endswith("normal_loss"))
    aux = chip_smoke.phase_aux(sc, "tiny", "cpu", str(tmp_path))
    assert aux["inputs"] == {} and not any(aux["launches"].values())
