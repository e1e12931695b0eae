"""The port's MobileNetV2 perceptual backbone (``models/mobilenet.py``)
against the JAX package: the features at 64² on the JAX package's He-init
weights carried by ``convert.py`` (rel-L2 1e-5 per tap), a torchvision-
shaped oracle with random BatchNorm statistics converted by
``scripts/convert_mobilenet.py:convert`` into the npz that both packages
read (the oracle's taps within 2e-4 abs and rel, as the JAX test holds
them), the init tick with the mobilenet backbone (the tick tolerances of
``test_torch_init_step.py``), and the CLI with
``loss.perceptual_backbone = "mobilenet"`` on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (
    IT, JAX_RASTER_OPTS, KEY, RASTER_OPTS, eik_draws, jax_small, port_small,
    to_np,
)

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_features_and_loss_match_jax_on_carried_weights():
    from d3human_tpu.models.mobilenet import MobileNetFeatures as JM
    from d3human_tpu_torch.convert import mobilenet_from_jax
    from d3human_tpu_torch.models.mobilenet import MobileNetFeatures as TM

    jm, tm = JM(), TM()
    jp = jm.init(None)
    tp = mobilenet_from_jax(to_np(jp), "cpu")
    assert tp["s3_dw_w"].shape == (144, 1, 3, 3)
    assert tp["s0_conv_w"].shape == (32, 3, 3, 3)
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-1, 1, size=(2, 2, 64, 64, 3)).astype(np.float32)
    want = jm.features(jp, jnp.asarray(x))
    got = tm.features(tp, torch.as_tensor(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 16, 16, 24), (2, 8, 8, 32), (2, 4, 4, 64)]
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-5
    jl, jg = jax.value_and_grad(lambda a: jm.loss(jp, a, jnp.asarray(y)))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tl = tm.loss(tp, xt, torch.as_tensor(y))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert _rel(xt.grad.numpy(), jg) < 1e-4


def test_he_init_fallback(capsys):
    """A named but missing npz warns and falls back to seeded He-init
    filters of the JAX package's shapes and fan-in."""
    from d3human_tpu.models.mobilenet import MobileNetFeatures as JM
    from d3human_tpu_torch.models.mobilenet import MobileNetFeatures as TM

    tp = TM().init("nowhere/mobilenet_v2_features.npz", "cpu")
    assert "WARNING" in capsys.readouterr().out
    jp = JM().init(None)
    assert set(tp) == set(jp)
    for k, w in jp.items():
        w = np.asarray(w)
        t = tp[k].numpy()
        assert t.size == w.size, k
        if k.endswith("_w"):
            assert t.shape == (w.shape[3], w.shape[2], w.shape[0],
                               w.shape[1]), k
            # both are N(0, 2 / fan_in): the spread matches loosely
            assert 0.6 < t.std() / w.std() < 1.6, k
        else:
            assert not t.any() and not w.any(), k
    again = TM().init(None, "cpu")
    assert all(torch.equal(again[k], tp[k]) for k in tp)
    a = torch.zeros((1, 64, 64, 3))
    assert float(TM().loss(tp, a, a)) == 0.0
    assert float(TM().loss(tp, a, a + 0.5)) > 0.0


def test_converted_torchvision_oracle(tmp_path):
    """The JAX test's torchvision-shaped stack with random BatchNorm,
    converted to the npz layout and read by both packages' ``init``."""
    from test_mobilenet import build_torch_features

    from d3human_tpu.models.mobilenet import TAPS
    from d3human_tpu.models.mobilenet import MobileNetFeatures as JM
    from d3human_tpu_torch.models.mobilenet import MobileNetFeatures as TM
    from scripts.convert_mobilenet import convert

    feats = build_torch_features()
    state = {f"features.{k}": v for k, v in feats.state_dict().items()}
    npz = str(tmp_path / "mobilenet_v2_features.npz")
    np.savez(npz, **convert(state))
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, h = [], x
        for i, layer in enumerate(feats):
            h = layer(h)
            if i in TAPS:
                want.append(h.permute(0, 2, 3, 1).numpy())
        got = TM().features(TM().init(npz, "cpu"), x.permute(0, 2, 3, 1))
    jgot = JM().features(JM().init(npz), jnp.asarray(
        x.permute(0, 2, 3, 1).numpy()))
    for g, jg, w in zip(got, jgot, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)
        assert _rel(g.numpy(), jg) < 1e-5


def test_make_perceptual_mobilenet(tmp_path):
    from d3human_tpu_torch.models.mobilenet import MobileNetFeatures
    from d3human_tpu_torch.models.perceptual import make_perceptual

    m, p = make_perceptual("mobilenet", "cpu", str(tmp_path / "missing.npz"))
    assert isinstance(m, MobileNetFeatures) and len(p) == 2 * 21  # convs


def test_tick_init_with_mobilenet_matches_jax():
    """The init tick with the mobilenet backbone on the JAX package's
    He-init weights: counters exact, scalars rel 5e-3."""
    from d3human_tpu.models.mobilenet import MobileNetFeatures as JM
    from d3human_tpu.train import losses as JL
    from d3human_tpu_torch.convert import mobilenet_from_jax
    from d3human_tpu_torch.models.mobilenet import MobileNetFeatures as TM
    from d3human_tpu_torch.train.losses import tick_init

    j = jax_small()
    jm = JM()
    jp = jm.init(None)
    p = port_small(j)
    want = jax.jit(lambda pr: {
        k: v for k, v in JL.tick_init(
            jax.random.PRNGKey(KEY), j["model"], pr["geometry"], pr["pose"],
            j["tex"], pr["material"], jm, jp, j["target"], jnp.int32(IT),
            j["cfg"], JAX_RASTER_OPTS).items() if jnp.ndim(v) == 0})(
        j["params"])
    with torch.no_grad():
        got = tick_init(None, p["model"], p["params"]["geometry"],
                        p["params"]["pose"], p["tex"],
                        p["params"]["material"], TM(),
                        mobilenet_from_jax(to_np(jp), "cpu"), p["target"],
                        IT, p["cfg"], RASTER_OPTS,
                        draws={"eik": eik_draws(
                            p["cfg"].geometry.n_eikonal_samples)})
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        if k in ("n_cross", "n_valid_tets", "n_big_faces", "n_max_tile"):
            assert g == w, (k, g, w)
        else:
            assert g == pytest.approx(w, rel=5e-3, abs=1e-5), (k, g, w)
    assert float(got["normal_loss"]) > 0


def test_cli_trains_with_the_mobilenet_backbone(tmp_path, capsys):
    """``python -m d3human_tpu_torch.train_d3h`` with
    ``loss.perceptual_backbone = "mobilenet"`` and no npz: the init stage
    on the synthetic scene at chip_smoke.py's CPU-sized cuts."""
    import chip_smoke
    import d3human_tpu_torch.train_d3h as cli

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = chip_smoke.CLI_SCALES["tiny"]
    with open(os.path.join(here, s["config"])) as fh:
        cfg = json.load(fh)
    for sec, vals in s["cuts"].items():
        cfg.setdefault(sec, {}).update(vals)
    cfg.setdefault("loss", {}).update(
        perceptual_backbone="mobilenet",
        perceptual_npz=str(tmp_path / "no_weights.npz"))
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    assert cli.main(["--config", str(cfg_path), "--out-dir", str(out),
                     "--synthetic", "--synthetic-frames", "2", "--stages",
                     "init", "--iters-scale", "0.002", "--device",
                     "cpu"]) == 0
    text = capsys.readouterr().out
    assert "falling back to deterministic He-init" in text
    with open(out / "init" / "loss_log" / "scalars.jsonl") as fh:
        lines = [json.loads(ln) for ln in fh]
    tot = [ln for ln in lines if "total" in ln]
    assert tot
    assert all(np.isfinite(ln["total"]) and ln["normal_loss"] > 0
               for ln in tot)
    assert os.path.exists(out / "init" / "validate" / "final_metrics.json")
