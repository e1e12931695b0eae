"""The port's hash-grid texture against the JAX package: encoding and
material sample on dense and hashed levels (values abs 1e-6, table and MLP
gradients rel-L2 1e-5), the packed-table gradient landing in the canonical
table, and the two gradient factors (128 at the encoding, 1/8 at the
optimizer) one at a time."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d3human_tpu.config import TextureConfig as JTextureConfig
from d3human_tpu.models.texture import MLPTexture3D as JTexture

from d3human_tpu_torch.convert import texture_from_jax_config
from d3human_tpu_torch.models.texture import (
    HashGridEncoding, grad_scale,
)
from torch_parity import to_np

torch.set_num_threads(1)

# name -> (texture config, expected dense flags)
CONFIGS = {
    "dense": (JTextureConfig(n_levels=3, log2_hashmap_size=21), (True,) * 3),
    "hashed": (JTextureConfig(n_levels=2, log2_hashmap_size=10,
                              internal_dims=16), (False, False)),
    "mixed": (JTextureConfig(n_levels=3, log2_hashmap_size=14),
              (True, True, False)),
}


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _both(name):
    jcfg, dense = CONFIGS[name]
    jtex = JTexture(jcfg, (jnp.zeros((6,)), jnp.ones((6,))))
    assert jtex.encoder.dense == dense
    jparams = jtex.init(jax.random.PRNGKey(2))
    # tables of the reference's size are ~1e-4: scale them up so the
    # encoding carries signal through the MLP
    jparams["encoder"]["table"] = [t * 3e3 for t in
                                   jparams["encoder"]["table"]]
    ttex = texture_from_jax_config(jcfg, to_np(jtex.min_max), "cpu")
    assert ttex.encoder.dense == dense
    assert ttex.encoder.resolutions == jtex.encoder.resolutions
    tparams = {
        "encoder": {"table": [torch.as_tensor(np.array(t)) for t in
                              jparams["encoder"]["table"]]},
        "net": [{"w": torch.as_tensor(np.array(lay["w"]))}
                for lay in jparams["net"]]}
    return jtex, jparams, ttex, tparams


def _points(n=300):
    rng = np.random.default_rng(0)
    u = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    u[:8] = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]
    return u


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoding_matches_jax(name):
    jtex, jparams, ttex, tparams = _both(name)
    u = _points()
    want = jtex.encoder.apply(jparams["encoder"], jnp.asarray(u))
    got = ttex.encoder.apply(tparams["encoder"], torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sample_and_gradients_match_jax(name):
    jtex, jparams, ttex, tparams = _both(name)
    lo, hi = np.array([-0.8, -1.2, -0.2]), np.array([0.6, 0.6, 0.2])
    pts = (lo + _points() * (hi - lo) * 1.1 - 0.05).astype(np.float32)
    wts = np.random.default_rng(1).normal(size=(pts.shape[0], 6)).astype(
        np.float32)

    def jloss(p):
        return jnp.sum(jtex.sample(p, jnp.asarray(pts)) * wts)

    want = jtex.sample(jparams, jnp.asarray(pts))
    jg = jax.grad(jloss)(jparams)
    leaves = tparams["encoder"]["table"] + [l["w"] for l in tparams["net"]]
    for t in leaves:
        t.requires_grad_(True)
    got = ttex.sample(tparams, torch.as_tensor(pts))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    tg = torch.autograd.grad((got * torch.as_tensor(wts)).sum(), leaves)
    jleaves = jg["encoder"]["table"] + [l["w"] for l in jg["net"]]
    for a, b in zip(tg, jleaves):
        assert np.linalg.norm(np.asarray(b)) > 0
        assert _rel_l2(a.numpy(), np.asarray(b)) <= 1e-5


def test_packed_table_gradient_lands_in_canonical_table():
    """Level 0 of the default config (17^3 rows): the gradient through the
    8 rolls + concat equals the gradient of 8 direct corner lookups."""
    enc = HashGridEncoding(n_levels=1)
    s = enc.resolutions[0] + 1
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((s ** 3, 2), generator=gen, requires_grad=True)
    u = torch.as_tensor(_points(200))
    out = enc.apply({"table": [table]}, u)
    (g,) = torch.autograd.grad(out.sum(), table)

    xs = u * enc.resolutions[0]
    x0 = torch.floor(xs)
    f = xs - x0
    x0 = x0.long()
    want = torch.zeros_like(table)
    for (i, j, k) in [(i, j, k) for i in (0, 1) for j in (0, 1)
                      for k in (0, 1)]:
        w = ((f[:, 0] if i else 1 - f[:, 0]) * (f[:, 1] if j else 1 - f[:, 1])
             * (f[:, 2] if k else 1 - f[:, 2]))
        row = ((x0[:, 0] + i) * s + x0[:, 1] + j) * s + x0[:, 2] + k
        ok = row < s ** 3          # beyond the end only with zero weight
        assert bool((w[~ok] == 0).all())
        want.index_add_(0, row[ok], w[ok, None].expand(-1, 2))
    assert g.shape == (s ** 3, 2)
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)


def test_grad_scale_is_identity_with_scaled_backward():
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    y = grad_scale(x, 128.0)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad((y * y).sum(), x)
    assert torch.equal(g, 128.0 * 2.0 * x.detach())


def test_gradient_scaling_factor_reaches_tables_not_mlp():
    """gradient_scaling multiplies the table gradients and leaves the MLP
    gradients (which lie after the encoding) untouched."""
    _, _, ttex, tparams = _both("mixed")
    plain = texture_from_jax_config(
        dataclasses.replace(CONFIGS["mixed"][0], gradient_scaling=1.0),
        (np.zeros(6), np.ones(6)), "cpu")
    pts = torch.as_tensor((_points(100) - 0.5).astype(np.float32))
    leaves = tparams["encoder"]["table"] + [l["w"] for l in tparams["net"]]
    for t in leaves:
        t.requires_grad_(True)
    g128 = torch.autograd.grad(ttex.sample(tparams, pts).sum(), leaves)
    g1 = torch.autograd.grad(plain.sample(tparams, pts).sum(), leaves)
    n_tab = len(tparams["encoder"]["table"])
    for a, b in zip(g128[:n_tab], g1[:n_tab]):
        torch.testing.assert_close(a, 128.0 * b, rtol=1e-6, atol=0)
    for a, b in zip(g128[n_tab:], g1[n_tab:]):
        assert torch.equal(a, b)


def test_optimizer_scales_table_gradients_only():
    """hashgrid_grad_scale multiplies the hash-table gradients before Adam
    and nothing else: a clipped geometry group sees it through its norm, so
    the check uses the first moments (mu = 0.1 * scaled gradient)."""
    from d3human_tpu_torch.train.optim import StageAdam

    params = {"material": {"encoder": {"table": [torch.ones(4, 2)]},
                           "net": [{"w": torch.ones(3, 3)}]},
              "light": {"base": torch.ones(2, 2, 3)}}
    opt = StageAdam("split", params, 0.03, 0.03, 0.18, warmup_iter=0,
                    hashgrid_grad_scale=0.125, light_grad_scale=64.0)
    g = {p: torch.full_like(dict(_leaves(params))[p], 2.0)
         for p in opt.trainable_paths()}
    opt.step(params, g)
    assert torch.allclose(opt.mu["material/encoder/table/0"],
                          torch.full((4, 2), 0.1 * 2.0 * 0.125))
    assert torch.allclose(opt.mu["material/net/0/w"],
                          torch.full((3, 3), 0.1 * 2.0))
    assert torch.allclose(opt.mu["light/base"],
                          torch.full((2, 2, 3), 0.1 * 2.0 * 64.0))


def _leaves(params):
    from d3human_tpu_torch.train.optim import named_leaves

    return named_leaves(params)
