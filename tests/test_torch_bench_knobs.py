"""The port's bench against the repository's JAX ``bench.py`` (imported as
it is), build only, under the BENCH_* variables the other bench tests
leave at their defaults: the bf16 field, the texture jitter, the
perceptual backbones, the uncropped lattice, the ablations (no eikonal,
no mesh-mSDF regularisers, no sparse antialias, shading on, a chunked
SDF, another coverage), and the seq template's static skinning
weights."""

import numpy as np
import pytest
import torch

from torch_parity import (
    bench_env, build_both, jax_bench, port_cfg_of, to_numpy,
)

torch.set_num_threads(1)

KNOBS = {
    "bf16_jitter_pyramid_uncropped": dict(
        BENCH_BF16="1", BENCH_JITTER="4", BENCH_PERC="pyramid",
        BENCH_GRID_CROP="0"),
    "ablations": dict(BENCH_PERC="none", BENCH_NO_EIK="1",
                      BENCH_NO_MSDFREG="1", BENCH_NO_AA="1",
                      BENCH_SHADING="on", BENCH_SDF_CHUNK="4096",
                      BENCH_COV="0.5", BENCH_STAGE="split"),
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_build_knobs_match_jax(knobs, tmp_path, monkeypatch):
    """Every other BENCH_* variable of ``build`` sets the config as the
    JAX bench's does (field by field), the same lattice and perceptual
    module; BENCH_NO_AA swaps the sparse antialias for the identity in
    both packages' render pipelines."""
    from d3human_tpu.render import pipeline as jpl
    from d3human_tpu_torch.render import pipeline as ppl

    for pl in (jpl, ppl):                 # restored after the test
        monkeypatch.setattr(pl, "apply_aa_sparse", pl.apply_aa_sparse)
    aa = {pl: pl.apply_aa_sparse for pl in (jpl, ppl)}
    (_, _, jtarget, jex), (_, _, ptarget, pex), _ = build_both(
        tmp_path, **KNOBS[knobs])
    assert pex["cfg"] == port_cfg_of(jex["cfg"])
    assert pex["grid_crop"] == jex["grid_crop"]
    assert tuple(pex["model"].grid.dims) == tuple(jex["model"].grid.dims)
    assert type(pex["perceptual"]).__name__ == \
        type(jex["perceptual"]).__name__
    assert set(ptarget) == set(jtarget)
    swapped = "BENCH_NO_AA" in KNOBS[knobs]
    for pl in (jpl, ppl):
        assert (pl.apply_aa_sparse is not aa[pl]) == swapped
        if swapped:
            assert pl.apply_aa_sparse("img", None) == "img"


def test_build_seq_static_weights_match_jax():
    """BENCH_SEQ_STATICW=1: the template's skinning weights transferred
    once at its rest positions, as the JAX bench's (abs 1e-5), and the
    config's seq_static_skin_weights on."""
    from d3human_tpu_torch import bench as pbench

    with pytest.MonkeyPatch.context() as mp:
        bench_env(mp, BENCH_SEQ_STATICW="1")
        _, jstep, _, jex = jax_bench().build_seq("small")
        _, _, _, pex = pbench.build_seq("small", "cpu")
    assert pex["cfg"].stages.seq_static_skin_weights
    assert pex["cfg"] == port_cfg_of(jex["cfg"])
    want = np.asarray(jstep.consts["template"].w_pts)
    got = to_numpy(pex["template"].w_pts)
    assert got.shape == want.shape and want.shape[0] == 4464
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
