"""The port's bench as a user runs it, ``python -m d3human_tpu_torch.bench
--device cpu``, through ``chip_smoke.phase_bench`` at its CPU scale (the
small scale, 1 warm-up and 2 timed steps): one stdout line with the JAX
bench's keys and metric string for the same variables, no fall-back to a
smaller scale, no CPU run where a card is asked for; and the phase's own
checks."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax.numpy as jnp

from d3human_tpu_torch.ops import cuda_lib
from torch_parity import bench_env, jax_bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(scope="module")
def runs():
    """The three runs of chip_smoke's bench phase at its CPU scale, each in
    a subprocess on one thread."""
    import chip_smoke

    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(k)
        mp.setenv("OMP_NUM_THREADS", "1")
        return chip_smoke.phase_bench("small", "cpu", str(ROOT))


def jax_metric(stage: str, occupancy, tmp) -> dict:
    """The JAX bench's own line for the variables of chip_smoke's CPU runs
    of ``stage``: its ``main`` on its real ``build`` (the capsule fit
    skipped) with a step that reports ``occupancy`` as its cap_cov."""
    import chip_smoke
    from d3human_tpu.models.geometry import GeometryModel

    jbench = jax_bench()
    env = chip_smoke.bench_vars("small", stage)

    def step(state, target, key):
        return state, {"total": jnp.float32(1.0),
                       "cap_cov": jnp.float32(occupancy or 0.0)}

    def build(scale):
        state, _, target, extras = real_build(scale)
        return state, step, target, extras

    real_build = jbench.build
    with pytest.MonkeyPatch.context() as mp:
        bench_env(mp, **env)
        mp.setattr(jbench, "REPO", str(tmp))      # its lattice cache
        mp.setattr(GeometryModel, "pretrain_sdf",
                   lambda self, params, target, steps: (params, 0.0))
        mp.setattr(jbench, "build", build)
        mp.setattr(jbench, "build_seq",
                   lambda scale: (None, step, None, {"cfg": None}))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jbench.main()
    lines = [x for x in buf.getvalue().splitlines() if x.startswith("{")]
    assert len(lines) == 1, buf.getvalue()
    return json.loads(lines[0])


@pytest.mark.parametrize("stage", ["init", "split", "seq"])
def test_main_prints_the_jax_line(runs, stage, tmp_path):
    """Exactly one stdout line, the JAX bench's four keys, a value > 0, and
    the metric string the JAX bench prints for the same variables (the
    peak occupancy the port measured)."""
    r = runs["runs"][stage]
    line = r["line"]
    assert set(line) == KEYS and line["unit"] == "iters/sec"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    want = jax_metric(stage, r["peak_occupancy"], tmp_path)
    assert set(want) == KEYS
    assert line["metric"] == want["metric"]
    if stage == "seq":
        assert r["peak_occupancy"] is None
        assert line["vs_baseline"] == pytest.approx(line["value"] / 5.0,
                                                    abs=1e-3)
    else:
        assert 0 < r["peak_occupancy"] < 1
        per_iter = 3.0 / (2.0 if stage == "split" else 1.0)
        assert line["vs_baseline"] == pytest.approx(
            line["value"] / per_iter, abs=1e-3)


def test_chip_smoke_bench_rehearsal(runs):
    """chip_smoke.py's bench phase on the CPU: three runs, each with its
    kernel line (no launch on the CPU, the longest tile list recorded), its
    seconds and ms a step; the ms-a-step check against a step phase."""
    import chip_smoke

    assert list(runs["runs"]) == ["init", "split", "seq"]
    for stage, r in runs["runs"].items():
        k = r["kernels"]
        assert r["kernel_line"].startswith("# kernels ")
        assert k["platform"] == "cpu" and k["iters"] == 2
        assert set(k["launches"]) == set(k["calls"]) == set(
            cuda_lib.read_counts()["calls"])
        assert not any(k["launches"].values())
        assert not any(k["calls"].values())
        assert k["n_max_tile"] > 0
        assert r["seconds"] > 2 * r["ms_per_step"] / 1e3 > 0
    assert not any(runs["launches"].values())
    chip_smoke.check_bench_ms("init", 300.0, 150.0)
    with pytest.raises(AssertionError, match="ms a step"):
        chip_smoke.check_bench_ms("init", 460.0, 150.0)
    with pytest.raises(AssertionError, match="ms a step"):
        chip_smoke.check_bench_ms("seq", 60.0, 200.0)


def _bench(env: dict, *args):
    clean = {k: v for k, v in os.environ.items()
             if not k.startswith("BENCH_")}
    return subprocess.run(
        [sys.executable, "-m", "d3human_tpu_torch.bench", *args], cwd=ROOT,
        env={**clean, "OMP_NUM_THREADS": "1", **env}, capture_output=True,
        text=True, timeout=600)


def test_failed_scale_fails_the_run():
    """No fall-back: a run that overflows its covered-pixel capacity
    (BENCH_COV tiny) exits non-zero with the assertion in its traceback and
    prints no value line, of its scale or any other."""
    proc = _bench({"BENCH_SCALE": "small", "BENCH_COV": "1e-4",
                   "BENCH_SDF_SEED_STEPS": "10", "BENCH_WARMUP": "0",
                   "BENCH_ITERS": "1", "BENCH_NO_EIK": "1"}, "--device",
                  "cpu")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "covered-pixel capacity overflow" in proc.stderr
    assert "Traceback" in proc.stderr


def test_no_card_no_run(monkeypatch):
    """--device cuda (the default) without a card stops before building
    anything; an unknown scale raises."""
    from d3human_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main(argv)
    with pytest.raises(ValueError, match="bench scale"):
        bench.build("huge", "cpu")
    with pytest.raises(ValueError, match="bench scale"):
        bench.build_seq("tiny", "cpu")
