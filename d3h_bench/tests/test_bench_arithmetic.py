"""The window's arithmetic, the trace's reduction on a hand-made trace,
and the FLOP count against a hand count."""

import time

import pytest
import torch

from d3h_bench import flops, loop, trace
from d3h_bench.metrics import (
    device_busy_ms, device_idle_pct, kernels_per_step, knn_ms,
    port_kernel_ms, step_mfu_pct,
)


class _State:
    pass


def test_window_step_ms_counts_all_steps_and_time():
    def step_fn(state, target, gen):
        time.sleep(0.01)
        return state, {"total": torch.zeros(())}

    lp = loop.Loop(step_fn, _State(), lambda it: {}, 7, "cpu", 50)
    n, secs = lp.window(0.1)
    assert n >= 5
    assert secs >= 0.1
    assert secs * 1e3 / n == pytest.approx(10.0, rel=0.5)
    assert lp.it == n and len(lp.totals) == n


def test_iteration_generators_follow_the_seed():
    a = loop.iteration_generator(11, 3, "cpu")
    b = loop.iteration_generator(11, 3, "cpu")
    c = loop.iteration_generator(11, 4, "cpu")
    x, y, z = (torch.rand(4, generator=g) for g in (a, b, c))
    assert torch.equal(x, y) and not torch.equal(x, z)
    assert loop.fold_in(2 ** 40 + 5, 1) != loop.fold_in(2 ** 40 + 6, 1)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _hand_trace(drop_kernel=False):
    """Two steps in a window [0, 100] us: launches at 5, 12, 55 (knn) and
    their kernels [10, 30], [20, 40], [60, 70]."""
    ev = [_x("user_annotation", trace.WINDOW, 0, 100),
          _x("user_annotation", trace.STEP, 1, 49),
          _x("user_annotation", trace.STEP, 51, 48),
          _x("user_annotation", "d3h_bench.knn1", 54, 3),
          _x("cpu_op", "aten::mm", 4, 10),
          _x("cpu_op", "aten::index", 38, 10),
          _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
          _x("cuda_runtime", "cudaLaunchKernel", 55, 1, correlation=3),
          _x("kernel", "first_k_count_kernel(x)", 10, 20, correlation=1),
          _x("kernel", "gemm", 20, 20, correlation=2)]
    if not drop_kernel:
        ev.append(_x("kernel", "first_k_write_kernel", 60, 10,
                     correlation=3))
    return ev


def test_busy_union_and_idle_on_a_hand_made_trace():
    rec, missing = trace.reduce_trace(_hand_trace(), 2, None)
    assert missing == []
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["busy_s"] == pytest.approx(40e-6)
    assert [k["step"] for k in rec["kernels"]] == [0, 0, 1]
    assert [k["knn"] for k in rec["kernels"]] == [False, False, True]
    gaps = dict(rec["breakdown"]["idle_gaps"])
    # [0, 10] under nothing, [40, 60] first under aten::index
    assert gaps["aten::index"] == pytest.approx(20e-6)
    rec.update(step_ms=0.05, flops_per_step=67e12 * 0.05e-3 / 2,
               peak_flops=67e12)
    assert device_busy_ms.read(rec) == pytest.approx(0.02)
    assert device_idle_pct.read(rec) == pytest.approx(60.0)
    assert kernels_per_step.read(rec) == pytest.approx(1.5)
    assert knn_ms.read(rec) == pytest.approx(0.005)
    assert port_kernel_ms.read(rec) == pytest.approx(0.015)
    assert step_mfu_pct.read(rec) == pytest.approx(50.0)


def test_a_lost_kernel_makes_the_trace_incomplete():
    _, missing = trace.reduce_trace(_hand_trace(drop_kernel=True), 2,
                                    None)
    assert any("without their kernel" in m for m in missing)
    _, missing = trace.reduce_trace(_hand_trace(), 2,
                                    {"first_k_indices": 4,
                                     "coo_scatter_add": 0,
                                     "resolve_tiles": 0,
                                     "inclusive_scan": 0})
    assert any(m.startswith("first_k_indices") for m in missing)


def test_mlp_flops_against_a_hand_count():
    # 2 freqs: 3 * 5 = 15 inputs; 15x4, 4x4, (4+15)x4 (skip), 4x1
    assert flops.mlp_flops(2, 4, 2, (1,), 1) == 2 * (60 + 16 + 76 + 4)
    assert flops.mlp_flops(2, 4, 2, (1,), 1, d_extra=3) == \
        2 * (72 + 16 + 76 + 4)
    # 3x3 stride 2 on 8x6: 4x3x2 out of 3 in, then 2x2x5 out of 2 in
    assert flops.conv_flops(8, 6, (2, 5)) == \
        2 * 9 * (4 * 3 * 2 * 3 + 2 * 2 * 5 * 2)


def test_step_flops_by_stage():
    from d3h_bench.reference.config import load_config
    from d3h_bench.registry import config_path

    cfg = load_config(config_path("f3c"))
    sdf = flops.mlp_flops(6, 256, 6, (3,), 1)
    assert sdf == 826880
    init = flops.step_flops(cfg, "init", 674310)
    assert init == pytest.approx(3 * 674310 * sdf + 4 * 50000 * sdf
                                 + 3 * flops.conv_flops(1080, 1080,
                                                        (24, 48, 96)))
    assert flops.step_flops(cfg, "split", 674310) < init
    assert flops.step_flops(cfg, "seq", 0, 196177) > 0


def test_fit_flops_against_a_hand_count():
    from d3h_bench.reference.config import load_config
    from d3h_bench.registry import config_path

    cfg = load_config(config_path("f3c"))
    # forward 826,880 a point; weight gradients as much; input gradients
    # of every layer but the encoding's 39 columns of the input layer and
    # of the skip layer (2 * 39 * 256 each)
    assert flops.step_flops(cfg, "pretrain_sdf", 10) == \
        10 * (3 * 826880 - 2 * 2 * 39 * 256)
