"""One run of one cell of the port's benchmark.

    python -m d3h_bench.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Set-up makes the cell's inputs from ``--seed`` (``inputs.py``), builds
the port's training step on them (``program.py``), takes its first three
steps through the benchmark's stage loop (``loop.py``; recorded for
``correct``) and two more, then measures steps for ``--seconds`` between
two device synchronisations. A fit cell (traffic stage ``pretrain_sdf``,
``fit.py``) times calls of the port's SDF pretraining instead, its first
call observed for ``correct`` and warming up. With ``--trace 1`` a profiled window of
``TRACE_STEPS`` steps follows (``trace.py``) and the per-layer readers
(``metrics/``) take their metrics from it. Then the port's state is
freed and the plain reference (``reference/``) recomputes the first three
steps; ``check.py`` compares them.

The last line of stdout is one JSON object: ``correct``, ``attempted``
(the window's steps), ``failed`` (steps whose loss was not finite),
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit. The same numbers are
the last lines of stderr. Without a CUDA device the run exits 2 and
prints no result; if the process holds JAX or the JAX package once the
window has closed, it exits 3.

Not runs of the benchmark, but the checks of ``correct`` itself:
``--control tf32`` runs the port's steps with TF32 matrix products and
convolutions (the reference stays in float32; ``run(control="bf16")``
switches on the port's own bfloat16 field products instead, the control
of the CPU tests); ``--fault`` breaks the port's step underneath;
``--witness truncate`` has the reference keep the port's per-tile raster
capacity. ``readings.py`` runs these over many seeds in one process."""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Optional

T_START = time.perf_counter()


def _age_at_start() -> float:
    """Seconds between the process's start and ``T_START``."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = _age_at_start()
ROOT = os.path.dirname(os.path.abspath(__file__))
# every cache of a run inside the checkout, at a fixed path
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cache", "triton")
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from d3h_bench import check, fit, flops, loop as loop_mod  # noqa: E402
from d3h_bench import program, registry, trace  # noqa: E402
from d3h_bench.inputs import (  # noqa: E402
    clone_tree, log, make_fit_inputs, make_inputs, to_device)

FORBIDDEN = ("jax", "jaxlib", "flax", "d3human_tpu")
WARMUP = 2           # steps after the three checked ones, before the window
TRACE_STEPS = 3      # steps of the traced window (at least; whole calls)
FIT = "pretrain_sdf"  # the stage of a fit cell (``fit.py``)
GIB = float(1 << 30)


def process_seconds() -> float:
    return AGE_AT_START + time.perf_counter() - T_START


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run must not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _fault(state, fault: str):
    """Break the port's step underneath (the check's own tests); returns
    the call that undoes it."""
    if fault in ("stale_state", "half_gradient"):
        inner_step = state.opt.step

        def half(params, grads):
            keys = sorted(grads)
            return inner_step(params, {k: grads[k] if i % 2 else None
                                       for i, k in enumerate(keys)})

        state.opt.step = (half if fault == "half_gradient"
                          else lambda params, grads: None)
        return lambda: None
    if fault == "altered_loss":
        from d3human_tpu_torch.train import step as step_mod

        inner_tick = step_mod.stage_tick

        def tick(*a, **kw):
            out = inner_tick(*a, **kw)
            out["total"] = out["total"] * 1.01
            return out

        step_mod.stage_tick = tick
        return lambda: setattr(step_mod, "stage_tick", inner_tick)
    raise ValueError(f"fault {fault!r}")


def _step_side(cell: dict, seed: int, device, control: str, fault: str,
               witness: str):
    """(inputs, loop, the port's record, the reference's record maker) of
    a training-step cell, set up and checked."""
    inputs = make_inputs(cell, seed, device)
    start = {p: t.detach().cpu().clone()
             for p, t in check.leaves(inputs.params)}
    _fresh_peak(device)
    _control(control)
    overrides = ({"field": {"use_bfloat16": True}} if control == "bf16"
                 else None)
    state, step_fn = program.build(inputs, cell["config_file"], device,
                                   overrides)
    inputs.params = to_device(inputs.params, "cpu")
    undo = _fault(state, fault) if fault else (lambda: None)
    from d3h_bench.reference.model import target_fn

    lp = loop_mod.Loop(step_fn, state, target_fn(inputs),
                       inputs.seeds["stage"], device,
                       inputs.cfg.stages.log_interval)
    prog = check.Record()
    try:
        prog.take(lp, start)
        for _ in range(WARMUP):
            lp.step()
    finally:
        undo()

    def reference():
        return check.reference_record(
            inputs, start, device,
            {"truncate": True} if witness == "truncate" else None)

    n_template = (0 if inputs.template is None
                  else int(inputs.template["v"].shape[0]))
    return inputs, lp, prog, reference, n_template


def _fit_side(cell: dict, seed: int, device, control: str, fault: str):
    """The same of a fit cell (``fit.py``): its first call, observed, is
    the warm-up."""
    inputs = make_fit_inputs(cell, seed, device)
    start = {p: t.detach().cpu().clone()
             for p, t in check.leaves(inputs.params)}
    _fresh_peak(device)
    _control(control)
    overrides = ({"field": {"use_bfloat16": True}} if control == "bf16"
                 else None)
    geo = program.build_fit(inputs, cell["config_file"], device, overrides)
    lp = fit.FitLoop(geo, clone_tree(inputs.params), inputs.target.clone(),
                     inputs.steps_per_call, inputs.lr, device)
    prog = check.Record()
    with fit.observed(geo, prog, start):
        undo = fit.fault(geo, fault) if fault else (lambda: None)
        try:
            lp.step()
        finally:
            undo()
    inputs.params = to_device(inputs.params, "cpu")
    return inputs, lp, prog, lambda: fit.reference_record(inputs, device), 0


def _fresh_peak(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _control(control: str) -> None:
    if control == "tf32":
        from d3h_bench.reference.model import control_tf32

        control_tf32()


def run(cell_name: str, seed: int, seconds: float, traced: bool, device,
        control: str = "", fault: str = "", witness: str = "",
        root: str = ROOT, gaps_out: Optional[dict] = None) -> dict:
    """The result object of one run of ``cell_name`` on ``device``.
    ``witness="truncate"`` has the reference keep the port's per-tile
    capacity (``reference/ops/rasterizer.py``); ``gaps_out`` receives
    every number ``check.gaps`` reads, compared or not."""
    cell = registry.workload(cell_name, root)
    device = torch.device(device)
    cuda = device.type == "cuda"
    program.configure()
    if cell["traffic_data"]["stage"] == FIT:
        inputs, lp, prog, reference, n_template = _fit_side(
            cell, seed, device, control, fault)
    else:
        inputs, lp, prog, reference, n_template = _step_side(
            cell, seed, device, control, fault, witness)
    loop_mod.sync(device)
    setup_s = process_seconds()
    log(f"set-up {setup_s:.2f} s; window of {seconds} s")
    dispatch = [] if traced and lp.steps_per_call == 1 else None
    n, secs = lp.window(seconds, dispatch)
    step_ms = secs * 1e3 / n
    totals = torch.stack(lp.totals[-(n // lp.steps_per_call):]).cpu()
    failed = int((~torch.isfinite(totals)).sum()) * lp.steps_per_call
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window: {n} steps in {secs:.3f} s ({step_ms:.3f} ms a step), "
        f"peak {peak / GIB:.3f} GiB, last scalars {lp.last_scalars}, "
        f"last loss {float(totals[-1])!r}")
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev_info["power"] = _power_limit()
    out = {}
    if traced:
        calls = -(-TRACE_STEPS // lp.steps_per_call)
        record = trace.traced_window(lp, calls, device)
        record.update(
            stage=inputs.stage, step_ms=step_ms, dispatch_s=dispatch,
            flops_per_step=flops.step_flops(
                inputs.cfg, inputs.stage, inputs.n_grid_verts, n_template),
            peak_flops=flops.PEAK_F32)
        metrics = registry.read_metrics(record, inputs.stage)
        dev_info.update(busy_s=record["busy_s"],
                        window_s=record["window_s"])
        out["breakdown"] = record["breakdown"]
    else:
        metrics = {"step_ms": {"value": step_ms, "unit": "ms"},
                   "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    del lp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if control:
        program.configure()
    t_ref = time.perf_counter()
    ref = reference()
    log(f"reference: {time.perf_counter() - t_ref:.2f} s")
    values, worst = check.gaps(prog, ref)
    log(f"all gaps {values}; worst leaves {worst}")
    if gaps_out is not None:
        gaps_out.update(values)
    limits = cell["limits"]
    correct = check.verdict(values, limits) and failed == 0
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev_info, **out,
              "checks": {k: {"value": values[k], "limit": lim}
                         for k, lim in limits.items()}}
    log(f"losses port {prog.losses} reference {ref.losses}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m d3h_bench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("", "tf32"), default="")
    ap.add_argument("--witness", choices=("", "truncate"), default="")
    ap.add_argument("--fault", default="",
                    choices=("", "stale_state", "half_gradient",
                             "altered_loss", "half_batch"))
    args = ap.parse_args(argv)
    chips = int(registry.workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"d3h_bench: the cell {args.workload!r} needs {chips} CUDA "
              "device(s); none or too few are available", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), control=args.control,
                 fault=args.fault, witness=args.witness)
    bad = forbidden_modules()
    if bad:
        print(f"d3h_bench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
