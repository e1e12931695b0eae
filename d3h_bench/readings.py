"""The readings that a cell's limits are set from (not a run of the
benchmark): in one process, the port's runs on ``--seeds``, the TF32
control's on ``--control-seeds`` and each fault's on ``--fault-seeds``,
each with a window of ``--seconds``. One JSON line a run on stdout with
every number ``check.gaps`` reads.

    python -m d3h_bench.readings --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--faults stale_state,half_batch]
        [--fault-seeds 7,8,9] [--seconds 1]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from d3h_bench import run


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m d3h_bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    plan = [("sound", s, {}) for s in _ints(args.seeds)]
    plan += [("tf32", s, {"control": "tf32"})
             for s in _ints(args.control_seeds)]
    plan += [(f, s, {"fault": f}) for f in args.faults.split(",") if f
             for s in _ints(args.fault_seeds)]
    for kind, seed, kw in plan:
        gaps = {}
        try:
            r = run.run(args.workload, seed, args.seconds, False, dev,
                        gaps_out=gaps, **kw)
            line = {"kind": kind, "seed": seed, "correct": r["correct"],
                    "failed": r["failed"], "gaps": gaps,
                    "step_ms": r["metrics"]["step_ms"]["value"],
                    "peak_gib": r["metrics"]["peak_mem_gib"]["value"]}
        except Exception as exc:  # a control or fault that crashes fails
            line = {"kind": kind, "seed": seed, "error": repr(exc)[:300]}
        print(json.dumps(line), flush=True)
        run.program.configure()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
