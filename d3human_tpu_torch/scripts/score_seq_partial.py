"""Score whatever seq frames exist and write the seq parity entry
(counterpart of ``scripts/score_seq_partial.py``).

The CLI records the seq entry of PARITY.json only after all frames, so a
run cut during the seq stage leaves per-frame meshes (``fine_all_<f>.ply``)
but no entry. This scorer takes the CLI's measure, the per-frame Chamfer
of the fitted seq mesh against the synthetic ground truth's posed surface,
over the frames that finished, and merges the entry into
``<out>/PARITY.json``, with a ``partial`` marker when fewer than
``stages.seq_max_frames`` are done.

    python -m d3human_tpu_torch.scripts.score_seq_partial --out-dir <run> \\
        --config <the run's config> --n-frames <the run's frames> \\
        [--device cuda|cpu]

``--device`` is ``cuda`` unless asked otherwise (a card takes a second
process beside a running trainer); without a card the run stops with a
message.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Optional

import numpy as np

from d3human_tpu_torch import train_d3h
from d3human_tpu_torch.config import load_config
from d3human_tpu_torch.data.synthetic import make_scene
from d3human_tpu_torch.utils.backend import device_or_exit
from d3human_tpu_torch.utils.io import read_ply
from d3human_tpu_torch.utils.metrics import mesh_chamfer

NAME = "d3human_tpu_torch.scripts.score_seq_partial"


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(prog=NAME)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--config", default="configs/f3c_synth_full4.json")
    p.add_argument("--n-frames", type=int, default=64,
                   help="synthetic capture frame count (the CLI's "
                        "--synthetic-frames)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.config, overrides={"out_dir": args.out_dir})
    seq_dir = os.path.join(cfg.out_dir, "seq")
    if not os.path.isdir(seq_dir):
        print("no seq dir; nothing to score")
        return 1
    dev = device_or_exit(NAME, args.device)
    scene = make_scene(resolution=tuple(cfg.render.train_res),
                       n_frames=args.n_frames, device=dev)

    chs = {}
    for fn in sorted(os.listdir(seq_dir)):
        m = re.match(r"fine_all_(\d+)\.ply", fn)
        if not m:
            continue
        frame = int(m.group(1))
        v, f = read_ply(os.path.join(seq_dir, fn))
        gt_v, gt_f = train_d3h._synth_gt_mesh(scene, frame)
        chs[frame] = mesh_chamfer(v, f, gt_v, gt_f,
                                  train_d3h.PARITY_SAMPLES, device=dev)
        print(f"frame {frame}: chamfer {chs[frame]:.6f}", flush=True)
    if not chs:
        print("no completed seq frames; nothing to score")
        return 1

    ppath = os.path.join(cfg.out_dir, "PARITY.json")
    parity = {"config": args.config, "stages": {}}
    if os.path.exists(ppath):
        with open(ppath) as fh:
            parity = json.load(fh)
    entry = {
        "chamfer_per_frame_mean": round(float(np.mean(list(chs.values()))), 6),
        "chamfer_per_frame_max": round(float(np.max(list(chs.values()))), 6),
        "n_frames": len(chs),
        "per_frame": {str(k): round(float(v), 6) for k, v in chs.items()},
    }
    if len(chs) < cfg.stages.seq_max_frames:
        entry["partial"] = (f"{len(chs)}/{cfg.stages.seq_max_frames} frames "
                            f"done at scoring time")
    parity.setdefault("stages", {})["seq"] = entry
    with open(ppath, "w") as fh:
        json.dump(parity, fh, indent=1)
    print(json.dumps({"seq": entry}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
