"""Find a live cell's capacity: its regime at several stream counts.

    python3 -m opusbench.sweep --workload <live cell> --streams 256,384,512 \
        [--seconds 8] [--seed 1] [--loss 0.05]

On the card, one process, one decoder at a time (each freed before the
next).  For each count it warms up as a run does, serves the live regime
for `--seconds`, and prints one JSON line: frame_ms_p50, frame_ms_p95 and
the backlog's growth (how much later, in ms, the ticks of the window's
last fifth began than those of its first fifth; it grows without bound
above capacity).  No correctness check: the runs of the cell make it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np

from .run import prepare
from .spec import Cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m opusbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", required=True, help="comma-separated stream counts")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--loss", type=float, default=None,
                    help="the share of packets lost, in place of the cell's traffic's")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = Cell(args.workload)
    if cell.traffic["regime"] != "live":
        raise ValueError(f"{args.workload} is not a live cell")
    if args.loss is not None:
        cell.traffic = dict(cell.traffic, loss=args.loss)
    for n in (int(x) for x in args.streams.split(",")):
        ctx, regime = prepare(cell, args.seed, "cuda", streams=n)
        regime.warm(ctx)
        torch.cuda.synchronize()
        w = regime.window(ctx, args.seconds)
        lat, late = w["latency_s"] * 1e3, w["late_s"] * 1e3
        fifth = max(1, lat.size // 5)
        print(json.dumps({
            "workload": args.workload, "streams": n, "loss": cell.traffic["loss"],
            "ticks": int(lat.size),
            "frame_ms_p50": float(np.percentile(lat, 50)),
            "frame_ms_p95": float(np.percentile(lat, 95)),
            "frame_ms_p99": float(np.percentile(lat, 99)),
            "over_20ms": int((lat > 20).sum()),
            "backlog_growth_ms": float(late[-fifth:].mean() - late[:fifth].mean()),
            "card": torch.cuda.get_device_name(0)}), flush=True)
        del ctx
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
