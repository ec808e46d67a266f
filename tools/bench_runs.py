"""Summarise runs of `python -m opus_tpu_torch.bench` across calls.

    python3 tools/bench_runs.py RUNS.jsonl [RUNS.jsonl ...]

Reads the one JSON line each run printed (one line a run, any number of
files) and prints, for every numeric row, its best, median and spread
(max / min) over the runs, one JSON object a row, then the runs' winners,
cards, wall times and host cores.  The best of a rate is its largest
value, of a time (`p50_step_ms`, `*_s`) its smallest.  The standard
library only; no card needed.
"""

from __future__ import annotations

import json
import statistics
import sys


def rows(runs: list[dict]) -> dict:
    """{key: {best, median, spread, n}} over the runs' numeric keys."""
    out = {}
    for key in runs[0]:
        vals = [r.get(key) for r in runs]
        if not all(isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0
                   for v in vals):
            continue
        lower_is_better = key == "p50_step_ms" or key.endswith("_s")
        out[key] = {"best": min(vals) if lower_is_better else max(vals),
                    "median": statistics.median(vals), "spread": max(vals) / min(vals),
                    "n": len(vals)}
    return out


def main(paths: list[str]) -> int:
    runs = [json.loads(line) for p in paths for line in open(p) if line.strip()]
    if not runs:
        raise SystemExit("no runs")
    for key, row in rows(runs).items():
        print(json.dumps({"row": key, **row}))
    print(json.dumps({"runs": len(runs),
                      "serve_transfer_mode": [r["serve_transfer_mode"] for r in runs],
                      "card": sorted({r["card"] for r in runs}),
                      "wall_s": [r["wall_s"] for r in runs],
                      "host_cores": sorted({r["host_cores"] for r in runs}),
                      "host_cpus_usable": sorted({r["host_cpus_usable"] for r in runs}),
                      "packet_source": sorted({r["packet_source"] for r in runs})}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
