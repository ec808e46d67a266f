"""A temporary copy of the benchmark with tiny throwaway cells, and a run
of the harness in it on the host (`device="cpu"`: the numbers are no
device's; the tests read the result's shape and `correct`)."""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]

#: tiny cells: (name, configuration, regime, loss, the cell whose limits
#: and metrics it takes)
TINY = (("tiny_music.offline", "celt_music_fb_stereo_96k", "offline", 0.0, "celt_music.offline"),
        ("tiny_voice.live", "webrtc_voice_mixed", "live", 0.0, "webrtc_voice.live"))


def tiny_copy(root: pathlib.Path) -> pathlib.Path:
    """BENCHMARK.json and opusbench/ copied under root, with the tiny
    cells added the way a later change adds a cell: new files and new
    entries, no edit to a file the benchmark has.  A tiny cell checks
    all six of its streams against the limits of the cell it shrinks."""
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "opusbench", root / "opusbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, config, regime, loss, like in TINY:
        limits = json.loads((REPO / "opusbench/workloads" / f"{like}.json").read_text())[
            "check"]["limits"]
        mix = {"name": name, "regime": regime, "streams": 6, "loss": loss}
        if regime == "offline":
            mix["steps_per_call"] = 10
        (root / "opusbench/traffic/mixes" / f"{name}.json").write_text(json.dumps(mix))
        (root / "opusbench/workloads" / f"{name}.json").write_text(json.dumps({
            "name": name, "config": config, "traffic": name,
            "check": {"pcm_streams": 6, "limits": limits},
            "why": "a test's tiny cell"}))
        bench["workloads"].append({"name": name, "config": config, "traffic": name,
                                   "chips": 1, "why": "a test's tiny cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_tiny(root: pathlib.Path, cell: str, seed: int = 11, trace: int = 0,
             seconds: float = 0.3, extra: str = "", control: str | None = None) -> tuple:
    """Run the harness on the host in the copy at root, in a fresh
    interpreter; `extra` is Python run first (a fault planted in the
    timed path).  Returns (exit code, result or None, stderr)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)] + (["--control", control] if control else [])
    code = (f"import sys; sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]\n"
            f"{extra}\n"
            "from opusbench import run\n"
            f"sys.exit(run.main({argv!r}, device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=600)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, result, p.stderr
