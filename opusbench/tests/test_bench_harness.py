"""The harness end to end on the host, at a tiny stream count, in a
temporary copy to which a cell and a metric were added by new files and
new entries only."""

import json
import re

import pytest

from .helpers import run_tiny, tiny_copy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tiny_copy(tmp_path_factory.mktemp("bench"))
    # a throwaway per-layer metric, added as a later change would add one
    (root / "opusbench/metrics/steps_served.tiny.py").write_text(
        "def read(run):\n    return run.window['steps']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_served.tiny", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "audio_s_per_s", "workloads": ["tiny_music.offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def wanted(root, cell, kind):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", ["tiny_music.offline", "tiny_voice.live"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(copy, cell, trace):
    rc, result, err = run_tiny(copy, cell, seed=2**31 + 77, trace=trace)
    assert rc == 0, err[-3000:]
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = wanted(copy, cell, kind)
    if trace:
        # on the host the profiler sees no device: only the device readers
        # find nothing to read
        want = {m for m in want if not m.startswith(("device_", "rotation_"))}
    assert want <= set(result["metrics"]), (want, result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert list(result["checks"]) == ["range_mismatches", "pcm_max_abs"]
    assert result["device"]["platform"] == "cpu"
    # the numbers compared, beside their limits, are stderr's last lines
    assert err.strip().splitlines()[-1].startswith("check pcm_max_abs:")
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])


@pytest.mark.parametrize("cell", ["tiny_music.offline", "tiny_voice.live"])
def test_every_step_range_is_compared(copy, cell):
    """Every stream's final range at every step of the window, also
    inside the offline regime's many-step calls."""
    rc, result, err = run_tiny(copy, cell, seed=2**31 + 78)
    assert rc == 0, err[-3000:]
    steps = int(re.search(r"window \S+ s, (\d+) steps", err).group(1))
    compared = int(re.search(r"check: (\d+) final ranges compared", err).group(1))
    assert steps >= 10 and compared == steps * 6


def test_added_metric_is_read(copy):
    rc, result, err = run_tiny(copy, "tiny_music.offline", seed=4, trace=1)
    assert rc == 0, err[-3000:]
    assert result["metrics"]["steps_served.tiny"]["value"] >= 10


def test_no_card_no_result(copy):
    """Without a CUDA device a run exits non-zero and prints no result."""
    import subprocess
    import sys

    from .helpers import REPO

    code = (f"import sys; sys.path[:0] = [{str(copy)!r}, {str(REPO)!r}]\n"
            "import torch; torch.cuda.is_available = lambda: False\n"
            "from opusbench import run\n"
            "sys.exit(run.main(['--workload', 'tiny_music.offline', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
