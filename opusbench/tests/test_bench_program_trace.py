"""The metrics read from the program's own tracer (program_trace.py): the
window's steps picked exactly, a program without the tracer read as no
metric, and the program's spans naming the device trace's idle time."""

import json
import re
import types

import pytest

from opusbench import program_trace

from .helpers import run_tiny, tiny_copy

#: the metrics program_trace.py reads
MINE = {"plane_a_span_ms.offline", "plane_a_span_ms.live", "toc_span_ms.live",
        "step_issue_ms.offline", "step_issue_ms.live", "device_wait_ms.live",
        "device_step_ms.live", "device_plan_exec_ms.live"}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def span(name, step):
    return types.SimpleNamespace(name=name, step=step, device=False)


def test_window_steps_before_the_segment():
    """The window is the run.window["steps"] steps before the segment's
    run.trace["steps"], which end at the last step traced."""
    spans = [span("step", i) for i in range(120)] + [span("plane_a", 130)]
    run = types.SimpleNamespace(trace={"steps": 10}, window={"steps": 25})
    assert program_trace.window_steps(spans, run) == (85, 110)
    assert program_trace.window_steps([], run) is None


@pytest.mark.parametrize("cell", ["tiny_music.offline", "tiny_voice.live"])
def test_window_counts_the_windows_steps(copy, cell):
    rc, result, err = run_tiny(copy, cell, seed=2**31 + 91, trace=1)
    assert rc == 0, err[-3000:]
    steps = int(re.search(r"window \S+ s, (\d+) steps", err).group(1))
    first, last = map(int, re.search(r"program trace: window steps (\d+)-(\d+)", err).groups())
    assert last - first + 1 == steps
    served = int(re.search(r"(\d+) steps served in all", err).group(1))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", ()) and m["name"] in MINE}
    # on the host no step is a CUDA graph: the device phases read nothing
    want -= {"device_step_ms.live", "device_plan_exec_ms.live"}
    assert want and want <= set(result["metrics"])
    assert served - last - 1 > 0  # the segment's steps follow the window
    # the program's spans name the idle time; the harness's bare serve
    # label keeps a sliver of it
    gaps = dict(result["breakdown"]["idle_gaps"])
    assert "launch" in gaps
    assert gaps.get("serve", 0.0) < 0.03 * sum(gaps.values())


def test_a_program_without_the_tracer(copy):
    """With the tracer's import failing (as in a program that has none),
    a traced run still succeeds, without the metrics that read it."""
    extra = ("import sys, opus_tpu_torch.batch.pipeline, opus_tpu_torch.batch.opus_pipeline\n"
             "import opus_tpu_torch\n"
             "del opus_tpu_torch.trace\n"
             "sys.modules['opus_tpu_torch.trace'] = None\n")
    rc, result, err = run_tiny(copy, "tiny_voice.live", seed=2**31 + 92, trace=1, extra=extra)
    assert rc == 0, err[-3000:]
    assert not set(result["metrics"]) & MINE
    assert {"plane_a_ms.live", "toc_ms.live"} <= set(result["metrics"])
    assert "program trace" not in err
