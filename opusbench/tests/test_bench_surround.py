"""The 7.1 surround cell, surround71.live: its files, its decoder adapter,
and a tiny copy of it (three sessions) run on the host end to end, as
tiny_copy's cells are, against the multistream reference."""

import json
import re

import pytest

from opusbench.spec import Cell, load_module
from opusbench.traffic.schedule import Pool

from .helpers import run_tiny, tiny_copy

CELL = "surround71.live"
TINY = "tiny_surround.live"
SESSIONS = 3


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """tiny_copy with a cell of three surround sessions added as a change
    adds one (new files, new entries), every session sampled, under the
    limits and metrics of surround71.live."""
    root = tiny_copy(tmp_path_factory.mktemp("surround"))
    cell = Cell(CELL)
    (root / "opusbench/traffic/mixes" / f"{TINY}.json").write_text(json.dumps(
        dict(cell.traffic, name=TINY, streams=SESSIONS)))
    (root / "opusbench/workloads" / f"{TINY}.json").write_text(json.dumps(dict(
        cell.workload, name=TINY, traffic=TINY,
        check=dict(cell.workload["check"], pcm_streams=SESSIONS))))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(cell.entry, name=TINY, traffic=TINY))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_the_cells_files_load():
    cell = Cell(CELL)
    assert cell.traffic["regime"] == "live" and cell.traffic["loss"] == 0.0
    assert cell.traffic["streams"] % 16 == 0 and cell.entry["chips"] == 1
    layout, dec = cell.config["layout"], cell.config["decoder"]
    assert {k: dec[k] for k in ("channels", "streams", "coupled", "mapping")} == {
        k: layout[k] for k in ("channels", "streams", "coupled", "mapping")}
    assert (dec["adapter"], dec["mode"], dec["transfer"]) == ("multistream", "celt", "plan")
    assert cell.config["reduced"] == [] and list(cell.config["controls"]) == ["p8"]
    assert [m["name"] for m in cell.end_to_end] == ["frame_ms_p50", "setup_s"]
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"split_span_ms.live", "unmap_span_ms.live", "plane_a_span_ms.live"} <= per_layer
    assert "plane_a_ms.live" not in per_layer  # its timer wraps a single-stream decoder
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    assert cell.workload["check"]["limits"]["range_mismatches"] == 0


@pytest.mark.parametrize("code", [1, 2, 3])
def test_the_adapter_refuses_a_packet_that_is_not_code_0(code):
    adapter = load_module("decoders", "multistream")
    packet = Pool("surround71_fb_416k").packets[0][0]
    assert adapter.entry(packet) is packet
    with pytest.raises(ValueError, match="single frames"):
        adapter.entry(bytes([packet[0] | code]) + packet[1:])
    with pytest.raises(ValueError):
        adapter.entry(b"")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_surround_cell_is_correct(copy, trace):
    rc, result, err = run_tiny(copy, TINY, seed=2**31 + 23, trace=trace)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["range_mismatches"]["value"] == 0
    compared = int(re.search(r"check: (\d+) final ranges compared", err).group(1))
    steps = int(re.search(r"window \S+ s, (\d+) steps", err).group(1))
    assert compared >= steps * SESSIONS
    if trace:
        metrics = result["metrics"]
        assert metrics["split_span_ms.live"]["value"] > 0
        assert metrics["unmap_span_ms.live"]["value"] > 0
        # one band-limited elementary stream, the LFE, a session a step
        counted = re.search(r"window counters \{[^}]*'band_limited_streams': (\d+)", err)
        assert int(counted.group(1)) == SESSIONS * steps
    else:
        assert set(result["metrics"]) == {"frame_ms_p50", "setup_s"}


def test_the_p8_control_is_not_correct(copy):
    rc, result, err = run_tiny(copy, TINY, seed=2**31 + 24, control="p8")
    assert rc == 0, err[-3000:]
    assert result["checks"]["range_mismatches"]["value"] == 0
    assert result["correct"] is False, result["checks"]
