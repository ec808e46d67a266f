"""The port's benchmark (`opus_tpu_torch/bench.py`) against the reference's
`bench.py`, on the CPU at the reference's smoke shapes.

One in-process run of `main(["--smoke", "--device", "cpu"])` (module
fixture) must print one JSON line holding every key of the reference's
result dict, read from `bench.py`'s syntax tree, with every rate above 0.
Where libopus loads, the port's traffic must equal, byte for byte, the
reference's recipe rebuilt here with `opus_tpu.oracle` (headline CELT
payloads, mixed and multistream packets, the 5% loss mask), and the upload
bytes a stream must equal the reference's `NativeBatchFrontEnd` plan slot
on the same packets.  A second run with libopus hidden serves the native
encoders' traffic and reports the libopus rows as null.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import pathlib

import numpy as np
import pytest

from opus_tpu import oracle
from opus_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parent.parent
needs_libopus = pytest.mark.skipif(not oracle.available(), reason="libopus not present")


def reference_result_keys() -> list[str]:
    """The keys of the dict literal bound to `result` in bench.py's main()
    (`bench.py:678-708`)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets if isinstance(t, ast.Name)] == ["result"]
                and any(isinstance(k, ast.Constant) and k.value == "metric"
                        for k in node.value.keys)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict literal in bench.py main()")


def run_smoke() -> dict:
    """bench.main's one line of a CPU smoke run, parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(["--smoke", "--device", "cpu"]) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def line():
    return run_smoke()


def check_line(got: dict) -> None:
    keys = reference_result_keys()
    assert tuple(keys) == bench.REFERENCE_KEYS
    assert set(keys) <= set(got), set(keys) - set(got)
    absent = got["libopus"] == "absent"
    for k in keys:
        v = got[k]
        if v is None:
            assert absent and k in bench.LIBOPUS_KEYS, k
        elif not isinstance(v, str):
            assert v > 0, (k, v)
    assert got["serve_transfer_mode"] in ("plan", "p10")
    assert got["metric"] == "audio_sec_decoded_per_sec_per_chip"
    assert got["value"] == got["realtime_factor_per_chip"]
    assert got["vs_baseline"] == pytest.approx(got["value"] / 5000.0)
    assert got["p50_step_ms"] == pytest.approx(32 * 0.02 / got["device_plane_audio_sec_per_sec"]
                                               * 1e3)
    reps = bench.REPS[True]
    for prefix, n in (("", 1 + reps["serves"]), ("mixed_", reps["rows"]),
                      ("multistream_", reps["rows"]), ("loss_", reps["rows"])):
        runs = got[f"{prefix}serve_runs_s"]
        assert len(runs) == n and min(runs) > 0
        assert got[f"{prefix}serve_median_s"] == pytest.approx(float(np.median(runs)))
        assert got[f"{prefix}serve_spread"] == pytest.approx(max(runs) / min(runs))
    assert got["value"] == pytest.approx(4 * 32 * 0.02 / min(got["serve_runs_s"]))
    ab = got["ab_serve_s"]
    assert set(ab) == {"plan", "p10"} and min(ab.values()) == ab[got["serve_transfer_mode"]]
    assert ab[got["serve_transfer_mode"]] == got["serve_runs_s"][0]
    for k in ("plan_fallbacks", "mixed_plan_fallbacks", "multistream_plan_fallbacks",
              "loss_plan_fallbacks"):
        assert got[k] == 0, k
    assert got["scaling_batches"] == [64, 128]
    assert set(got["peak_memory_bytes"]) == {"headline", "device_plane", "mixed", "multistream",
                                             "loss", "device_plane_64", "device_plane_128"}
    assert all(v is None for v in got["peak_memory_bytes"].values())  # the CPU has no count
    assert got["host_cores"] >= got["host_cpus_usable"] >= 1
    assert (got["card"], got["device"], got["smoke"]) == ("cpu", "cpu", True)
    assert isinstance(got["plane_a_openmp"], bool)
    assert 1 <= got["plane_a_shards"] <= max(1, got["host_cpus_usable"] - 1)
    assert got["plane_a_shards"] == 1 or not got["plane_a_openmp"]
    assert 0 <= got["build_s"] < got["wall_s"]
    want = (bench.P10_UPLOAD_BYTES if got["serve_transfer_mode"] == "p10"
            else got["plan_upload_bytes_per_stream"])
    assert got["upload_bytes_per_stream"] == want


def test_smoke_line_has_every_reference_key(line):
    check_line(line)
    assert line["libopus"] == ("present" if oracle.available() else "absent")
    assert line["packet_source"] == (oracle.version() if oracle.available() else "native")


def test_smoke_line_without_libopus(monkeypatch):
    """With libopus hidden the traffic comes from the native encoders and
    only the libopus rows are null."""
    from opus_tpu_torch import oracle as port_oracle

    monkeypatch.setattr(port_oracle, "available", lambda: False)
    got = run_smoke()
    check_line(got)
    assert (got["libopus"], got["packet_source"]) == ("absent", "native")
    assert all(got[k] is None for k in bench.LIBOPUS_KEYS)


def reference_traffic(batch: int, steps: int, msb: int) -> dict:
    """The reference's packets, built as bench.py builds them
    (`:259-269`, `:330-331`, `:366-368`, `:534-556`, `:581-594`,
    `:617-620`), with the reference's oracle and packet parser."""
    from opus_tpu import parse_packet

    FRAME, NSRC = 960, 16
    enc = oracle.Encoder(48000, 2)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    enc.ctl(oracle.SET_BITRATE, 96000)
    rng = np.random.default_rng(1)
    t = np.arange(FRAME * NSRC) / 48000.0
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(t.size)
    pcm = np.stack([sig, 0.8 * np.roll(sig, 7)], -1).astype(np.float32)
    pkts = [enc.encode_float(pcm[f * FRAME : (f + 1) * FRAME].ravel(), FRAME)
            for f in range(NSRC)]
    payloads = [p[parse_packet(p).payload_offset :] for p in pkts]
    batches = [[payloads[(i + s) % NSRC] for i in range(batch)] for s in range(steps)]
    for _ in range(2):  # the native and the libopus encode rows' voice draws
        rng.standard_normal(t.size)
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    voice2 = np.stack([voice, np.roll(voice, 13) * 0.7], -1).astype(np.float32)
    encs = {"silk": oracle.Encoder(48000, 1), "hybrid": oracle.Encoder(48000, 2)}
    encs["silk"].ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
    encs["silk"].ctl(oracle.SET_BITRATE, 24000)
    encs["silk"].ctl(oracle.SET_MAX_BANDWIDTH, 1103)
    encs["hybrid"].ctl(oracle.SET_FORCE_MODE, oracle.MODE_HYBRID)
    encs["hybrid"].ctl(oracle.SET_BITRATE, 64000)
    mixed = []
    for f in range(steps):
        fr = slice((f % NSRC) * FRAME, (f % NSRC + 1) * FRAME)
        per_mode = {
            "celt": pkts[f % NSRC],
            "silk": encs["silk"].encode_float(voice[fr], FRAME),
            "hybrid": encs["hybrid"].encode_float(np.ascontiguousarray(voice2[fr]).ravel(), FRAME),
        }
        keys = ["celt", "silk", "hybrid"]
        mixed.append([per_mode[keys[i % 3]] for i in range(batch)])
    streams, coupled, mch = 5, 3, 8
    mse = oracle.MultistreamEncoder(48000, mch, streams, coupled, list(range(mch)))
    mse.ctl(oracle.SET_BITRATE, 256000)
    mse.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    ms = []
    for f in range(6):
        sl = slice((f % NSRC) * FRAME, (f % NSRC + 1) * FRAME)
        mpcm = np.stack([0.3 * np.sin(2 * np.pi * (200 + 60 * k) * t[sl])
                         + 0.02 * rng.standard_normal(FRAME) for k in range(mch)], -1
                        ).astype(np.float32)
        ms.append([mse.encode_float(np.ascontiguousarray(mpcm).ravel(), FRAME)] * msb)
    lrng = np.random.default_rng(7)
    lossy = [[None if lrng.random() < 0.05 else pk for pk in b] for b in batches]
    return dict(pkts=pkts, batches=batches, mixed=mixed, ms=ms, lossy=lossy)


@needs_libopus
def test_traffic_is_the_reference_recipe():
    size = bench.sizes(True)
    got = bench.traffic(size, bench.signals(), use_libopus=True)
    want = reference_traffic(size["batch"], size["steps"], size["ms_sessions"])
    for k in ("pkts", "batches", "mixed", "ms", "lossy"):
        assert got[k] == want[k], k
    assert sum(p is None for b in got["lossy"] for p in b) > 0


@needs_libopus
def test_upload_bytes_are_the_reference_plan_slot(line):
    """The plan slot's used words x 4 / B of the reference's plane A on the
    same packets, after as many decodes as the host row runs (the C++ is
    byte-identical)."""
    from opus_tpu.native.frontend import NativeBatchFrontEnd

    size = bench.sizes(True)
    batches = reference_traffic(size["batch"], size["steps"], size["ms_sessions"])["batches"]
    front = NativeBatchFrontEnd(size["batch"], 2, 1)
    slot = front.alloc_plan_slots(2)[0]
    for _ in range(bench.REPS[True]["host"]):
        front.decode_batch_plan_into(batches[0], 960, slot)
    assert line["plan_upload_bytes_per_stream"] == slot["used_words"] * 4 / size["batch"]
