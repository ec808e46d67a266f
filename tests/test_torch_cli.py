"""`python -m opus_tpu_torch` against `python -m opus_tpu` on the same WAV.

Each case writes a 0.5 s 16-bit WAV (numpy, from a seed), then runs
`encode`, `info` and `decode` through both command lines, each in a
subprocess of its own directory with the same relative file names.  The
port's .opus and .wav files must equal the reference's byte for byte and
its printed lines must be the reference's.  The port's subprocesses run
under `-X importtime`, whose report names every module imported: neither
jax nor opus_tpu may appear.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys
import wave

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# rate, channels, encode options, decode options
CASES = {
    "music-stereo-vbr": (48000, 2, ["--bitrate", "96000", "--vbr"], []),
    "voice-mono-40ms": (16000, 1, ["--application", "voice", "--bitrate", "24000",
                                   "--frame-ms", "40"], ["--rate", "16000"]),
}


def _write_wav(path: pathlib.Path, rate: int, channels: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    t = np.arange(rate // 2) / rate
    phase = np.cumsum(2 * np.pi * (140 + 25 * np.sin(2 * np.pi * 3 * t)) / rate)
    s = 0.3 * np.sign(np.sin(phase)) + 0.1 * np.sin(2 * np.pi * 1500 * t) \
        + 0.02 * rng.standard_normal(t.size)
    pcm = np.stack([s, np.roll(s, 11) * 0.7], -1) if channels == 2 else s[:, None]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.round(np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes())


def _run(package: str, args: list, cwd: pathlib.Path) -> tuple[str, set]:
    """Run one command line; return its standard output and the top-level
    names of the modules it imported."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])}
    r = subprocess.run([sys.executable, "-X", "importtime", "-m", package, *args], cwd=cwd,
                       capture_output=True, text=True, env=env)
    assert r.returncode == 0, (package, args, r.stderr[-2000:])
    imported = {m.group(1).split(".")[0]
                for m in re.finditer(r"^import time:.*\|\s*(\S+)$", r.stderr, re.M)}
    return r.stdout, imported


@pytest.mark.parametrize("case", CASES)
def test_cli_writes_the_reference_bytes(case, tmp_path):
    rate, channels, enc_opts, dec_opts = CASES[case]
    outs = {}
    for package in ("opus_tpu", "opus_tpu_torch"):
        d = tmp_path / package
        d.mkdir()
        _write_wav(d / "in.wav", rate, channels, seed=len(case))
        lines, imported = [], set()
        for args in (["encode", "in.wav", "out.opus", *enc_opts], ["info", "out.opus"],
                     ["decode", "out.opus", "out.wav", *dec_opts]):
            out, mods = _run(package, args, d)
            lines.append(out)
            imported |= mods
        outs[package] = (lines, (d / "out.opus").read_bytes(), (d / "out.wav").read_bytes(),
                         imported)
    want, got = outs["opus_tpu"], outs["opus_tpu_torch"]
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    assert "opus_tpu_torch" in got[3] and not got[3] & {"jax", "opus_tpu"}, got[3]
    assert "opus_tpu" in want[3]  # the report does name the reference where it is imported
    frame = rate * int(enc_opts[enc_opts.index("--frame-ms") + 1] if "--frame-ms" in enc_opts
                       else 20) // 1000
    with wave.open(str(tmp_path / "opus_tpu_torch" / "out.wav"), "rb") as w:
        # the input's whole frames: pre-skip 0, trimmed to the last granule
        assert w.getnframes() == rate // 2 // frame * frame and w.getnchannels() == channels
