"""Write tests/data/switch_traffic.npz: Opus streams that switch modes and
SILK bandwidths, the traffic whose redundant CELT blocks the mixed serving
loop shadow-decodes (opus_tpu_torch/batch/opus_pipeline.py).

    python3 tools/make_switch_traffic.py [--out PATH]

24 sequences of 13 frames of 20 ms, from libopus (the system library,
through opus_tpu.oracle, as the reference's tests encode):

* even sequences 2k (k = 0..11): stereo at 64 kbps with forced modes CELT
  -> SILK -> hybrid -> CELT, switching at steps that differ per sequence
  (the coded bandwidth forced to WB while SILK, FB otherwise); music while CELT, voice otherwise (the content of
  tests/test_mixed_plan.py's mode-switch gate, with the pitch, the tones
  and the phase moved per sequence);
* odd sequences 2k + 1: SILK-only mono at 24 kbps whose maximum bandwidth
  switches NB -> WB at step 1 + k (libopus follows a few frames later,
  and codes MB under that maximum at 24 kbps; the last sequences end
  before it does).

libopus places a switch's redundancy itself: a silk_to_celt block rides
the last SILK or hybrid frame, a celt_to_silk block the first SILK frame.
The script decodes the traffic through the port's plane A and asserts
that every step from 1 on carries at least one redundant block across the
24 sequences, that both kinds occur, and that the file stays under 100 KB.

The file holds `packets`, every packet (ToC included) joined in a flat
uint8 blob, stream-major then step, and `lengths`, int32 [24, 13]; no
pickled objects, so numpy alone reads it (np.load(..., allow_pickle=False)).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

F, STEPS, SEQS = 960, 13, 24
OUT = ROOT / "tests" / "data" / "switch_traffic.npz"
NB, WB, FB = 1101, 1103, 1105  # OPUS_BANDWIDTH_NARROWBAND / _WIDEBAND / _FULLBAND


def mode_switches(k: int) -> tuple[int, int, int]:
    """Stereo sequence k's first SILK, first hybrid and second CELT steps."""
    silk = 1 + k % 6
    hybrid = silk + 2
    return silk, hybrid, min(hybrid + 4 + k // 6, STEPS - 1)


def stereo_sequence(oracle, k: int) -> list:
    rng = np.random.default_rng(4 + k)
    t = np.arange(F * STEPS) / 48000.0
    f0 = 110.0 + 10.0 * k
    ph = np.cumsum(2 * np.pi * (f0 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0) + 0.4 * k
    voice = 0.3 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)
    tone = 440.0 * 2.0 ** (k / 12.0)
    music = (0.4 * np.sin(2 * np.pi * tone * t + 0.7 * k)
             + 0.2 * np.sin(2 * np.pi * 4.0 * tone * t))
    silk, hybrid, celt = mode_switches(k)
    modes = [oracle.MODE_CELT_ONLY] * silk + [oracle.MODE_SILK_ONLY] * (hybrid - silk) \
        + [oracle.MODE_HYBRID] * (celt - hybrid) + [oracle.MODE_CELT_ONLY] * (STEPS - celt)
    is_celt = np.repeat([m == oracle.MODE_CELT_ONLY for m in modes], F)
    mix = np.where(is_celt, music, voice)
    pcm = np.stack([mix, 0.8 * np.roll(mix, 9)], -1).astype(np.float32)
    enc = oracle.Encoder(48000, 2)
    enc.ctl(oracle.SET_BITRATE, 64000)
    out = []
    for f in range(STEPS):
        enc.ctl(oracle.SET_FORCE_MODE, modes[f])
        # SILK-only codes at most WB: above it libopus codes hybrid
        enc.ctl(oracle.SET_BANDWIDTH, WB if modes[f] == oracle.MODE_SILK_ONLY else FB)
        out.append(enc.encode_float(np.ascontiguousarray(pcm[f * F : (f + 1) * F]).ravel(), F))
    return out


def bandwidth_sequence(oracle, k: int) -> list:
    rng = np.random.default_rng(40 + k)
    t = np.arange(F * STEPS) / 48000.0
    f0 = 120.0 + 12.0 * k
    ph = np.cumsum(2 * np.pi * (f0 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0) + 0.5 * k
    voice = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    enc = oracle.Encoder(48000, 1)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
    enc.ctl(oracle.SET_BITRATE, 24000)
    out = []
    for f in range(STEPS):
        enc.ctl(oracle.SET_MAX_BANDWIDTH, NB if f < 1 + k else WB)
        out.append(enc.encode_float(voice[f * F : (f + 1) * F], F))
    return out


def redundancy(seqs: list) -> np.ndarray:
    """Plane A's redundancy per (step, stream): 0 none, 1 a silk_to_celt
    block, 2 a celt_to_silk block (the port's descriptors, served on the
    CPU)."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    dec = BatchedOpusDecoder(len(seqs), 2, transfer="p10", device="cpu")
    real = dec._collect_corrections
    seen = np.zeros((STEPS, len(seqs)), np.int32)

    def spy(packets, rcs, *rest):
        red = (rcs > 0) & (rcs & 1 == 1)
        seen[spy.step] = np.where(red, 1 + ((rcs >> 1) & 1), 0)
        return real(packets, rcs, *rest)

    dec._collect_corrections = spy
    for f in range(STEPS):
        spy.step = f
        dec.serve([[s[f] for s in seqs]])
    return seen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    out = ap.parse_args().out
    from opus_tpu import oracle

    if not oracle.available():
        print("make_switch_traffic: libopus is not present", file=sys.stderr)
        return 2
    seqs = [stereo_sequence(oracle, j // 2) if j % 2 == 0 else bandwidth_sequence(oracle, j // 2)
            for j in range(SEQS)]
    seen = redundancy(seqs)
    for f in range(STEPS):
        print(f"step {f}: silk_to_celt blocks in sequences {np.flatnonzero(seen[f] == 1).tolist()}, "
              f"celt_to_silk in {np.flatnonzero(seen[f] == 2).tolist()}")
    missing = [f for f in range(1, STEPS) if not seen[f].any()]
    if missing or not (seen == 1).any() or not (seen == 2).any():
        raise AssertionError(f"steps {missing} carry no redundant block, or a kind is missing")
    lengths = np.array([[len(p) for p in s] for s in seqs], np.int32)
    blob = np.frombuffer(b"".join(p for s in seqs for p in s), np.uint8)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, packets=blob, lengths=lengths)
    size = out.stat().st_size
    print(f"wrote {out}: {SEQS} sequences x {STEPS} steps, {blob.size} packet bytes, "
          f"{size} bytes on disk")
    if size >= 100_000:
        raise AssertionError(f"{out} is {size} bytes, over 100 KB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
