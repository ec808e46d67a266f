"""Write tests/data/multistream_traffic.npz: multistream Opus sessions
(RFC 7845 channel mapping family 1) from libopus, for the port's
BatchedMultistreamDecoder on a machine without libopus.

    python3 tools/make_multistream_traffic.py [--out PATH]

Three groups of sessions, each encoded by its own libopus multistream
encoder (the system library, through opus_tpu.oracle, as the reference's
tests encode) and decoded by a libopus multistream decoder, whose
final_range after every packet is kept:

* ambi: 8 sessions x 8 packets of 20 ms in the 8-channel layout of the
  reference benchmark's multistream row (5 streams, 3 coupled, mapping
  0-7), CELT-only at 256 kbps: eight tones and noise, moved per session;
* silk: 4 sessions x 8 packets of 20 ms, 3 channels in 2 streams (1
  coupled), VOIP at 48 kbps, SILK-only, bandwidth at most WB: a pulse
  train voice, delayed per channel and session;
* c40: 4 sessions x 4 packets of 40 ms (two 20 ms frames in a code-3
  packet per elementary stream), 4 channels in 3 streams (1 coupled),
  CELT-only at 256 kbps.

For group g the file holds `g_packets` (every packet joined in a flat
uint8 blob, session-major then packet), `g_lengths` int32 [sessions,
packets], `g_ranges` uint32 [sessions, packets] (libopus's final range)
and `g_layout` int32 [channels, streams, coupled, mapping...]; no pickled
objects, so numpy alone reads it (np.load(..., allow_pickle=False)).  The
script checks that every elementary packet of c40 holds two frames and
that the file stays under 150 KB.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "tests" / "data" / "multistream_traffic.npz"
F = 960
WB = 1103  # OPUS_BANDWIDTH_WIDEBAND
#: group -> (sessions, packets, frames a packet, channels, streams, coupled, mapping)
GROUPS = {
    "ambi": (8, 8, 1, 8, 5, 3, list(range(8))),
    "silk": (4, 8, 1, 3, 2, 1, [0, 1, 2]),
    "c40": (4, 4, 2, 4, 3, 1, [0, 1, 2, 3]),
}


def music(n: int, channels: int, seed: int) -> np.ndarray:
    """[n, channels]: a tone per channel (200 + 60 k + 15 seed Hz) and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    return np.stack([0.3 * np.sin(2 * np.pi * (200 + 60 * k + 15 * seed) * t)
                     + 0.02 * rng.standard_normal(n) for k in range(channels)],
                    -1).astype(np.float32)


def voice(n: int, channels: int, seed: int) -> np.ndarray:
    """[n, channels]: a pulse-train voice with vibrato, delayed per channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    ph = np.cumsum(2 * np.pi * (130 + 10 * seed + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    v = 0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(n)
    return np.stack([np.roll(v, 17 * k + 5 * seed) for k in range(channels)],
                    -1).astype(np.float32)


def session(oracle, group: str, seed: int) -> tuple[list, list]:
    """One session's packets and libopus's final range after each."""
    _, packets, frames, channels, streams, coupled, mapping = GROUPS[group]
    app = oracle.APPLICATION_VOIP if group == "silk" else oracle.APPLICATION_AUDIO
    enc = oracle.MultistreamEncoder(48000, channels, streams, coupled, mapping, application=app)
    dec = oracle.MultistreamDecoder(48000, channels, streams, coupled, mapping)
    if group == "silk":
        enc.ctl(oracle.SET_BITRATE, 48000)
        enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
        enc.ctl(oracle.SET_MAX_BANDWIDTH, WB)
    else:
        enc.ctl(oracle.SET_BITRATE, 256000)
        enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    n = F * frames
    pcm = (voice if group == "silk" else music)(n * packets, channels, seed)
    pkts, ranges = [], []
    for p in range(packets):
        pkt = enc.encode_float(np.ascontiguousarray(pcm[p * n : (p + 1) * n]).ravel(), n)
        dec.decode_float(pkt, n)
        pkts.append(pkt)
        ranges.append(dec.final_range)
    return pkts, ranges


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    out = ap.parse_args().out
    from opus_tpu import oracle
    from opus_tpu_torch.batch.multistream_pipeline import split_multistream_packet

    if not oracle.available():
        print("make_multistream_traffic: libopus is not present", file=sys.stderr)
        return 2
    arrays = {}
    for group, (sessions, packets, frames, channels, streams, coupled, mapping) in GROUPS.items():
        pkts, ranges = zip(*(session(oracle, group, s) for s in range(sessions)))
        for pk in (p for sess in pkts for p in sess):
            counts = {len(fr) for _, fr in split_multistream_packet(pk, streams)}
            if counts != {frames}:
                raise AssertionError(f"{group}: elementary packets of {counts} frames, "
                                     f"not {frames}")
        arrays[f"{group}_packets"] = np.frombuffer(b"".join(p for s in pkts for p in s), np.uint8)
        arrays[f"{group}_lengths"] = np.array([[len(p) for p in s] for s in pkts], np.int32)
        arrays[f"{group}_ranges"] = np.array(ranges, np.uint32)
        arrays[f"{group}_layout"] = np.array([channels, streams, coupled, *mapping], np.int32)
        print(f"{group}: {sessions} sessions x {packets} packets, "
              f"{arrays[f'{group}_packets'].size} packet bytes")
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    size = out.stat().st_size
    print(f"wrote {out}: {size} bytes on disk")
    if size >= 150_000:
        raise AssertionError(f"{out} is {size} bytes, over 150 KB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
