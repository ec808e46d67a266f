"""Write tests/data/band_walk_cases.npz: recorded plan slots at every CELT
frame size and the plan executor's output on each, for
tests/test_torch_band_walk.py on a machine without libopus.

    python3 tools/make_band_walk_cases.py [--out PATH]

Streams are encoded by the system libopus (through opus_tpu_torch.oracle)
and decoded into plan slots by the port's plane A:

* celt<lm> for lm 2-3 (10 and 20 ms), 5 streams a step through
  NativeBatchFrontEnd: stereo 64 kbps with a transient (short blocks,
  transform slots, anti-collapse records), stereo 160 kbps (lost in
  steps 2 and 4: an empty plan, then a noise-regime one), decorrelated
  stereo 32 kbps (dual stereo and intensity), mono 48 kbps, and mono
  narrowband 24 kbps at end band 13 (a surround session's LFE);
* celt1 (5 ms), the same streams all coded mono: plane A plans no
  stereo band of 2 bins, and no frame at all at lm 0 (its bands of one
  bin), so those frames never reach the executor;
* mixed<lm> for lm 2-3 (10 and 20 ms), 3 streams a step through
  BatchedOpusDecoder's mixed plan decode: hybrid SWB 32 and 64 kbps
  (start band 17, the e[17] fold offsets and band 18's special folding)
  and narrowband CELT 48 kbps.

For case c the file holds `c_header` [T, B, 2], `c_bands` [T, B, 24],
`c_meta` [T, B, 16] and `c_arena` [T, W] (int32, the executor's inputs,
dsp/plan_tables.py plan_executor_args) and `c_out` [T, B, 2, N] float32,
what `make_plan_executor(lm, B, device="cpu")` returned on them.  The
outputs were written by the executor whose band walk, stereo merge and
anti-collapse ran inline; the tests hold `dsp/band_walk.py` to them bit
for bit.  The script checks that the cases reach every branch of that
code and that the file stays under 1 MB.  No pickled objects: numpy
alone reads it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "tests" / "data" / "band_walk_cases.npz"
STEPS = 5
NB_BW = 1101  # OPUS_BANDWIDTH_NARROWBAND


def signals(n: int) -> dict:
    """Test signals of n samples at 48 kHz: stereo [n, 2] or mono [n, 1]."""
    rng = np.random.default_rng(24)
    t = np.arange(n) / 48000.0
    tone = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 3000 * t)
    hit = tone.copy()
    w = n // 15
    for k in range(0, n - 3 * w, n // 3):  # a transient every third of the run
        hit[k + w : k + 2 * w] += rng.standard_normal(w) * 0.8
    left = 0.4 * np.sin(2 * np.pi * 317 * t) + 0.2 * rng.standard_normal(n)
    right = 0.4 * np.sin(2 * np.pi * 523 * t) + 0.2 * rng.standard_normal(n)
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = 0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(n)
    st = lambda a, b: np.stack([a, b], -1).astype(np.float32)  # noqa: E731
    return {"hit": st(hit, np.roll(hit, 13)), "tone": st(tone, 0.7 * np.roll(tone, 29)),
            "decor": st(left, right), "mono": tone[:, None].astype(np.float32),
            "voice": st(voice, 0.7 * np.roll(voice, 13))}


def encode(pcm, f: int, kbps: int, mode: int, bw: int | None = None) -> list:
    """Whole Opus packets of STEPS frames of f samples."""
    from opus_tpu_torch import oracle

    enc = oracle.Encoder(48000, pcm.shape[1])
    enc.ctl(oracle.SET_FORCE_MODE, mode)
    enc.ctl(oracle.SET_BITRATE, kbps * 1000)
    if bw:
        enc.ctl(oracle.SET_MAX_BANDWIDTH, bw)
    return [enc.encode_float(pcm[i * f : (i + 1) * f].ravel(), f) for i in range(STEPS)]


def celt_case(lm: int) -> list:
    """Each step's executor inputs of the celt<lm> streams."""
    from opus_tpu_torch import oracle, parse_packet
    from opus_tpu_torch.dsp.plan_tables import plan_executor_args
    from opus_tpu_torch.native.frontend import NativeBatchFrontEnd, alloc_plan_slots

    f = 120 << lm
    sig = signals(f * STEPS)
    if lm < 2:
        sig.update({k: sig[k][:, :1] for k in ("hit", "tone", "decor")})
    celt = oracle.MODE_CELT_ONLY
    streams = [encode(sig["hit"], f, 64, celt), encode(sig["tone"], f, 160, celt),
               encode(sig["decor"], f, 32, celt), encode(sig["mono"], f, 48, celt),
               encode(sig["mono"], f, 24, celt, NB_BW)]
    channels = [2 if s[0][0] & 4 else 1 for s in streams]  # the ToC stereo flag
    fe = NativeBatchFrontEnd(len(streams), 2)
    fe.set_end_bands([21, 21, 21, 21, 13])
    slot = alloc_plan_slots(len(streams), 1)[0]
    out = []
    for t in range(STEPS):
        pkts = [s[t][parse_packet(s[t]).payload_offset :] for s in streams]
        if t in (2, 4):
            pkts[1] = None
        fe.decode_batch_plan_into(pkts, f, slot, stream_channels=channels)
        out.append([np.array(a) for a in plan_executor_args(slot)])
    return out


def mixed_case(lm: int) -> list:
    """Each step's executor inputs of the mixed<lm> streams."""
    from opus_tpu_torch import oracle
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.dsp.plan_tables import plan_executor_args

    f = 120 << lm
    sig = signals(f * STEPS)
    streams = [encode(sig["voice"], f, 32, oracle.MODE_HYBRID),
               encode(sig["voice"], f, 64, oracle.MODE_HYBRID),
               encode(sig["tone"], f, 48, oracle.MODE_CELT_ONLY, NB_BW)]
    dec = BatchedOpusDecoder(len(streams), 2, transfer="plan", device="cpu")
    slot = dec._alloc_plan_slots(f, 1)[0][0]
    out = []
    for t in range(STEPS):
        pkts = [s[t] for s in streams]
        if t in (2, 4):
            pkts[t // 2 - 1] = None
        dec._plane_a_plan(pkts, slot)
        out.append([np.array(a) for a in plan_executor_args(slot)])
    return out


def coverage(steps: list) -> dict:
    """How often the recorded steps reach each branch of the band walk."""
    seen = dict.fromkeys(("anti_collapse", "dual", "intensity", "stereo", "inversion",
                          "transform", "hybrid", "end13", "mono", "empty"), 0)
    for header, bands, meta, _arena in steps:
        w0 = bands[:, :16].view(np.uint32)
        counts = header[:, 1].astype(np.int64)
        seen["anti_collapse"] += int((counts >> 18).sum())
        seen["hybrid"] += int((meta[:, 4] == 17).sum())
        seen["end13"] += int((meta[:, 5] == 13).sum())
        seen["mono"] += int((meta[:, 3] == 1).sum())
        seen["empty"] += int(((counts & 0x3FFFF) == 0).sum())
        for i in range(21):
            lo = w0[:, (24 * i) >> 5].astype(np.uint64) >> np.uint64((24 * i) & 31)
            hi = w0[:, min(((24 * i) >> 5) + 1, 15)].astype(np.uint64) << np.uint64(
                32 - ((24 * i) & 31))
            f = ((lo | hi) & np.uint64(0xFFFFFF)).astype(np.int64)
            seen["dual"] += int(((f >> 5) & 1).sum())
            seen["intensity"] += int(((f >> 6) & 1).sum())
            seen["inversion"] += int(((f >> 7) & 1).sum())
            seen["stereo"] += int(((f >> 23) & 1).sum())
            seen["transform"] += int(((f & 31) != 16).sum())
    return seen


def main() -> int:
    import torch

    from opus_tpu_torch.dsp.plan_exec import make_plan_executor

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    cases = {f"celt{lm}": (lm, celt_case(lm)) for lm in (1, 2, 3)}
    cases.update({f"mixed{lm}": (lm, mixed_case(lm)) for lm in (2, 3)})
    arrays = {}
    total = dict.fromkeys(coverage([]), 0)
    for name, (lm, steps) in cases.items():
        ex = make_plan_executor(lm, steps[0][0].shape[0], device="cpu")
        outs = [ex(*[torch.as_tensor(a) for a in s]).numpy() for s in steps]
        for k, key in enumerate(("header", "bands", "meta", "arena")):
            arrays[f"{name}_{key}"] = np.stack([s[k] for s in steps]).astype(np.int32)
        arrays[f"{name}_out"] = np.stack(outs).astype(np.float32)
        seen = coverage(steps)
        print(name, seen)
        total = {k: total[k] + v for k, v in seen.items()}
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise SystemExit(f"no recorded step reaches {missing}")
    np.savez_compressed(args.out, **arrays)
    size = pathlib.Path(args.out).stat().st_size
    print(f"wrote {args.out}: {size} bytes")
    if size > 1 << 20:
        raise SystemExit("the cases file passed 1 MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
