"""End-to-end smoke run of opus_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds plane A (g++: the CELT, SILK and Opus engines) and the CUDA
kernels (nvcc, sm_90a; post-filter, spreading rotation, the two scans
of the loss concealment, the SILK synthesis and the encoder's PVQ
search) from the sources in the
checkout, in parallel,
and holds each kernel to its plain torch version at the serving shapes
(the scans also on ties at pitch_track's lane edges, y contiguous and at
stride 2, and on every chunk geometry of lpc_synth: 1 to 1,081 samples
at 1 to 2,048 rows, poles at radius 0.995 and 0.999, a zero LPC that
must pass ext through exactly).
Then it serves 1024 stereo 48 kHz CELT streams (20 ms frames at 96 kbps,
payloads from the port's native encoder) through three main paths of
BatchedCeltDecoder.  Every serve loop on the card replays each step
variant from a CUDA graph captured at the variant's first step
(opus_tpu_torch/dsp/graphs.py); the launch counts below count the
kernels each replay ran, and the kernels' recorded inputs come from the
eager run that precedes each capture (each path prints the steps they
came from and the graphs it captured):

* p10: transfer="p10", 13 steps, one of them with lost packets: the
  post-filter kernel must launch on every step with an active filter;
* plan: transfer="plan", the same 13 steps without losses: no step may
  fall back to the q14 spectrum, the rotation kernel must launch twice
  per step, the post-filter as on the p10 path.  The inputs of the first
  step's two rotation passes and of its post-filter call (periods and
  tapsets as the strided views of `meta` the serving core passes) are
  recorded, and each kernel is held to its plain version on them too;
* plan-loss: transfer="plan" with packet loss (`with_plan_losses`: 5%
  random on steps 1-12, every third stream on step 6, two bursts).  A
  stream's first lost frames are concealed on the device: every step
  with such losses must run a concealing step variant (at least one
  compact, at least one whole-batch), with 2 pitch_track and 1 lpc_synth
  launches per such step, besides the plan path's gates.  The inputs of
  the first lossy step's scans are recorded and the kernels held to
  their plain versions on them.

Then it serves mixed traffic through BatchedOpusDecoder (stream i of kind
i % 3: the CELT streams' payloads, SILK WB mono at 60 B and hybrid SWB
mono at 160 B from the port's native encoders, each voice stream with its
own pitch) on three more main paths:

* mixed: transfer="plan", silk_transfer="internal" (SILK resampled on
  the device), 13 steps without loss: no step may fall back to the
  packed path, rotation twice and post-filter once per step; the kernels
  are held to their plain versions on the first step's recorded inputs,
  whose rows include the 341 hybrid streams (start band 17);
* mixed-loss: the same with 5% random loss on steps 1-12
  (`with_mixed_losses`): SILK and hybrid losses are concealed in plane A,
  CELT first losses on the device (2 pitch_track + 1 lpc_synth per
  concealing step);
* mixed-p10: transfer="p10" with 48 kHz SILK, mixed-loss's first 6 steps
  (the packed mixed step and its concealing variant);
* mixed-switch: mixed with every stream i of i % 16 == 15 (64 streams)
  replaced by sequence (i // 16) % 24 of tests/data/switch_traffic.npz
  (read with numpy alone): stereo CELT -> SILK -> hybrid -> CELT mode
  switches and SILK bandwidth switches, whose redundant CELT blocks the
  loop decodes on the host (the shadow decode) and crossfades into the
  ring.  Every step from 1 on must carry a redundant block and both kinds
  must occur; each step's blocks, kinds and shadow decodes are printed;
* mixed-switch-p10: the same on transfer="p10" with 48 kHz SILK.

Streams 0-5 (two of each kind) of each mixed path, and four switching
streams (15, 31, 47, 63) on the switch paths, are checked against the
port's CPU run of their columns as streams 0-3 of the CELT paths are
(below), with the 1e-3 gate from a CELT stream's first loss on; the mixed
serve rates (mixed, mixed-loss, mixed-switch), the shadow decode's host
ms a redundant block and a step, the ToC parse and plane A times, the
upload words (internal and 48 kHz SILK) and the mixed device step (CUDA
events, kernels per step under the profiler) are printed.

graphs: each step variant of the serve loops at B=1024 (p10, plan, plan-loss's
compact and whole-batch concealing steps, mixed and mixed-loss) replayed
from its CUDA graph must equal the factory's eager step from copies of
the same state, slot and ring bit for bit (ring, decode memory,
pre-emphasis, SILK history, the conceal's LPC and pitch, digest), and a
replayed step must show one cudaGraphLaunch and no kernel launch under
the profiler.  Prints the graphs captured, the capture ms, plane A's ms,
the host ms of a replayed step call, the device ms of a replayed and an
eager step (CUDA events), and torch.cuda.max_memory_allocated.

run_pipelined: both decoders at B=1024 for 3 steps (BatchedCeltDecoder on
the CELT payloads, BatchedOpusDecoder on the mixed traffic, p10 with 48
kHz SILK), with their launch counts; streams 0-5 of the last step against
the port's CPU run; the host ms a step.

The SILK-only batch decoder (BatchedSilkDecoder.decode_frames): its
kernel silk_synth (csrc/silk.cu, the LTP and LPC recurrences of a frame
in one launch; the LPC a chunked recurrence that rounds otherwise than
the sequential plain version) is first held to a float64 run of its
plain version (within 1e-5 of each row's peak) and to the float32 plain
version (within 1 int16 LSB beyond the plain version's own distance from
the float64 run, row by row) on synthetic rows at 8, 12 and 16 kHz
(voiced and unvoiced, lags at chunk + 2 and 18 fs_khz, LPC pole pairs at
radius 0.995 and 0.999), then:

* silk-only: 1024 mono SILK WB streams (16 kHz internal), 8 steps of 20 ms
  at 60 B from the port's native SILK encoder (the mixed traffic's voice):
  one silk_synth launch a step, voiced rows on every step after the
  first; streams 0-31 against the port's CPU run of their payloads and a
  float64 run of it (each run rounds its output and feeds it back, so a
  flipped rounding carries on): the card's drift from the float64 run
  within 1.5 times the CPU run's, plus 1 LSB (max) and 0.05 LSB (RMS);
  the kernel is held to the float64 run and within 0.05 LSB of its plain
  version on the recorded inputs of the first voiced step; prints the
  rate, the host front end's and the device's ms a step, and the
  kernel's time as one replay of a CUDA graph;
* silk-only-nb: 64 NB streams (8 kHz, order 10, chunk 10), 4 steps,
  checked as silk-only, not timed.

Multistream sessions (BatchedMultistreamDecoder) from the committed
libopus traffic, tests/data/multistream_traffic.npz (session i replays
fixture session i % its count): every session's final range must equal
libopus's after every packet.

* multistream and multistream-p10: 256 sessions of the 8-channel layout
  (5 streams, 3 coupled: 1280 elementary streams), CELT at 256 kbps, on
  the plan and p10 transfers: the launch gates of the CELT paths, no plan
  fallback, sessions 0-3 against the port's CPU run; timed as the
  reference benchmark's multistream row (steps x sessions x 0.02 / s);
* multistream-opus: 64 family-1 SILK sessions (3 channels, 2 streams) on
  the mixed-mode core; multistream-40ms: 64 sessions of 40 ms code-3 CELT
  packets (4 channels, 3 streams), two serving steps a packet; checked,
  not timed.

multichip: the plan, mixed and multistream paths split over a world of
torch.cuda.device_count() NCCL ranks, one process a card (rank r on
cuda:r; opus_tpu_torch.mesh.run_ranks, spawned; a failed rank, a failed
NCCL start or the deadline fails the run, with no fallback to gloo or the
CPU): each rank serves its contiguous block of the batch through the
ordinary decoders at B/world streams, with its own plane A, and the
whole batch's view is gathered by batch/sharded.py:

* multichip-plan: BatchedCeltDecoder, transfer="plan", the 13 clean steps
  at B=1024;
* multichip-mixed: BatchedOpusDecoder, plan and internal SILK, the 13
  mixed steps;
* multichip-multistream: BatchedMultistreamDecoder, the 256 8-channel
  sessions of the multistream path, whole sessions a rank, un-mapped on
  their rank and gathered (gather_sessions).

Each rank's launch counts (set to 0 just before its path, read just
after) must show the post-filter on every step with an active filter and
2 rotations a plan step, and nothing else; the gathered ring must be
within 1e-5 of the unsharded path's ring of this run, every final range
equal and no rank's plan fallen back.  Prints each path's sharded rate
(3 runs, each timed on every rank and read at the slowest), the world
size, each rank's plane-A ms a step and its gather ms.  Then the port's
dryrun_multichip(world, device="cuda") runs its three
phases (synthetic CELT + SILK + regroup, the real bitstream, the mixed
plan serve) on the card.

grid: the reference's dp x tp layout (a stream's channels over two ranks,
opus_tpu_torch.mesh.GridSpec) as ranks sharing cuda:0 under gloo, asked
for by run_ranks' ranks_per_card (NCCL refuses two ranks on one card):

* grid-1x2 and grid-2x2: dryrun_multichip(2 and 4, device="cuda",
  ranks_per_card=2 and 4), every gate of its three phases (the channel
  interleave over tp and the regroup over dp exact, within 1e-5 of the
  unsharded steps, the tp replicas of the SILK rows and served rings equal
  bit for bit, final ranges equal, CELT tails within 2e-3 of the scalar
  decoder), the post-filter and rotation launched on every rank;
* tp-full: the CELT synthesis step at the main path's shape (B=1024
  stereo, lm=3, long blocks, post-filter active, a random decode history),
  split 1 x 2 over two ranks, a channels=1 step a channel, 2 frames,
  gathered over tp: within 1e-5 of the unsharded stereo step, the
  gathered frames equal on both ranks, the post-filter launched once a
  frame on each rank and no other kernel.

Prints each rank's launch counts, its step's device ms (CUDA events; on
tp-full each rank alone, in turns, beside the unsharded step's), the
gathers' ms and the backend.

The encode plane (BatchedPlanEncoder): its kernel pvq_search (csrc/pvq.cu,
the greedy PVQ search of every used leaf, on a tile of 8, 16 or 32 lanes
by its width, its pulses packed int16 in plan order) must equal its plain
version exactly, iy and left, on synthetic leaves (`pvq_inputs`: n = 1, 2,
3, 176 and every width-class edge, K below and above n / 2, zero, tiny and
large sums, ties, K = 200, mid/side and intensity bands, clamped planes
and offsets; stereo and mono; `pvq_one_class`: a batch of each class
alone), then:

* encode: B=1024 stereo at 96 kbps (240-byte packets), 4 steps of
  seeded music-like PCM (`music_pcm`; the last stream silent), the first a
  warm-up: one pvq_search launch a step; every step's packets served (ToC
  stripped) by BatchedCeltDecoder(transfer="plan"), whose 1024 final ranges
  must equal the encoder's; streams 0-3 decoded by the port's scalar
  CeltDecoder (equal final ranges) and within 0.5 dB SNR of the port's CPU
  run at B=4; the kernel held to its plain version on all 1024 x 160 rows
  of the first step's recorded inputs.  Prints the encode rate end to end,
  the host ms a step (plan, emit, fallback), the device plane (analyze +
  search on resident inputs, CUDA events), the packed iy download and its
  bytes, and the kernel's times (wrapper, bare with its inputs in the L2
  as the encode step leaves them and with the L2 flushed first, CUDA-graph
  replay, plain) with its bound on the bytes the work needs.

library: the codec library (the port's scalar Decoder, MultistreamDecoder,
Encoder, Ogg Opus and the CLI) on the card's host, after the multistream
paths.  The plan, plan-loss, mixed and mixed-loss runs above also keep 31
streams of the B=1024 batch (LIBRARY_ROWS: rows 0-3 and every 37th from
37, with the rows 0-3 they keep anyway, one gather of the ring a step) and
every step's final ranges; the multistream run keeps 8 sessions.  The
same packets (the CELT payloads behind the CELT-only FB 20 ms stereo ToC)
are decoded again by the port's Decoder at 48 kHz stereo, or its
MultistreamDecoder, and on plan, mixed and multistream every sampled
stream must have the scalar decoder's final range after every packet,
PCM within 1e-3 (the reference's batched-vs-scalar gate,
tests/test_mixed_plan.py:56) and an RFC 8251 score (conformance.compare)
of at least 90 over its frames; on the loss paths the same numbers are
printed, not gated.  Meanwhile two threads run `python3 -m opus_tpu_torch`
encode, info and decode on a 4 s stereo music WAV (128 kbps VBR) and a 4
s mono 16 kHz speech WAV (voice, 24 kbps): every command exits 0, the Ogg
file reads back (each page's CRC) with the head written and the count
`info` printed, an in-process Encoder of the same session writes the same
packets on a native encoder and the port's Decoder reads each to the
encoder's final range and to the decoded WAV's samples (the input's whole
frames), and the music SNR after the 120-sample delay is above 15 dB
(tests/test_encoder.py:63-80's floor at 128 kbps; the speech SNR is
printed).  Then every Encoder session kind (music mono and stereo, voice
mono and stereo, hybrid, FEC) must run on a native encoder with every
final range equal to the Decoder's.  Prints the scalar decode ms a frame
by kind, the encode ms a frame by kind, the CLI's walls, each path's worst
error and lowest score; the phase launches no kernel.

Every phase's wall time and the total are printed.

Each kernel is timed three ways, on the synthetic inputs and on the
recorded ones: the wrapper's whole call, the bare library call on C
arguments converted in advance (the kernel alone), and the plain
version.  Streams 0-3 of each card run are checked against the port's
own CPU run of the same packets at B=4 (streams decode independently):
equal final ranges, PCM within 1e-4 (1e-3 once a stream has lost a frame
on plan-loss, and equal carried pitch).  Prints the card's name and power
limit, those times with each kernel's bound, the serve rates end to end,
the device step times, a JSON line describing each kernel, and as its
last line {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

B, C, FRAME, NBYTES = 1024, 2, 960, 240  # 240 B per 20 ms = 96 kbps
STEPS = 13
LOST_STEP = 6
W = 2048  # post-filter row: DECODE_BUFFER_SIZE samples of history + frame
PF_CASES = [(3, 12), (3, 60), (3, 120), (3, 240), (2, 60), (1, 12), (0, 12), (0, 240)]
PF_REL_TOL = 1e-6  # the reference's own gate (tests/test_pallas_pf.py)
ROT_ABS_TOL = 2e-6  # the reference's scalar gate (tests/test_pallas_rot.py)
ROT_LENGTHS = [1, 1, 2, 3, 5, 8, 21, 44, 87, 176]
CPU_PCM_TOL = 1e-4  # card run vs the port's CPU run, streams 0-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# pitch_track is bound by its dependent chain: cycles of arithmetic
# latency (4 cycles for a float add, multiply-add or max) at the H100
# SXM's top boost clock.  lpc_synth's chunked form is not bound by the
# sequential walk's chain (kept in its bound_note).
CLOCK_HZ = 1.98e9
SYNTH_ELS = [1, 23, 24, 25, 33, 300, 1080, 1081]  # lpc_synth chunk geometries
SYNTH_ROWS = [1, 31, 256, 2048]
# (length, n_lags): lengths not a multiple of 32; 155 and 310 the coarse
# and fine searches' lags
PITCH_GEOMETRY = [(45, 1), (77, 31), (332, 155), (664, 310)]
PLAN_LOSS_P, PLAN_LOSS_SEED = 0.05, 7
PLC_PCM_TOL = 1e-3  # card vs CPU once a stream has lost a frame (tests/test_torch_plc.py)
MIXED_P10_STEPS = 6  # mixed-p10 serves the first 6 steps, to keep within the time limit
MIXED_CPU_STREAMS = 6  # streams 0-5 (two of each kind) are held to the CPU run
SILK_BYTES, HYBRID_BYTES = 60, 160  # SILK WB at 24 kbps, hybrid SWB at 64 kbps
# ToC bytes: CELT FB 20 ms stereo (config 31), SILK WB 20 ms (9), hybrid SWB 20 ms (13)
TOC_CELT, TOC_SILK, TOC_HYBRID = bytes([31 << 3 | 4]), bytes([9 << 3]), bytes([13 << 3])
LPC_PEAK_TOL = 1e-3  # lpc_synth (kernel and f32 plain) vs float64, of each row's peak
# The switching traffic (tools/make_switch_traffic.py): stream i with
# i % SWITCH_EVERY == 15 carries fixture sequence (i // SWITCH_EVERY) % 24.
ROOT = pathlib.Path(__file__).resolve().parent
SWITCH_FIXTURE = ROOT / "tests" / "data" / "switch_traffic.npz"
SWITCH_EVERY = 16
SWITCH_CPU_STREAMS = [0, 1, 2, 3, 4, 5, 15, 31, 47, 63]  # held to the CPU run
PIPELINED_STEPS = 3
# SILK-only: B mono SILK WB streams (16 kHz internal), 20 ms frames at 60 B
# (24 kbps) from the port's native encoder; an NB run (8 kHz, order 10,
# chunk 10) at SILK_NB_B streams is checked, not timed.
SILK_STEPS, SILK_NB_B, SILK_NB_STEPS = 8, 64, 4
SILK_RATES = [(8, 10, 10), (12, 20, 10), (16, 20, 16)]  # fs_khz, chunk, LPC order
# silk_synth's chunked LPC rounds otherwise than its sequential plain version
# (tests/test_torch_silk.py sizes these on the CPU with a model of it):
SILK_F64_TOL = 1e-5  # silk_synth vs the float64 plain version, of each row's peak
# silk_synth vs the float32 plain version, int16 LSBs: on synthetic rows beyond
# the plain version's own distance from the float64 run, row by row (it reaches
# 1 LSB itself near peaks of 100k); on the recorded silk-only step, absolute
SILK_PLAIN_TOL, SILK_REAL_TOL = 1.0, 0.05
# The silk-only paths: the decoder rounds its output and feeds it back as the
# LTP history, so a rounding that flips carries on, and on this traffic even
# the port's float32 CPU run drifts from a float64 run of the same decoder by
# up to about 6 LSB in 8 frames.  Streams 0-31 of the card run are held to
# the float64 run: max abs and RMS within SILK_DRIFT_FACTOR times the CPU
# run's own, plus one flipped rounding (1 LSB) and 0.05 LSB RMS.
SILK_PATH_STREAMS, SILK_DRIFT_FACTOR, SILK_DRIFT_FLOOR = 32, 1.5, (1.0, 0.05)
# Multistream: the committed libopus sessions (tools/make_multistream_traffic.py);
# session i of the batch replays fixture session i % (sessions in the group).
MS_FIXTURE = ROOT / "tests" / "data" / "multistream_traffic.npz"
MS_SESSIONS, MS_CHECKED_SESSIONS = 256, 64
# The encode plane: BatchedPlanEncoder at B stereo 96 kbps (240-byte packets),
# ENC_STEPS steps of music_pcm, the first a warm-up; streams 0-3 against the
# port's CPU run.  The leaf table's shape is the encoder's (P_MAX, N_MAX,
# T_MAX).  A trip of pvq_search's greedy loop is at least an add, a square, a
# division and the argmax's log2(176) = 8 compare levels, each 4 cycles of
# dependent latency: PVQ_TRIP_CYCLES, for the chain bound.
ENC_STEPS, ENC_CPU_STREAMS, ENC_SNR_TOL_DB = 4, 4, 0.5
ENC_P_MAX, ENC_N_MAX, ENC_T_MAX = 160, 176, 128
PVQ_TRIP_CYCLES = 4 * (3 + 8 + 1)
# The recorded kernel time of the padded pvq_search that the packed one
# replaced, on the same encode step 0 (PERF.md section 6: NVIDIA H100 80GB
# HBM3, 700 W; not measured by this script), printed beside the packed
# layout's bound.  L2_FLUSH_BYTES: the buffer written before a launch timed
# with its inputs out of the 50 MB L2.
PVQ_PADDED_RECORDED_MS = 0.1702
L2_FLUSH_BYTES = 256 << 20
# The multichip phase: the plan, mixed and multistream paths split over
# torch.cuda.device_count() NCCL ranks; the gathered ring within the
# reference's sharded allowance (tests/test_mesh_serve.py:81,190) of the
# unsharded ring; MULTICHIP_RUNS timed runs a path.
MULTICHIP_TOL, MULTICHIP_RUNS, MULTICHIP_DEADLINE_S = 1e-5, 3, 300
# The grid phase: the dry run's dp x tp layout as ranks sharing cuda:0 under
# gloo (GRID_WORLDS: dp x tp = 1 x 2 and 2 x 2), and the full-width tp case,
# the CELT synthesis step at the main path's shape (B stereo, lm=3, long
# blocks, post-filter active) over 2 ranks, each a channel, TP_FRAMES frames
# from a random decode history (seed TP_SEED), within MULTICHIP_TOL of the
# unsharded step; each rank's step timed alone over TP_REPS launches.
GRID_WORLDS, TP_FRAMES, TP_REPS, TP_SEED = (2, 4), 2, 50, 5
# The library phase: a sample of the B=1024 batch, rows 0-3 and every 37th
# row from 37 (31 streams: both ends of the batch and, 37 being prime to 3,
# every kind of the mixed batch), and the first LIBRARY_SESSIONS of those
# rows as multistream sessions, decoded again by the port's scalar decoders:
# equal final ranges, PCM max-abs below LIBRARY_TOL (the reference's
# batched-vs-scalar gate, tests/test_mixed_plan.py:56) and an RFC 8251
# score of at least PASS_QUALITY over each stream's frames.
LIBRARY_ROWS = [0, 1, 2, 3, *range(37, B, 37)]
LIBRARY_TOL, LIBRARY_SESSIONS = 1e-3, 8
# The CLI round trip: CLI_SECONDS of each input through `python3 -m
# opus_tpu_torch`; the music SNR floor is tests/test_encoder.py:63-80's at
# 128 kbps stereo, measured after the codec's CLI_DELAY samples.
CLI_CASES = {  # case -> (WAV rate, channels, encode options)
    "music": (48000, 2, ["--bitrate", "128000", "--vbr"]),
    "speech": (16000, 1, ["--application", "voice", "--bitrate", "24000"]),
}
CLI_SECONDS, CLI_SNR_DB, CLI_DELAY = 4, 15.0, 120
# Every Encoder session kind, 1 s of 48 kHz music-like input each: kind,
# application, channels, bitrate, options.
ENCODE_KINDS = [("music mono", "music", 1, 64000, {}),
                ("music stereo", "music", 2, 128000, {"vbr": True}),
                ("voice mono", "voice", 1, 24000, {}),
                ("voice stereo", "voice", 2, 32000, {}),
                ("hybrid mono", "hybrid", 1, 32000, {}),
                ("voice mono fec", "voice", 1, 24000, {"fec": True})]


def card() -> str:
    """`name, power limit` of GPU 0 as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def best_ms(fn, reps: int, windows: int = 3) -> float:
    """The smallest of `windows` cuda_ms readings: a kernel's time, with
    any window in which the host stalled the issue left out."""
    return min(cuda_ms(fn, reps) for _ in range(windows))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate or operations
    over the float32 peak, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def chain_bound_ms(nbytes: float, cycles: float) -> tuple[float, str]:
    """Least time of a scan: its bytes over the HBM rate or its dependent
    chain of `cycles` at CLOCK_HZ (operations), whichever is larger."""
    tb, tc = nbytes / HBM_BYTES_PER_S * 1e3, cycles / CLOCK_HZ * 1e3
    return (tb, "bytes") if tb >= tc else (tc, "operations")


def build() -> None:
    """Plane A (g++) and the CUDA kernels (nvcc) at once, from the checkout."""
    from opus_tpu_torch import _build
    from opus_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    done, errors = {}, []

    def plane_a():
        try:
            native_build.build()
            done["plane A"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001  (re-raised below)
            errors.append(e)

    th = threading.Thread(target=plane_a)
    th.start()
    try:
        so = _build.build()
        done["CUDA kernels"] = time.perf_counter() - t0
    finally:
        th.join()
    if errors:
        raise errors[0]
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in done.items()))
    print(so.with_suffix(".log").read_text().strip())


def cycled(make, copies: int):
    """fn() calling make(inputs) on `copies` copies in turn, so that each
    call finds its inputs outside the 50 MB L2, as the serving step does."""
    turn = iter(range(10**9))
    return lambda: make(copies[next(turn) % len(copies)])


def postfilter_inputs(lm, chunk, seed, dev):
    """Serving-shape post-filter inputs: rows 0-7 zero-gain with garbage
    lags, rows 8-15 with filter 1 equal to filter 0."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, C, W)).astype(np.float32) * 1000.0
    periods = rng.integers(max(15, chunk + 2), 1025, (B, 3)).astype(np.int32)
    gains = (rng.integers(0, 5, (B, 3)) * 0.09375).astype(np.float32)
    gains[:8] = 0.0
    periods[:8] = rng.integers(-5, 5000, (8, 3))
    periods[8:16, 1] = periods[8:16, 0]
    gains[8:16, 1] = gains[8:16, 0]
    tapsets = rng.integers(0, 3, (B, 3)).astype(np.int32)
    return [torch.tensor(a, device=dev) for a in (y, periods, gains, tapsets)]


def pf_bytes(periods, gains, n: int, lm: int) -> tuple[int, int]:
    """Bytes the post-filter must move for these inputs: (what the data
    needs, whole rows).  A row reads its frame and the lagged history its
    longest active lag reaches (lag + 2 back) and writes its frame; a row
    whose filters all have zero gain moves nothing.  Whole rows: every
    row of W read and its frame written, as a kernel that ignores the
    gains would."""
    nf = 2 if lm == 0 else 3
    p = np.clip(periods[:, :nf].cpu().numpy().astype(np.int64), 15, 1024)
    g = gains[:, :nf].cpu().numpy()
    longest = np.where(g != 0, p, 0).max(axis=1)
    live = (g != 0).any(axis=1)
    meta = periods.shape[0] * 9 * 4
    needed = int(np.where(live, 2 * n + longest + 2, 0).sum()) * C * 4 + meta
    whole = B * C * (W + n) * 4 + meta
    return needed, whole


def pf_row_chunks(periods, gains, lm: int) -> np.ndarray:
    """Each stream's largest safe chunk: its shortest active lag - 2
    (0 for a stream with no active filter)."""
    nf = 2 if lm == 0 else 3
    p = np.clip(periods[:, :nf].cpu().numpy().astype(np.int64), 15, 1024)
    g = gains[:, :nf].cpu().numpy()
    return np.where((g != 0).any(axis=1), np.where(g != 0, p, 10**6).min(axis=1) - 2, 0)


def bare(entry: str, prepared: list):
    """fn() calling the library's `entry` on C arguments converted in
    advance, cycling through `prepared`: the kernel alone, without the
    wrapper's checks and conversions (the return code is checked once)."""
    from opus_tpu_torch import _build

    fn = getattr(_build.library(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    if fn(*prepared[0], stream) != 0:
        raise RuntimeError(f"{entry} launch failed")
    return cycled(lambda args: fn(*args, stream), prepared)


def graph_ms(fn, prepared: list, n: int = 40) -> float:
    """Device ms a launch with no host issue between launches: the best of
    5 replays of a CUDA graph of n launches of the C entry fn, cycling
    through `prepared` as `bare` does."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        if fn(*prepared[0], stream.cuda_stream) != 0:
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for i in range(n):
                fn(*prepared[i % len(prepared)], torch.cuda.current_stream().cuda_stream)
    return replay_ms(graph) / n


def replay_ms(graph) -> float:
    """Device ms of a CUDA graph's replay: the best of 5, after one."""
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def l2_flushed_ms(fn, prepared: list, n: int = 10) -> float:
    """Device ms a launch of the C entry fn whose inputs come from HBM: a
    CUDA graph of n (write L2_FLUSH_BYTES, launch) pairs less one of the n
    writes alone (replay_ms each); launches cycle through `prepared` as
    `bare` does."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    stream = torch.cuda.Stream()
    graphs = []
    with torch.cuda.stream(stream):
        if fn(*prepared[0], stream.cuda_stream) != 0:
            raise RuntimeError("launch failed")
        flush.zero_()
        torch.cuda.synchronize()
        for with_launch in (True, False):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                for i in range(n):
                    flush.zero_()
                    if with_launch:
                        fn(*prepared[i % len(prepared)], torch.cuda.current_stream().cuda_stream)
            graphs.append(graph)
    return (replay_ms(graphs[0]) - replay_ms(graphs[1])) / n


def postfilter_times(y, hist, n, lm, periods, gains, tapsets, chunk) -> dict:
    """ms of the wrapper's whole call, of the bare kernel launch on
    arguments prepared in advance, and of the plain version; four copies
    of y (67 MB) cycle beyond the 50 MB L2."""
    from opus_tpu_torch.dsp import postfilter as pf

    ys = [y.clone() for _ in range(4)]
    prepared = [pf._kernel_args(yy, hist, n, lm, periods, gains, tapsets) for yy in ys]

    def run(fn):
        return cycled(lambda yy: fn(yy, hist, n, lm, periods, gains, tapsets, chunk), ys)

    return {"ms": best_ms(run(pf.postfilter), 40),
            "kernel_ms": best_ms(bare("opus_postfilter", prepared), 40),
            "plain_ms": cuda_ms(run(pf._postfilter_ref), 5)}


def postfilter_phase(dev, where: str) -> dict:
    """Post-filter kernel vs _postfilter_ref on the card, every case."""
    from opus_tpu_torch.dsp.postfilter import _postfilter_ref, postfilter

    max_abs = max_rel = 0.0
    times = {}
    for lm, chunk in PF_CASES:
        n = 120 << lm
        y, periods, gains, tapsets = postfilter_inputs(lm, chunk, 100 * lm + chunk, dev)
        ref = _postfilter_ref(y.clone(), W - n, n, lm, periods, gains, tapsets, chunk)
        got = postfilter(y.clone(), W - n, n, lm, periods, gains, tapsets, chunk)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"post-filter output not finite at lm={lm} chunk={chunk}")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        print(f"kernel postfilter lm={lm} chunk={chunk}: max_abs_err={err} max_rel_err={rel}")
        if not rel < PF_REL_TOL:
            raise AssertionError(f"post-filter kernel disagrees with plain version: rel {rel} "
                                 f"at lm={lm} chunk={chunk}")
        max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
        if lm == 3:
            t = postfilter_times(y, W - n, n, lm, periods, gains, tapsets, chunk)
            t["bytes"] = pf_bytes(periods, gains, n, lm)
            times[chunk] = t
            print(f"time postfilter B={B} C={C} lm=3 chunk={chunk}: wrapper_ms={t['ms']} "
                  f"kernel_alone_ms={t['kernel_ms']} plain_ms={t['plain_ms']} "
                  f"bytes_needed={t['bytes'][0]} bytes_whole_rows={t['bytes'][1]} ({where})")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "times": times}


def rotation_inputs(seed: int, n2: int, dev):
    """x ~ N(0,1) [B, n2] with random chain geometry: chain lengths from
    ROT_LENGTHS, one chain in five with identity coefficients."""
    rng = np.random.default_rng(seed)
    k_pos = np.zeros((B, n2), np.int32)
    m_pos = np.ones((B, n2), np.int32)
    cc = np.ones((B, n2), np.float32)
    ss = np.zeros((B, n2), np.float32)
    for r in range(B):
        t = 0
        while t < n2:
            m = min(int(rng.choice(ROT_LENGTHS)), n2 - t)
            th = 0.5 * rng.uniform(0.1, 1.0) ** 2
            k_pos[r, t : t + m] = np.arange(m)
            m_pos[r, t : t + m] = m
            if rng.random() < 0.8:
                cc[r, t : t + m] = np.cos(0.5 * np.pi * th)
                ss[r, t : t + m] = np.cos(0.5 * np.pi * (1.0 - th))
            t += m
    x = rng.standard_normal((B, n2)).astype(np.float32)
    return [torch.tensor(a, device=dev) for a in (x, cc, ss, k_pos, m_pos)]


def rotation_times(args) -> dict:
    """ms of the wrapper's whole call, of the bare kernel launch into an
    output allocated in advance, and of the plain version; three copies
    of the five planes and the output (141 MB) cycle beyond the L2."""
    from opus_tpu_torch.dsp import rotation as rot

    sets = [[a.clone() for a in args] + [torch.empty_like(args[0])] for _ in range(3)]
    prepared = [rot._kernel_args(*a) for a in sets]
    return {"ms": best_ms(cycled(lambda a: rot.rot_pass(*a[:5]), sets), 40),
            "kernel_ms": best_ms(bare("opus_rot_pass", prepared), 40),
            "plain_ms": cuda_ms(cycled(lambda a: rot._rot_pass_ref(*a[:5]), sets), 5)}


def rotation_phase(dev, where: str) -> dict:
    """Rotation kernel vs _rot_pass_ref on the card, at the lm=3 and lm=2
    planes; times at lm=3."""
    from opus_tpu_torch.dsp.rotation import _rot_pass_ref, rot_pass

    max_abs = 0.0
    times = None
    for lm in (3, 2):
        n2 = 2 * (120 << lm)
        args = rotation_inputs(30 + lm, n2, dev)
        ref = _rot_pass_ref(*args)
        got = rot_pass(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rotation output not finite at n2={n2}")
        err = float((got - ref).abs().max())
        print(f"kernel rotation B={B} n2={n2}: max_abs_err={err}")
        if not err < ROT_ABS_TOL:
            raise AssertionError(f"rotation kernel disagrees with plain version: {err} at n2={n2}")
        max_abs = max(max_abs, err)
        if lm == 3:
            times = rotation_times(args)
            print(f"time rotation B={B} n2={n2} random chains: wrapper_ms={times['ms']} "
                  f"kernel_alone_ms={times['kernel_ms']} plain_ms={times['plain_ms']} ({where})")
    return {"max_abs_err": max_abs, "times": times}


def pitch_inputs(seed: int, rows: int, length: int, n_lags: int, dev):
    """Serving-shape pitch_track inputs: xcorr [rows, n_lags], y [rows,
    length + n_lags] ~ N(0, 3e4).  Rows 0-5 have y = 0 (syy stays 1, so
    equal correlations tie exactly): three equal maxima, every lag equal,
    nothing positive, the best at lag 0, the best at the last lag, two
    equal maxima at both ends."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, length + n_lags)) * 3e4).astype(np.float32)
    xc = (rng.standard_normal((rows, n_lags)) * 1e12).astype(np.float32)
    y[:6] = 0.0
    xc[:6] = -1.0
    xc[0, [3, n_lags // 2, n_lags - 2]] = 7e12
    xc[1] = 4e12
    xc[3, 0] = 9e12
    xc[4, n_lags - 1] = 9e12
    xc[5, [0, n_lags - 1]] = 2e12
    return [torch.tensor(a, device=dev) for a in (xc, y)]


def pitch_edge_inputs(seed: int, rows: int, length: int, n_lags: int, dev):
    """pitch_track inputs with ties at the kernel's lane edges (as
    tests/test_torch_plc.py makes them): rows 0-4 have y = 0 (syy stays
    1): ties at lags 31/32, at 63/64, at all four, every lag equal, lags
    31/32 a float apart; row 5's energy falls to the clamp at 1; row 6
    has its best at lag 32; the rest are random."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, length + n_lags)) * 3e4).astype(np.float32)
    xc = (rng.standard_normal((rows, n_lags)) * 1e12).astype(np.float32)
    y[:5] = 0.0
    xc[:5] = -1.0
    for r, lags, v in ((0, [31, 32], 5e12), (1, [63, 64], 5e12), (2, [31, 32, 63, 64], 7e12),
                       (4, [31], 6e12),
                       (4, [32], np.nextafter(np.float32(6e12), np.float32(np.inf))),
                       (6, [32], 9e13)):
        xc[r, [i for i in lags if i < n_lags]] = v
    xc[3] = 4e12
    y[5, length:] = 0.0
    xc[5] = np.abs(xc[5])
    return [torch.tensor(a, device=dev) for a in (xc, y)]


def synth_inputs(seed: int, rows: int, el: int, dev):
    """lpc_synth inputs: ext ~ N(0, 1) [rows, el], a small random LPC and
    history, with the special rows first (as many as fit): a pole pair at
    radius 0.995 (near instability), one at 0.999, a zero LPC (out must
    equal ext exactly: check_synth), a history of 1e3 with zero ext."""
    rng = np.random.default_rng(seed)
    lpc = (rng.standard_normal((rows, 24)) * 0.03).astype(np.float32)
    ext = rng.standard_normal((rows, el)).astype(np.float32)
    hist0 = rng.standard_normal((rows, 24)).astype(np.float32)
    lpc[:3] = 0.0  # rows 0-1 get a pole pair, row 2 stays a zero LPC
    for r, radius in enumerate([0.995, 0.999][:rows]):
        lpc[r, :2] = [-2 * radius * np.cos(0.2), radius ** 2]
    if rows > 3:
        ext[3] = 0.0
        hist0[3] *= 1e3
    return [torch.tensor(a, device=dev) for a in (ext, lpc, hist0)]


def check_pitch(xc, y, length: int, n_lags: int, label: str) -> None:
    """pitch_track vs _pitch_track_ref: equal indices."""
    from opus_tpu_torch.dsp.plc_scan import _pitch_track_ref, pitch_track

    got = pitch_track(xc, y, length, n_lags)
    want = _pitch_track_ref(xc, y, length, n_lags)
    torch.cuda.synchronize()
    diff = [int((a != b).sum()) for a, b in zip(got, want)]
    print(f"kernel pitch_track {label} rows={xc.shape[0]} length={length} n_lags={n_lags}: "
          f"indices differing from the plain version {diff}")
    if any(diff):
        raise AssertionError(f"pitch_track kernel disagrees with plain version ({label})")


def check_synth(ext, lpc, hist0, label: str) -> float:
    """lpc_synth and the f32 plain version vs the float64 plain version:
    each within LPC_PEAK_TOL of every row's peak.  Returns the kernel's
    max abs error against the float64 run."""
    from opus_tpu_torch.dsp.plc_scan import _lpc_synth_ref, lpc_synth

    want = _lpc_synth_ref(ext.double(), lpc.double(), hist0.double())
    got = lpc_synth(ext, lpc, hist0)
    plain = _lpc_synth_ref(ext, lpc, hist0)
    torch.cuda.synchronize()
    peak = want.abs().amax(dim=1).clamp_min(1e-30)
    rel_k = float(((got.double() - want).abs().amax(dim=1) / peak).max())
    rel_p = float(((plain.double() - want).abs().amax(dim=1) / peak).max())
    err = float((got.double() - want).abs().max())
    zero_lpc = (lpc == 0).all(dim=1)
    passed = bool(torch.equal(got[zero_lpc], ext[zero_lpc]))
    print(f"kernel lpc_synth {label} rows={ext.shape[0]} el={ext.shape[1]}: vs float64 "
          f"max_abs_err={err} max_err_of_row_peak={rel_k}; f32 plain max_err_of_row_peak={rel_p}; "
          f"{int(zero_lpc.sum())} zero-LPC rows equal to ext: {passed}")
    if not (bool(torch.isfinite(got).all()) and rel_k < LPC_PEAK_TOL and rel_p < LPC_PEAK_TOL
            and passed):
        raise AssertionError(f"lpc_synth off the float64 run ({label}): kernel {rel_k}, "
                             f"plain {rel_p}, zero-LPC rows passed through: {passed}")
    return err


def pitch_times(xc, y, length: int, n_lags: int) -> dict:
    """ms of the wrapper, the bare kernel launch and the plain version,
    with the bound: bytes (xcorr and y[:length + n_lags] read, two index
    rows written) or the chain that stays serial: the initial energy as
    32 lane sums in order and a 5-level tree (4 cycles an add), then 8
    cycles a lag (an add and a max on the running energy).  The sequential
    sum's chain (4 cycles a sample, then 8 a lag) is kept as chain_ms_serial_sum."""
    from opus_tpu_torch.dsp import plc_scan

    R = xc.shape[0]
    sets = [[xc.clone(), same_layout(y), torch.empty(R, dtype=torch.int32, device=xc.device),
             torch.empty(R, dtype=torch.int32, device=xc.device)] for _ in range(3)]
    prepared = [plc_scan._pitch_kernel_args(a[0], a[1], length, n_lags, a[2], a[3])
                for a in sets]
    nbytes = R * (n_lags + length + n_lags + 2) * 4
    bound, by = chain_bound_ms(nbytes, 4 * (-(-length // 32) + 5) + 8 * n_lags)
    return {"ms": best_ms(cycled(lambda a: plc_scan.pitch_track(a[0], a[1], length, n_lags),
                                 sets), 40),
            "kernel_ms": best_ms(bare("opus_pitch_track", prepared), 40),
            "plain_ms": cuda_ms(lambda: plc_scan._pitch_track_ref(xc, y, length, n_lags), 2),
            "bound_ms": bound, "bound_by": by,
            "chain_ms_serial_sum": (4 * length + 8 * n_lags) / CLOCK_HZ * 1e3}


def synth_times(ext, lpc, hist0) -> dict:
    """ms of the wrapper, the bare kernel launch and the plain version,
    with the bound: bytes (ext, lpc, hist0 read, out written) or the
    arithmetic of the sequential recurrence (24 multiply-adds, 48 flops, a
    sample) at the float32 peak.  The chunked kernel is not bound by the
    sequential walk's chain (one multiply-add, 4 cycles, a sample), kept
    as chain_ms."""
    from opus_tpu_torch.dsp import plc_scan

    sets = [[a.clone() for a in (ext, lpc, hist0)] + [torch.empty_like(ext)] for _ in range(3)]
    prepared = [plc_scan._synth_kernel_args(*a) for a in sets]
    R, el = ext.shape
    bound, by = bound_ms(R * (2 * el + 48) * 4, 48 * R * el)
    return {"ms": best_ms(cycled(lambda a: plc_scan.lpc_synth(*a[:3]), sets), 40),
            "kernel_ms": best_ms(bare("opus_lpc_synth", prepared), 40),
            "plain_ms": cuda_ms(lambda: plc_scan._lpc_synth_ref(ext, lpc, hist0), 2),
            "bound_ms": bound, "bound_by": by, "chain_ms": 4 * el / CLOCK_HZ * 1e3}


def stride2(y):
    """A stride-2 view holding y, as the coarse search passes it."""
    y2 = torch.zeros(y.shape[0], 2 * y.shape[1], device=y.device)
    y2[:, ::2] = y
    return y2[:, ::2]


def plc_phase(dev, where: str) -> dict:
    """The concealment's scan kernels vs their plain versions on synthetic
    inputs at the whole-batch shapes (B=1024: pitch rows 1024, synthesis
    rows 2048 of 1080 samples), coarse and fine searches; on ties at the
    kernel's lane edges (PITCH_GEOMETRY, y contiguous and at stride 2); on
    every chunk geometry of lpc_synth (SYNTH_ELS x SYNTH_ROWS); times at
    the whole-batch shapes."""
    fine = pitch_inputs(41, B, 664, 310, dev)
    check_pitch(*fine, 664, 310, "synthetic fine")
    coarse = pitch_inputs(42, B, 332, 155, dev)
    check_pitch(coarse[0], stride2(coarse[1]), 332, 155, "synthetic coarse, stride-2 y")
    for length, n_lags in PITCH_GEOMETRY:
        xc, y = pitch_edge_inputs(n_lags, 300, length, n_lags, dev)
        check_pitch(xc, y, length, n_lags, "lane-edge ties")
        check_pitch(xc, stride2(y), length, n_lags, "lane-edge ties, stride-2 y")
    err = 0.0
    for el in SYNTH_ELS:
        for rows in SYNTH_ROWS:
            args = synth_inputs(rows + el, rows, el, dev)
            err = max(err, check_synth(*args, "chunk geometry"))
    syn = synth_inputs(43, B * C, 1080, dev)
    err = max(err, check_synth(*syn, "synthetic"))
    t_p = pitch_times(*fine, 664, 310)
    t_s = synth_times(*syn)
    for name, t, shape in (("pitch_track", t_p, f"rows={B} fine"),
                           ("lpc_synth", t_s, f"rows={B * C} el=1080")):
        print(f"time {name} {shape} synthetic: wrapper_ms={t['ms']} kernel_alone_ms="
              f"{t['kernel_ms']} plain_ms={t['plain_ms']} bound_ms={t['bound_ms']} "
              f"({t['bound_by']}) ({where})")
    return {"synth_err": err, "pitch": t_p, "synth": t_s}


def plc_on_real_inputs(captured: dict, where: str) -> dict:
    """The scan kernels vs their plain versions on the inputs recorded at
    the first lossy plan step (coarse and fine search, the synthesis), and
    their times there."""
    out = {"pitch": {}, "synth": {}, "synth_err": 0.0}
    for (rows, n_lags), (xc, y, length, _) in sorted(captured["pitch"].items()):
        label = "plan-loss step"
        check_pitch(xc, y, length, n_lags, label)
        t = pitch_times(xc, y, length, n_lags)
        out["pitch"][rows, n_lags] = t
        print(f"time pitch_track {label} rows={rows} n_lags={n_lags}: wrapper_ms={t['ms']} "
              f"kernel_alone_ms={t['kernel_ms']} plain_ms={t['plain_ms']} "
              f"bound_ms={t['bound_ms']} ({t['bound_by']}) ({where})")
    for rows, args in sorted(captured["synth"].items()):
        label = "plan-loss step"
        out["synth_err"] = max(out["synth_err"], check_synth(*args, label))
        t = synth_times(*args)
        out["synth"][rows] = t
        print(f"time lpc_synth {label} rows={rows}: wrapper_ms={t['ms']} kernel_alone_ms={t['kernel_ms']} "
              f"plain_ms={t['plain_ms']} bound_ms={t['bound_ms']} ({t['bound_by']}) ({where})")
    return out


def make_payloads(seed: int = 1) -> list:
    """batches[step][stream]: 20 ms CELT payloads from the native encoder.

    Each stream is a tone (220-880 Hz) plus noise, with a click every
    4801 samples at a stream-dependent phase so that some frames code
    short blocks.
    """
    from opus_tpu_torch.native.frontend import NativeCeltEncoderBatch

    rng = np.random.default_rng(seed)
    f0 = 220.0 * 2.0 ** ((np.arange(B) % 24) / 12.0)
    phase = rng.uniform(0, 2 * np.pi, B)
    enc = NativeCeltEncoderBatch(B, C)
    batches = []
    for f in range(STEPS):
        t = (f * FRAME + np.arange(FRAME)) / 48000.0
        sig = 0.4 * np.sin(2 * np.pi * f0[:, None] * t + phase[:, None])
        sig += 0.05 * rng.standard_normal((B, FRAME))
        pos = f * FRAME + np.arange(FRAME)
        sig += 0.9 * (((pos[None, :] + 97 * np.arange(B)[:, None]) % 4801) == 0)
        pcm = np.stack([sig, 0.8 * np.roll(sig, 7, axis=1)], -1).astype(np.float32)
        batches.append([bytes(p) for p in enc.encode_batch(pcm, NBYTES)])
    return batches


def with_losses(batches) -> list:
    """In step LOST_STEP every third stream's packet is lost."""
    return [[None if f == LOST_STEP and i % 3 == 0 else p for i, p in enumerate(pk)]
            for f, pk in enumerate(batches)]


def with_plan_losses(batches) -> list:
    """The plan-loss traffic: on steps 1-12 each stream loses its packet
    with probability PLAN_LOSS_P (numpy, seed PLAN_LOSS_SEED), about 51 a
    step; on step LOST_STEP every third stream also loses it (at least
    342: more than the compact capacity); stream 1 loses steps 3-8 (five
    pitch-regime frames, then the noise regime) and stream 2 steps 9-10."""
    rng = np.random.default_rng(PLAN_LOSS_SEED)
    out = []
    for f, pk in enumerate(batches):
        lost = np.zeros(B, bool)
        if 1 <= f <= 12:
            lost = rng.random(B) < PLAN_LOSS_P
        if f == LOST_STEP:
            lost |= np.arange(B) % 3 == 0
        lost[1] |= 3 <= f <= 8
        lost[2] |= f in (9, 10)
        out.append([None if lost[i] else p for i, p in enumerate(pk)])
    return out


def kept_rows(keep, sample) -> tuple[list, list, list]:
    """The rows a serving loop copies from the ring each step (keep, then
    sample, each row once), and where keep's and sample's rows lie in them."""
    rows = list(dict.fromkeys([*keep, *sample]))
    return rows, [rows.index(r) for r in keep], [rows.index(r) for r in sample]


def sampled(pcm: list, ranges: list, rows: list) -> dict | None:
    """The library phase's sample of a run: rows, PCM [n, steps x FRAME,
    channels] and each step's final ranges of those rows."""
    if not rows:
        return None
    return {"rows": list(rows), "pcm": np.concatenate(pcm, axis=1), "ranges": ranges}


def serve_steps(dec, batches, sample=(), captured=None) -> dict:
    """Serve one step per call; keep streams 0-3's PCM, each step's
    post-filter activity and its count of streams flagged for device
    concealment (from the slot the step used), and the PCM and final ranges
    of the streams `sample` (for the library phase), with one gather of
    the ring a step.  captured["step"] (recording_inputs) counts the steps."""
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    rows, at_keep, at_sample = kept_rows(range(4), sample)
    pcm, chunks, flagged, s_pcm, s_ranges = [], [], [], [], []
    for t, packets in enumerate(batches):
        if captured is not None:
            captured["step"] = t
        fallbacks = dec.plan_fallbacks
        digest = dec.serve([packets], FRAME)
        ring = dec._serve_ring
        if not bool(torch.isfinite(ring).all()) or not np.isfinite(digest).all():
            raise AssertionError("serve produced non-finite PCM")
        kept = ring[rows].cpu().numpy()  # a copy: the ring is rewritten in place
        pcm.append(kept[at_keep])
        if sample:
            s_pcm.append(kept[at_sample])
            ranges = dec.final_ranges()
            s_ranges.append([ranges[i] for i in sample])
        plan_slot = dec.transfer == "plan" and dec.plan_fallbacks == fallbacks
        if dec.transfer != "plan":
            slot = dec._slots[0]
        elif not plan_slot:
            slot = dec._plan_q14_slots[(dec.plan_fallbacks - 1) % 2]
        else:
            slot = dec._plan_slots[0]
        chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
        chunks.append(chunk if active else None)
        flagged.append(int((slot["meta"][:, 14] & 1).sum()) if plan_slot else 0)
    if tuple(ring.shape) != (dec.batch, FRAME, C):
        raise AssertionError(f"serve produced {tuple(ring.shape)} PCM")
    pitch = getattr(dec, "_serve_plc_pitch", None)
    return {"pcm": np.concatenate(pcm, axis=1), "ranges": dec.final_ranges()[:4],
            "chunks": chunks, "flagged": flagged,
            "plc_pitch": None if pitch is None else pitch[:4].cpu().numpy(),
            "sample": sampled(s_pcm, s_ranges, sample)}


def same_layout(t):
    """A copy of t with t's strides (a view of `meta` stays a strided view)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)


def recording_inputs(captured: dict):
    """Context manager: while it is open, the main path's rotation passes,
    post-filter calls and concealment scans run as before, and the inputs
    of the first two rotation passes and of the first post-filter call are
    copied into captured["rotation"] and captured["postfilter"], those of
    the first pitch_track call of each (rows, lags) into
    captured["pitch"] and of the first lpc_synth call of each row count
    into captured["synth"].  On the card a serving step is replayed from
    its CUDA graph, which runs no wrapper: only eager calls record (the
    warm-up that precedes each variant's capture), never a call made while
    a graph is being captured.  captured["from"] collects (kernel, step)
    of each recording, the step being captured["step"] at the time (the
    caller's count of the serve calls made)."""
    import contextlib

    from opus_tpu_torch.dsp import plan_exec, plc_exec, synthesis

    real_rot, real_pf = plan_exec.rot_pass, synthesis.postfilter
    real_pt, real_ls = plc_exec.pitch_track, plc_exec.lpc_synth
    captured.update(rotation=[], postfilter=[], pitch={}, synth={}, step=0)
    captured["from"] = {}

    def eager_call(kernel: str) -> bool:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return False
        captured["from"].setdefault(kernel, set()).add(captured["step"])
        return True

    def rot(*args):
        if len(captured["rotation"]) < 2 and eager_call("rotation"):
            captured["rotation"].append([a.clone() for a in args])
        return real_rot(*args)

    def pf(y, hist, n, lm, periods, gains, tapsets, chunk):
        if not captured["postfilter"] and eager_call("postfilter"):
            captured["postfilter"].append(
                (y.clone(), hist, n, lm, same_layout(periods), same_layout(gains),
                 same_layout(tapsets), chunk))
        return real_pf(y, hist, n, lm, periods, gains, tapsets, chunk)

    def pt(xc, y, length, n_lags):
        if (xc.shape[0], n_lags) not in captured["pitch"] and eager_call("pitch_track"):
            captured["pitch"][xc.shape[0], n_lags] = (xc.clone(), same_layout(y), length,
                                                      n_lags)
        return real_pt(xc, y, length, n_lags)

    def ls(ext, lpc, hist0):
        if ext.shape[0] not in captured["synth"] and eager_call("lpc_synth"):
            captured["synth"][ext.shape[0]] = [a.clone() for a in (ext, lpc, hist0)]
        return real_ls(ext, lpc, hist0)

    @contextlib.contextmanager
    def patched():
        plan_exec.rot_pass, synthesis.postfilter = rot, pf
        plc_exec.pitch_track, plc_exec.lpc_synth = pt, ls
        try:
            yield
        finally:
            plan_exec.rot_pass, synthesis.postfilter = real_rot, real_pf
            plc_exec.pitch_track, plc_exec.lpc_synth = real_pt, real_ls

    return patched()


def recorded_from(captured: dict) -> dict:
    """Each recorded kernel's steps (recording_inputs' captured["from"])."""
    return {k: sorted(v) for k, v in captured["from"].items()}


def graph_summary(dec) -> str:
    """The CUDA graphs a decoder captured and each capture's host ms (the
    eager run and the capture)."""
    from opus_tpu_torch.dsp.graphs import CapturedStep

    steps = [s for s in dec._steps.values() if isinstance(s, CapturedStep)]
    done = [s for s in steps if s.graph is not None]
    return (f"{len(done)} graphs captured, capture ms "
            f"{[round(s.capture_ms, 1) for s in done]}")


def rotation_on_real_chains(captured: list, where: str, label: str = "plan step") -> dict:
    """The rotation kernel vs _rot_pass_ref on recorded main-path inputs,
    and its times there."""
    from opus_tpu_torch.dsp.rotation import _rot_pass_ref, rot_pass

    max_abs = 0.0
    times = {}
    for name, args in zip(("A", "B"), captured):
        got, ref = rot_pass(*args), _rot_pass_ref(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        heads = args[3] == 0
        chains = int(heads.sum())
        long_chains = int((heads & (args[4] >= 3)).sum())
        print(f"kernel rotation on {label} pass {name} B={args[0].shape[0]} n2={args[0].shape[1]}: "
              f"{chains} chains, {long_chains} of length >= 3, max_abs_err={err}")
        if long_chains == 0:
            raise AssertionError(f"{label} pass {name} rotated no chain of length >= 3")
        if not bool(torch.isfinite(got).all()) or not err < ROT_ABS_TOL:
            raise AssertionError(f"rotation kernel disagrees with plain version on the "
                                 f"{label}'s pass {name}: {err}")
        max_abs = max(max_abs, err)
        times[name] = rotation_times(args)
        print(f"time rotation B={args[0].shape[0]} n2={args[0].shape[1]} {label} pass {name}: "
              f"wrapper_ms={times[name]['ms']} kernel_alone_ms={times[name]['kernel_ms']} "
              f"plain_ms={times[name]['plain_ms']} ({where})")
    return {"max_abs_err": max_abs, "times": times}


def postfilter_on_real_inputs(rec: tuple, where: str, label: str = "plan step 1") -> dict:
    """The post-filter kernel vs _postfilter_ref on the first plan step's
    recorded inputs (periods and tapsets are the strided views of `meta`
    that the serving core passes), and its times there."""
    from opus_tpu_torch.dsp.postfilter import _postfilter_ref, postfilter

    y, hist, n, lm, periods, gains, tapsets, chunk = rec
    ref = _postfilter_ref(y.clone(), hist, n, lm, periods, gains, tapsets, chunk)
    got = postfilter(y.clone(), hist, n, lm, periods, gains, tapsets, chunk)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    rows = pf_row_chunks(periods, gains, lm)
    live = rows[rows > 0]
    print(f"kernel postfilter on {label} rows={y.shape[0]} lm={lm} batch chunk={chunk}: "
          f"{live.size} of {rows.size} streams active, per-stream chunk min={live.min()} "
          f"median={int(np.median(live))}, periods strides {periods.stride()}: "
          f"max_abs_err={err} max_rel_err={rel}")
    if not bool(torch.isfinite(got).all()) or not rel < PF_REL_TOL:
        raise AssertionError(f"post-filter kernel disagrees with plain version on the "
                             f"{label}'s inputs: rel {rel}")
    t = postfilter_times(y, hist, n, lm, periods, gains, tapsets, chunk)
    t["bytes"] = pf_bytes(periods, gains, n, lm)
    print(f"time postfilter rows={y.shape[0]} lm={lm} chunk={chunk} {label}: wrapper_ms={t['ms']} "
          f"kernel_alone_ms={t['kernel_ms']} plain_ms={t['plain_ms']} "
          f"bytes_needed={t['bytes'][0]} bytes_whole_rows={t['bytes'][1]} ({where})")
    return {"max_abs_err": err, "max_rel_err": rel, "times": t}


def check_launches(launches: dict, chunks: list, plan_steps: int, variants: list,
                   flagged: list | None) -> int:
    """The main-path launch gates: the post-filter once per step with an
    active filter, the rotation twice per plan step, 2 pitch_track + 1
    lpc_synth per concealing step; with `flagged` (streams flagged for
    device concealment, per step), each step's variant must match it.
    Returns the number of concealing steps."""
    active = sum(c is not None for c in chunks)
    plc_steps = sum(v is not False for v in variants)
    if launches["postfilter"] == 0 or launches["postfilter"] != active:
        raise AssertionError(f"post-filter kernel launched {launches['postfilter']} times over "
                             f"{active} post-filter steps")
    if launches["rotation"] != 2 * plan_steps:
        raise AssertionError(f"rotation kernel launched {launches['rotation']} times over "
                             f"{plan_steps} plan steps (2 passes each)")
    if launches["pitch_track"] != 2 * plc_steps or launches["lpc_synth"] != plc_steps:
        raise AssertionError(f"concealment kernels launched {launches['pitch_track']} "
                             f"(pitch_track) and {launches['lpc_synth']} (lpc_synth) times "
                             f"over {plc_steps} concealing steps (2 and 1 each)")
    if flagged is not None:
        wrong = [t for t, (n, v) in enumerate(zip(flagged, variants)) if (n > 0) != (v is not False)]
        if wrong:
            raise AssertionError(f"steps {wrong}: the concealment variant does not match the "
                                 f"flagged streams")
    return plc_steps


def check_against_cpu(name: str, got: dict, want: dict, batches, streams: int,
                      on_device) -> float:
    """Streams 0..streams-1 of a card run vs the port's CPU run of the same
    packets: equal final ranges and carried pitch, PCM within CPU_PCM_TOL
    before a stream's first loss, and from it on too unless on_device(i)
    (its losses are concealed on the device): then within PLC_PCM_TOL.
    Returns the largest PCM error."""
    pcm_err = 0.0
    for i in range(streams):
        lost = [f for f, pk in enumerate(batches) if pk[i] is None]
        split = (lost[0] if lost else len(batches)) * FRAME
        diff = np.abs(got["pcm"][i] - want["pcm"][i])
        before = float(diff[:split].max(initial=0.0))
        after = float(diff[split:].max(initial=0.0))
        pcm_err = max(pcm_err, before, after)
        print(f"stream {i} {name}: lost steps {lost}, final_range {got['ranges'][i]} vs CPU "
              f"{want['ranges'][i]}, max_abs_err before its first loss={before} from it on="
              f"{after}")
        if got["ranges"][i] != want["ranges"][i]:
            raise AssertionError(f"stream {i}: final range differs from the CPU run")
        if not (before < CPU_PCM_TOL and after < (PLC_PCM_TOL if on_device(i) else CPU_PCM_TOL)):
            raise AssertionError(f"stream {i}: PCM err {before} / {after} against the CPU run")
    if got["plc_pitch"] is not None or want["plc_pitch"] is not None:
        print(f"{name}: carried pitch of streams 0-{streams - 1} {got['plc_pitch']} vs CPU "
              f"{want['plc_pitch']}")
        if not np.array_equal(got["plc_pitch"], want["plc_pitch"]):
            raise AssertionError("carried concealment pitch differs from the CPU run")
    return pcm_err


def main_path(dev, name: str, batches, where: str) -> dict:
    """Serve every step through the port at B=1024 with the launch counts
    set to 0 just before and read just after; then check streams 0-3
    against the port's CPU run of the same packets at B=4.  `name` is p10,
    plan or plan-loss (the plan transfer with losses).  On the plan
    transfer no step may fall back to q14, and the kernels are held to
    their plain versions on the recorded inputs; on plan-loss every step
    with streams flagged for concealment must run a concealing variant."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    transfer = "p10" if name == "p10" else "plan"
    dec = BatchedCeltDecoder(B, C, transfer=transfer, device=dev)
    variants = []  # the concealment variant of each plan step
    real_step = dec._plan_serving_step

    def spy(lm, chunk, active, size_class, with_plc=False):
        variants.append(with_plc)
        return real_step(lm, chunk, active, size_class, with_plc)

    dec._plan_serving_step = spy
    counters = kernel_counters()
    captured = {}
    with recording_inputs(captured):
        for fn in counters.values():
            fn.launches = 0
        got = serve_steps(dec, batches, LIBRARY_ROWS if transfer == "plan" else (), captured)
        launches = {k: fn.launches for k, fn in counters.items()}
    print(f"main path {name}: {len(batches)} steps, post-filter chunks {got['chunks']}, "
          f"plan fallbacks {dec.plan_fallbacks}, streams flagged for concealment "
          f"{got['flagged']}, concealment variants {variants}, kernel launches {launches}; "
          f"{graph_summary(dec)}; kernel inputs recorded from the eager warm-up of steps "
          f"{recorded_from(captured)}")
    if dec.plan_fallbacks:
        raise AssertionError(f"{dec.plan_fallbacks} of {len(batches)} plan steps fell back "
                             f"to the q14 spectrum")
    plc_steps = check_launches(launches, got["chunks"],
                               len(batches) if transfer == "plan" else 0, variants,
                               got["flagged"] if transfer == "plan" else None)
    if name == "plan-loss" and not (any(v is True for v in variants)
                                    and any(type(v) is int for v in variants)):
        raise AssertionError(f"plan-loss ran variants {variants}: it needs at least one "
                             f"compact and one whole-batch concealment")
    if name != "plan-loss" and plc_steps:
        raise AssertionError(f"{name} concealed on {plc_steps} steps")
    real = None
    if name == "plan":
        real = {"rotation": rotation_on_real_chains(captured["rotation"], where),
                "postfilter": postfilter_on_real_inputs(captured["postfilter"][0], where)}
    elif name == "plan-loss":
        real = {"plc": plc_on_real_inputs(captured, where)}

    cpu = BatchedCeltDecoder(4, C, transfer=transfer, device="cpu")
    want = serve_steps(cpu, [pk[:4] for pk in batches])
    pcm_err = check_against_cpu(name, got, want, batches, 4, lambda i: name == "plan-loss")
    return {"launches": launches, "chunks": got["chunks"], "real": real,
            "variants": variants, "pcm_err": pcm_err, "sample": got["sample"],
            "final_ring": dec._serve_ring.cpu().numpy(), "final_ranges": dec.final_ranges()}


def serve_rate(dev, transfer: str, batches, where: str, name: str = "") -> float:
    """End-to-end serve rate, audio-s/s at B=1024: median of 5 runs of
    every step after a warm-up run (each ends by fetching the digest).
    A plan rate counts only when no step fell back to q14."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    dec = BatchedCeltDecoder(B, C, transfer=transfer, device=dev)
    dec.serve(batches, FRAME)  # warm-up: cuBLAS, step factories, slots
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        dec.serve(batches, FRAME)
        runs.append(time.perf_counter() - t0)
    if dec.plan_fallbacks:
        raise AssertionError(f"{dec.plan_fallbacks} {transfer} steps fell back to q14 "
                             f"while timing the rate")
    audio_s = B * len(batches) * FRAME / 48000.0
    rates = sorted(audio_s / r for r in runs)
    print(f"serve e2e B={B} {name or transfer} {len(batches)} steps/run: audio_s_per_s median="
          f"{statistics.median(rates)} runs={rates} ({where})")
    return statistics.median(rates)


def p10_device(dev, batches, where: str) -> None:
    """Plane A time and the device step time of the p10 path."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.synthesis import init_state, make_serving_step
    from opus_tpu_torch.dsp.tables import packed_offsets, pf_chunk_for

    dec = BatchedCeltDecoder(B, C, transfer="p10", device=dev)
    slot = dec._alloc_slots(1, "p10")[0]
    plane_a = []
    for packets in batches:
        t0 = time.perf_counter()
        dec.native.decode_batch_q15_into(packets, FRAME, slot)
        plane_a.append(time.perf_counter() - t0)
    chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
    lm = int(slot["meta"][0, 2])
    step = make_serving_step(lm, B, C, pf_chunk=chunk, pf_active=active, transfer="p10",
                             device=dev)
    buf = slot["host"].to(dev)
    state = init_state(B, C, device=dev)
    ring = torch.zeros(B, FRAME, C, device=dev)
    step_ms = cuda_ms(lambda: step(state, ring, buf), 30)
    print(f"plane A p10 B={B}: ms/step median={statistics.median(plane_a) * 1e3} ({where})")
    print(f"device step B={B} p10 lm={lm} chunk={chunk}: ms={step_ms} audio_s_per_s="
          f"{B * FRAME / 48000.0 / (step_ms / 1e3)} upload_words="
          f"{packed_offsets(B, 'p10')['end']} ({where})")


def plan_device(dev, batches, where: str) -> None:
    """Plane A plan time, upload words per step and the plan device step,
    eager (the factory's step) and replayed from its CUDA graph."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.graphs import eager
    from opus_tpu_torch.dsp.synthesis import init_state
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    dec = BatchedCeltDecoder(B, C, transfer="plan", device=dev)
    slot = dec._alloc_plan_slots(1)[0]
    plane_a, words, classes = [], [], []
    for packets in batches:
        t0 = time.perf_counter()
        dec.native.decode_batch_plan_into(packets, FRAME, slot)
        plane_a.append(time.perf_counter() - t0)
        words.append(dec._plan_upload_words(slot))
        classes.append(dec._plan_size_class(slot))
    chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
    lm = int(slot["meta"][0, 2])
    step = dec._plan_serving_step(lm, chunk, active, classes[-1])
    buf = slot["host"][: words[-1]].to(dev)
    state = init_state(B, C, device=dev)
    ring = torch.zeros(B, FRAME, C, device=dev)
    step_ms = cuda_ms(lambda: eager(step)(state, ring, buf), 30)
    replay = cuda_ms(lambda: step(state, ring, buf), 30)
    print(f"plane A plan B={B}: ms/step median={statistics.median(plane_a) * 1e3} ({where})")
    print(f"upload plan B={B}: words/step median={statistics.median(words)} "
          f"per_stream={statistics.median(words) / B} classes={sorted(set(classes))}")
    print(f"device step B={B} plan lm={lm} chunk={chunk} words={words[-1]} class={classes[-1]}: "
          f"eager ms={step_ms} replayed ms={replay} audio_s_per_s eager="
          f"{B * FRAME / 48000.0 / (step_ms / 1e3)} replayed="
          f"{B * FRAME / 48000.0 / (replay / 1e3)} ({where})")


def make_mixed_payloads(celt: list) -> list:
    """batches[step][stream]: whole Opus packets of the mixed traffic.

    Stream i is of kind i % 3: CELT 96 kbps stereo (stream i's payload of
    the CELT paths behind a CELT FB 20 ms stereo ToC), SILK WB 20 ms mono
    at 60 B (24 kbps) or hybrid SWB 20 ms mono at 160 B CBR (64 kbps),
    from the port's native encoders.  Each voice stream is a pulse train
    of its own pitch (100-280 Hz) with a 3 Hz vibrato, a slow level
    swing and noise.
    """
    from opus_tpu_torch.native.frontend import NativeHybridEncoderBatch, NativeSilkEncoderBatch

    rng = np.random.default_rng(3)
    kinds = np.arange(B) % 3
    silk_i, hyb_i = np.flatnonzero(kinds == 1), np.flatnonzero(kinds == 2)
    f0 = 100.0 + 180.0 * rng.random(B)
    silk_enc = NativeSilkEncoderBatch(len(silk_i), 16)
    hyb_enc = NativeHybridEncoderBatch(len(hyb_i))

    batches = []
    for f in range(STEPS):
        s_pay, s_len = silk_enc.encode_batch(np.round(voice(f0, silk_i, 16000, f, rng) * 32767)
                                             .astype(np.int16), SILK_BYTES)
        h_pay, h_len = hyb_enc.encode_batch(voice(f0, hyb_i, 48000, f, rng), HYBRID_BYTES)
        row = [TOC_CELT + p if k == 0 else None for p, k in zip(celt[f], kinds)]
        for j, i in enumerate(silk_i):
            row[i] = TOC_SILK + bytes(s_pay[j, : s_len[j]])
        for j, i in enumerate(hyb_i):
            row[i] = TOC_HYBRID + bytes(h_pay[j, : h_len[j]])
        batches.append(row)
    return batches


def with_mixed_losses(batches) -> list:
    """The mixed-loss traffic: on steps 1-12 each stream loses its packet
    with probability PLAN_LOSS_P (numpy, seed PLAN_LOSS_SEED).  SILK and
    hybrid losses are concealed in plane A, a CELT stream's first lost
    frames on the device."""
    rng = np.random.default_rng(PLAN_LOSS_SEED)
    out = []
    for f, pk in enumerate(batches):
        lost = rng.random(B) < PLAN_LOSS_P if 1 <= f <= 12 else np.zeros(B, bool)
        out.append([None if lost[i] else p for i, p in enumerate(pk)])
    return out


def serve_mixed_steps(dec, batches, keep=range(MIXED_CPU_STREAMS), sample=(),
                      captured=None) -> dict:
    """Serve one step per call; keep the PCM of streams `keep` (0-5 by
    default), each step's post-filter activity, count of streams flagged
    for device concealment, hybrid streams and upload words, and the PCM
    and final ranges of the streams `sample` (for the library phase), with
    one gather of the ring a step.  captured["step"] counts the steps."""
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    keep = list(keep)
    rows, at_keep, at_sample = kept_rows(keep, sample)
    pcm, chunks, flagged, hybrid, words, s_pcm, s_ranges = [], [], [], [], [], [], []
    for t, packets in enumerate(batches):
        if captured is not None:
            captured["step"] = t
        fallbacks = dec.plan_fallbacks
        digest = dec.serve([packets])
        ring = dec._serve_ring
        if not bool(torch.isfinite(ring).all()) or not np.isfinite(digest).all():
            raise AssertionError("mixed serve produced non-finite PCM")
        kept = ring[rows].cpu().numpy()
        pcm.append(kept[at_keep])
        if sample:
            s_pcm.append(kept[at_sample])
            ranges = dec.final_ranges()
            s_ranges.append([ranges[i] for i in sample])
        if dec.transfer != "plan":
            slot = dec._pk_slots[0]
        elif dec.plan_fallbacks == fallbacks:
            slot = dec._plan_slots[0]
        else:
            slot = dec._fallback_slots[(dec.plan_fallbacks - 1) % 2]
        chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
        chunks.append(chunk if active else None)
        flagged.append(int((slot["meta"][:, 14] & 1).sum()))
        hybrid.append(int((slot["meta"][:, 4] == 17).sum()))
        words.append(slot["upload_words"])
    if tuple(ring.shape) != (dec.batch, FRAME, C):
        raise AssertionError(f"mixed serve produced {tuple(ring.shape)} PCM")
    ranges = dec.final_ranges()
    pitch = getattr(dec, "_serve_plc_pitch", None)
    return {"pcm": np.concatenate(pcm, axis=1), "ranges": [ranges[i] for i in keep],
            "chunks": chunks, "flagged": flagged, "hybrid": hybrid, "words": words,
            "plc_pitch": None if pitch is None else pitch[keep].cpu().numpy(),
            "sample": sampled(s_pcm, s_ranges, sample)}


def mixed_path(dev, name: str, batches, where: str) -> dict:
    """Serve the mixed traffic through BatchedOpusDecoder at B=1024 with the
    launch counts set to 0 just before and read just after.  `name` is
    mixed (plan transfer, internal SILK), mixed-loss (the same with
    losses), mixed-p10 (p10, 48 kHz SILK, losses), mixed-switch (mixed with
    the switching streams of `with_switches`, plan and internal SILK) or
    mixed-switch-p10 (the same on p10 with 48 kHz SILK).  On the plan
    transfer no step may fall back to the packed path; every step with
    streams flagged for concealment must run a concealing variant; on
    mixed the kernels are held to their plain versions on the first
    step's recorded inputs (hybrid rows included); on the switch paths
    every step from 1 on must carry a redundant CELT block and both kinds
    must occur.  Then streams 0-5 (two of each kind), and on the switch
    paths four switching streams too, are checked against the port's CPU
    run of their columns."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    transfer, silk = ("p10", "pcm48") if name.endswith("p10") else ("plan", "internal")
    switching = name.startswith("mixed-switch")
    keep = SWITCH_CPU_STREAMS if switching else list(range(MIXED_CPU_STREAMS))
    dec = BatchedOpusDecoder(B, C, transfer=transfer, silk_transfer=silk, device=dev)
    variants = []
    for attr in ("_mixed_plan_serving_step", "_mixed_serving_step"):
        real = getattr(dec, attr)

        def spy(*args, _real=real):
            variants.append(args[-1])  # with_plc is the last argument of both
            return _real(*args)

        setattr(dec, attr, spy)
    counters = kernel_counters()
    captured = {}
    with recording_inputs(captured), shadow_probe(dec) as shadow:
        for fn in counters.values():
            fn.launches = 0
        got = serve_mixed_steps(dec, batches, keep,
                                LIBRARY_ROWS if name in ("mixed", "mixed-loss") else (), captured)
        launches = {k: fn.launches for k, fn in counters.items()}
    print(f"main path {name}: {len(batches)} steps, post-filter chunks {got['chunks']}, "
          f"plan fallbacks {dec.plan_fallbacks}, streams flagged for concealment "
          f"{got['flagged']}, concealment variants {variants}, hybrid streams {got['hybrid']}, "
          f"upload words {got['words']}, kernel launches {launches}; {graph_summary(dec)}; "
          f"kernel inputs recorded from the eager warm-up of steps {recorded_from(captured)}")
    if dec.plan_fallbacks:
        raise AssertionError(f"{dec.plan_fallbacks} of {len(batches)} mixed plan steps fell "
                             f"back to the packed path")
    plc_steps = check_launches(launches, got["chunks"],
                               len(batches) if transfer == "plan" else 0, variants,
                               got["flagged"])
    if (name in ("mixed-loss", "mixed-p10")) != (plc_steps > 0):
        raise AssertionError(f"{name} concealed on {plc_steps} steps")
    if min(got["hybrid"]) == 0:
        raise AssertionError("a mixed step decoded no hybrid stream")
    if switching:
        check_switch_steps(name, shadow["steps"])
    real = None
    if name == "mixed":
        label = f"mixed plan step 1 ({got['hybrid'][0]} hybrid streams)"
        real = {"rotation": rotation_on_real_chains(captured["rotation"], where, label),
                "postfilter": postfilter_on_real_inputs(captured["postfilter"][0], where, label)}

    cols = [[pk[i] for i in keep] for pk in batches]
    cpu = BatchedOpusDecoder(len(keep), C, transfer=transfer, silk_transfer=silk, device="cpu")
    want = serve_mixed_steps(cpu, cols, range(len(keep)))
    # CELT streams (i % 3 == 0) conceal first losses on the device; SILK and
    # hybrid losses are concealed in plane A, which is shared, so exact.
    pcm_err = check_against_cpu(name, got, want, cols, len(keep),
                                lambda j: keep[j] % 3 == 0 and keep[j] % SWITCH_EVERY != 15)
    return {"launches": launches, "chunks": got["chunks"], "real": real, "variants": variants,
            "pcm_err": pcm_err, "words": got["words"], "shadow": shadow["steps"],
            "sample": got["sample"],
            "final_ring": dec._serve_ring.cpu().numpy(), "final_ranges": dec.final_ranges()}


def load_switch_traffic() -> list:
    """The committed switching traffic (tools/make_switch_traffic.py),
    read with numpy alone: steps[t][sequence], whole Opus packets."""
    data = np.load(SWITCH_FIXTURE, allow_pickle=False)
    blob, lengths = data["packets"].tobytes(), data["lengths"]
    ends = np.cumsum(lengths.ravel())
    pkts = [blob[e - n : e] for e, n in zip(ends, lengths.ravel())]
    seqs, steps = lengths.shape
    if steps != STEPS:
        raise AssertionError(f"{SWITCH_FIXTURE} holds {steps} steps, not {STEPS}")
    return [[pkts[s * steps + t] for s in range(seqs)] for t in range(steps)]


def with_switches(batches) -> list:
    """The mixed-switch traffic: the mixed traffic with every stream i of
    i % SWITCH_EVERY == 15 (64 streams) replaced by fixture sequence
    (i // SWITCH_EVERY) % 24: stereo CELT -> SILK -> hybrid -> CELT mode
    switches (even sequences) and SILK NB -> wider bandwidth switches
    (odd), with their redundant CELT blocks."""
    fixture = load_switch_traffic()
    n = len(fixture[0])
    return [[fixture[f][(i // SWITCH_EVERY) % n] if i % SWITCH_EVERY == 15 else p
             for i, p in enumerate(pk)] for f, pk in enumerate(batches)]


def shadow_probe(dec):
    """Context manager: while it is open, every _collect_corrections call
    of `dec` records the step's redundant blocks (and how many are
    celt_to_silk), the shadow decodes and its host seconds, and the
    scalar CeltDecoder.decode records each call's host seconds (the
    shadow decode of one block).  Yields {"steps": [...], "decode_s":
    [...]}."""
    import contextlib

    from opus_tpu_torch.celt.decoder import CeltDecoder

    rec = {"steps": [], "decode_s": []}
    real_collect, real_decode = dec._collect_corrections, CeltDecoder.decode

    def decode(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return real_decode(self, *args, **kw)
        finally:
            rec["decode_s"].append(time.perf_counter() - t0)

    def collect(packets, rcs, *rest):
        red = (rcs > 0) & (rcs & 1 == 1)
        n0 = len(rec["decode_s"])
        t0 = time.perf_counter()
        corrs = real_collect(packets, rcs, *rest)
        rec["steps"].append({"blocks": int(red.sum()),
                             "celt_to_silk": int((red & ((rcs >> 1) & 1 == 1)).sum()),
                             "decodes": len(rec["decode_s"]) - n0,
                             "s": time.perf_counter() - t0})
        return corrs

    @contextlib.contextmanager
    def patched():
        dec._collect_corrections, CeltDecoder.decode = collect, decode
        try:
            yield rec
        finally:
            del dec._collect_corrections
            CeltDecoder.decode = real_decode

    return patched()


def check_switch_steps(name: str, steps: list) -> None:
    """Print each step's redundant blocks by kind and its shadow decodes;
    fail unless every step from 1 on carries a redundant block and both
    kinds occur."""
    for t, st in enumerate(steps):
        print(f"{name} step {t}: redundant blocks {st['blocks']} (celt_to_silk "
              f"{st['celt_to_silk']}, silk_to_celt {st['blocks'] - st['celt_to_silk']}), "
              f"shadow decodes {st['decodes']}, _collect_corrections host ms {st['s'] * 1e3}")
    empty = [t for t, st in enumerate(steps) if t >= 1 and st["blocks"] == 0]
    c2s = sum(st["celt_to_silk"] for st in steps)
    s2c = sum(st["blocks"] - st["celt_to_silk"] for st in steps)
    if empty or not c2s or not s2c or not sum(st["decodes"] for st in steps):
        raise AssertionError(f"{name}: steps {empty} carry no redundant block, or a kind is "
                             f"missing (celt_to_silk {c2s}, silk_to_celt {s2c})")


def mixed_rate(dev, batches, transfer: str, silk: str, where: str, name: str) -> float:
    """End-to-end mixed serve rate, audio-s/s at B=1024: median of 5 runs
    of every step after a warm-up run; no plan step may fall back."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    dec = BatchedOpusDecoder(B, C, transfer=transfer, silk_transfer=silk, device=dev)
    dec.serve(batches)  # warm-up: cuBLAS, step factories, slots, resampler banks
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        dec.serve(batches)
        runs.append(time.perf_counter() - t0)
    if dec.plan_fallbacks:
        raise AssertionError(f"{dec.plan_fallbacks} {name} steps fell back while timing")
    rates = sorted(B * len(batches) * FRAME / 48000.0 / r for r in runs)
    print(f"serve e2e B={B} {name} {len(batches)} steps/run: audio_s_per_s median="
          f"{statistics.median(rates)} runs={rates} ({where})")
    return statistics.median(rates)


def switch_rate(dev, batches, where: str) -> float:
    """The mixed-switch serve rate (plan, internal SILK) as mixed_rate
    measures it, and the shadow decode's host cost over the 5 timed runs:
    ms a redundant block (one CeltDecoder.decode) and _collect_corrections
    ms a step, with the blocks a step."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    dec = BatchedOpusDecoder(B, C, transfer="plan", silk_transfer="internal", device=dev)
    dec.serve(batches)  # warm-up
    runs = []
    with shadow_probe(dec) as shadow:
        for _ in range(5):
            t0 = time.perf_counter()
            dec.serve(batches)
            runs.append(time.perf_counter() - t0)
    if dec.plan_fallbacks:
        raise AssertionError(f"{dec.plan_fallbacks} mixed-switch steps fell back while timing")
    rates = sorted(B * len(batches) * FRAME / 48000.0 / r for r in runs)
    steps = shadow["steps"]
    blocks = [st["blocks"] for st in steps]
    if not shadow["decode_s"]:
        raise AssertionError("the timed mixed-switch runs decoded no redundant block")
    print(f"serve e2e B={B} mixed-switch {len(batches)} steps/run: audio_s_per_s median="
          f"{statistics.median(rates)} runs={rates} ({where})")
    print(f"shadow decode mixed-switch B={B} over 5 runs: host ms a block median="
          f"{statistics.median(shadow['decode_s']) * 1e3} mean="
          f"{statistics.fmean(shadow['decode_s']) * 1e3} ({len(shadow['decode_s'])} blocks); "
          f"_collect_corrections host ms a step median="
          f"{statistics.median(st['s'] for st in steps) * 1e3} max="
          f"{max(st['s'] for st in steps) * 1e3}; redundant blocks a step median="
          f"{statistics.median(blocks)} max={max(blocks)} ({where})")
    return statistics.median(rates)


def replay_vs_eager(step, state, ring, buf, plc=(), **kw) -> dict:
    """One serving step replayed from its CUDA graph against the factory's
    uncaptured step (graphs.eager) run on copies of the same state, ring
    and conceal state, on the same uploaded slot.  The first call captures
    the variant when it is new (its eager run advances the state, which is
    restored before the replay).  Returns whether ring, state.mem,
    preemph, silk_hist, the conceal's LPC and pitch and the digest are
    equal bit for bit, each one's max abs difference, whether a second
    eager run equals the first (a step that is not deterministic could not
    pass), and the host ms of the replayed call (no sync)."""
    from opus_tpu_torch.dsp.graphs import eager
    from opus_tpu_torch.dsp.synthesis import SynthState

    pairs = [("mem", state.mem), ("preemph", state.preemph), ("silk_hist", state.silk_hist),
             ("ring", ring), *zip(("plc_lpc", "plc_pitch"), plc)]
    pairs = [(n, t) for n, t in pairs if t is not None]
    snap = [t.clone() for _, t in pairs]
    step(state, ring, buf, *plc, **kw)  # the variant's capture, when it is new
    for (_, t), s0 in zip(pairs, snap):
        t.copy_(s0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    digest = step(state, ring, buf, *plc, **kw)[2]
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    got = {n: t.clone() for n, t in pairs}
    got["digest"] = digest.clone()

    def run_eager() -> dict:
        out = {n: s0.clone() for (n, _), s0 in zip(pairs, snap)}
        e_state = SynthState(out["mem"], out["preemph"], out.get("silk_hist"))
        e_plc = [out[n] for n in ("plc_lpc", "plc_pitch") if n in out]
        out["digest"] = eager(step)(e_state, out["ring"], buf, *e_plc, **kw)[2]
        return out

    want, again = run_eager(), run_eager()
    torch.cuda.synchronize()
    diffs = {n: float((got[n].double() - want[n].double()).abs().max()) for n in got}
    return {"equal": all(torch.equal(got[n], want[n]) for n in got), "diffs": diffs,
            "eager_repeat_equal": all(torch.equal(want[n], again[n]) for n in want),
            "host_ms": host_ms}


def graph_case(dev, name: str, batches, t: int) -> tuple:
    """A decoder at B=1024 that has served steps 0..t-1 through serve() (on
    their graphs), and step t's plane A and upload done by hand as the
    serve loop does them: (decoder, step, state, ring, buf, plc, kw,
    plane A ms).  `name` is p10, plan, compact, whole-batch (the plan
    transfer), mixed or mixed-loss (plan, internal SILK)."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.tables import pf_chunk_for
    from opus_tpu_torch.native.frontend import pack_plan_silk

    if name.startswith("mixed"):
        dec = BatchedOpusDecoder(B, C, transfer="plan", silk_transfer="internal", device=dev)
        if t:
            dec.serve(batches[:t])
        state, ring = dec._serve_state_and_ring(FRAME)
        slots, plan_buf = dec._alloc_plan_slots(FRAME, 1)
        t0 = time.perf_counter()
        dec._plane_a_plan(batches[t], slots[0])
        plane_a = (time.perf_counter() - t0) * 1e3
        lm, chunk, active, with_plc = dec._step_picks(slots[0])
        silk_at, words = pack_plan_silk(slots[0])
        buf, end, at = dec._upload_plan(slots[0], plan_buf, words, silk_at)
        step = dec._mixed_plan_serving_step(lm, chunk, active, dec._plan_size_class(slots[0]),
                                            with_plc)
        kw = dict(end=end, silk_at=at)
    else:
        transfer = "p10" if name == "p10" else "plan"
        dec = BatchedCeltDecoder(B, C, transfer=transfer, device=dev)
        if t:
            dec.serve(batches[:t], FRAME)
        state, ring = dec._serve_state_and_ring()
        slot = dec._alloc_slots(1, "p10")[0] if transfer == "p10" else dec._alloc_plan_slots(1)[0]
        t0 = time.perf_counter()
        if transfer == "p10":
            dec.native.decode_batch_q15_into(batches[t], FRAME, slot)
        else:
            dec.native.decode_batch_plan_into(batches[t], FRAME, slot)
        plane_a = (time.perf_counter() - t0) * 1e3
        meta = slot["meta"]
        lm = dec._step_lm(meta)
        chunk, active = pf_chunk_for(meta[:, 6:9], slot["gains"])
        ring = dec._ring_for(ring, lm)
        with_plc = False
        if transfer == "p10":
            buf, kw = dec._device_buffer("p10", slot["host"].shape[0]), {}
            dec._upload(slot, buf, buf.shape[0])
            step = dec._serving_step(lm, chunk, active, "p10")
        else:
            with_plc = dec._plc_variant(meta)
            plan_buf = dec._device_buffer("plan", slot["head"].shape[0])
            buf, end, _ = dec._upload_plan(slot, plan_buf, dec._plan_upload_words(slot))
            step = dec._plan_serving_step(lm, chunk, active, dec._plan_size_class(slot), with_plc)
            kw = dict(end=end)
    variant = "none" if with_plc is False else "whole-batch" if with_plc is True else "compact"
    if variant != {"compact": "compact", "whole-batch": "whole-batch",
                   "mixed-loss": "compact"}.get(name, "none"):
        raise AssertionError(f"graphs {name}: step {t} runs the concealment variant {with_plc}")
    plc = dec._serve_plc_state(C) if with_plc else ()
    return dec, step, state, ring, buf, plc, kw, plane_a


#: (variant, traffic, step): each variant of the CELT and mixed serve loops
#: at a step that runs it (plan-loss step 1 conceals about 51 streams:
#: compact; step LOST_STEP at least 342: the whole batch).
GRAPH_CASES = [("p10", "lossy", 1), ("plan", "clean", 1), ("compact", "plan_lossy", 1),
               ("whole-batch", "plan_lossy", LOST_STEP), ("mixed", "mixed", 1),
               ("mixed-loss", "mixed_lossy", 1)]
#: Runtime and driver calls that launch one kernel (cudaLaunchKernelExC, ...).
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def replay_profile(run) -> dict:
    """The runtime calls of one run() under torch.profiler: its graph
    launches, its kernel launches and the kernels the card ran."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    count = {e.key: e.count for e in ka if e.device_type != torch.autograd.DeviceType.CUDA}
    return {"graph_launches": sum(c for k, c in count.items() if k.startswith("cudaGraphLaunch")),
            "kernel_launches": sum(c for k, c in count.items()
                                   if k.startswith(KERNEL_LAUNCH_CALLS)),
            "device_kernels": sum(e.count for e in ka
                                  if e.device_type == torch.autograd.DeviceType.CUDA)}


def graphs_phase(dev, traffic: dict, where: str) -> dict:
    """Each step variant of the CELT and mixed serve loops (GRAPH_CASES) at
    B=1024: its step replayed from its CUDA graph must equal the
    factory's eager step from copies of the same state, slot and ring, bit
    for bit (ring, state.mem, preemph, silk_hist, the conceal's LPC and
    pitch, the digest).  Prints per variant the graphs the decoder
    captured and their capture ms, plane A's ms of the step, the host ms
    of the replayed step call, the device ms of a replayed and of an eager
    step (CUDA events), and torch.cuda.max_memory_allocated since the
    phase began; on the plan variant the profiler must show one
    cudaGraphLaunch and no kernel launch for a replayed step."""
    import gc

    from opus_tpu_torch.dsp.graphs import eager

    torch.cuda.reset_peak_memory_stats()
    out = {}
    for name, kind, t in GRAPH_CASES:
        dec, step, state, ring, buf, plc, kw, plane_a = graph_case(dev, name, traffic[kind], t)
        res = replay_vs_eager(step, state, ring, buf, plc, **kw)
        host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, ring, buf, *plc, **kw)
            host.append((time.perf_counter() - t0) * 1e3)
        replay = cuda_ms(lambda: step(state, ring, buf, *plc, **kw), 20)
        eager_ms = cuda_ms(lambda: eager(step)(state, ring, buf, *plc, **kw), 3)
        prof = replay_profile(lambda: step(state, ring, buf, *plc, **kw))
        res.update(graphs=graph_summary(dec), capture_ms=step.capture_ms, plane_a_ms=plane_a,
                   host_ms=statistics.median(host), replay_ms=replay, eager_ms=eager_ms,
                   profile=prof, max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"graphs {name} step {t} B={B}: replay equals eager bit for bit {res['equal']} "
              f"(max abs diff {res['diffs']}; a second eager run equals the first "
              f"{res['eager_repeat_equal']}); {res['graphs']}; this variant's capture ms "
              f"{step.capture_ms}; plane A ms {plane_a}; host ms of a replayed step call "
              f"median {res['host_ms']}; device ms a step by events: replayed {replay}, eager "
              f"{eager_ms}; a replay under the profiler: {prof}; max_memory_allocated "
              f"{res['max_memory_allocated']} B ({where})")
        if not res["equal"]:
            raise AssertionError(f"graphs {name}: the replayed step differs from the eager "
                                 f"one: {res['diffs']}")
        if prof["graph_launches"] != 1 or prof["kernel_launches"]:
            raise AssertionError(f"graphs {name}: a replayed step made {prof['graph_launches']} "
                                 f"graph launches and {prof['kernel_launches']} kernel launches")
        out[name] = res
        del dec, step, state, ring, buf, plc, kw
        gc.collect()
        torch.cuda.empty_cache()
    plan = out["plan"]
    print(f"graphs summary B={B}: plan step plane A ms {plan['plane_a_ms']}, host ms of a "
          f"replayed step call {plan['host_ms']}, device busy ms (events) {plan['replay_ms']} "
          f"(eager {plan['eager_ms']}); max_memory_allocated over the phase "
          f"{torch.cuda.max_memory_allocated()} B ({where})")
    return out


def pipelined_phase(dev, clean, mixed, where: str) -> dict:
    """run_pipelined of both decoders at B=1024 over PIPELINED_STEPS steps:
    BatchedCeltDecoder (f32 planes) on the CELT payloads and
    BatchedOpusDecoder (p10, 48 kHz SILK) on the mixed traffic.  The
    launch counts are set to 0 just before each and read just after: the
    post-filter once a step (twice when a step mixes short and long blocks
    and runs both variants), no rotation and no scan.  The last step's
    streams 0-5 are held to the port's CPU run of their columns (equal
    final ranges, PCM within CPU_PCM_TOL); then the host ms a step, median
    of 5 runs of the steps after the checked one."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    counters = kernel_counters()
    cases = {
        "pipelined-celt": (lambda n, d: BatchedCeltDecoder(n, C, device=d),
                           lambda dec, b: dec.run_pipelined(b, FRAME), clean),
        "pipelined-mixed": (lambda n, d: BatchedOpusDecoder(n, C, transfer="p10",
                                                            silk_transfer="pcm48", device=d),
                            lambda dec, b: dec.run_pipelined(b), mixed),
    }
    out = {}
    n = MIXED_CPU_STREAMS
    for name, (make, run, batches) in cases.items():
        steps = batches[:PIPELINED_STEPS]
        dec = make(B, dev)
        for fn in counters.values():
            fn.launches = 0
        pcm = run(dec, steps)
        launches = {k: fn.launches for k, fn in counters.items()}
        if tuple(pcm.shape) != (B, FRAME, C) or not bool(torch.isfinite(pcm).all()):
            raise AssertionError(f"{name} returned {tuple(pcm.shape)} PCM or non-finite values")
        if (not len(steps) <= launches["postfilter"] <= 2 * len(steps)
                or launches["rotation"] or launches["pitch_track"] or launches["lpc_synth"]):
            raise AssertionError(f"{name}: kernel launches {launches} over {len(steps)} steps")
        cpu = make(n, "cpu")
        want = run(cpu, [pk[:n] for pk in steps])
        err = float((pcm[:n].cpu() - want).abs().max())
        ranges = dec.final_ranges()[:n]
        print(f"main path {name}: {len(steps)} steps, kernel launches {launches}, last step "
              f"streams 0-{n - 1} max_abs_err vs CPU={err}, final ranges {ranges} vs CPU "
              f"{cpu.final_ranges()}")
        if not err < CPU_PCM_TOL or ranges != cpu.final_ranges():
            raise AssertionError(f"{name}: last step off the CPU run ({err}) or ranges differ")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run(dec, batches[PIPELINED_STEPS : 2 * PIPELINED_STEPS])
            times.append((time.perf_counter() - t0) / PIPELINED_STEPS)
        ms = statistics.median(times) * 1e3
        print(f"run_pipelined {name} B={B}: host ms a step median={ms} runs="
              f"{sorted(t * 1e3 for t in times)} audio_s_per_s={B * FRAME / 48000.0 / (ms / 1e3)} "
              f"({where})")
        out[name] = {"launches": launches, "chunks": [], "ms": ms}
    return out


def mixed_device(dev, batches, where: str) -> None:
    """Host and device costs of a mixed plan step: the ToC parse and plane
    A per step, the upload words per step with internal and with 48 kHz
    SILK (and of the p10 fallback's packed slot), and the device step on a
    resident slot, eager (CUDA events; kernels per step under the profiler)
    and replayed from its CUDA graph."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.dsp.graphs import eager
    from opus_tpu_torch.dsp.synthesis import init_state
    from opus_tpu_torch.native.frontend import compact_plan_silk, pack_plan_silk

    for silk in ("pcm48", "internal"):
        dec = BatchedOpusDecoder(B, C, transfer="plan", silk_transfer=silk, device=dev)
        slot = dec._alloc_plan_slots(FRAME, 1)[0][0]
        toc_s, plane_a, words, rows = [], [], [], []
        for packets in batches:
            t0 = time.perf_counter()
            _, toc = dec._toc_arrays(packets)
            t1 = time.perf_counter()
            dec.native.decode_batch_plan_into(toc, slot)
            compact_plan_silk(slot, dec._silk_shape(FRAME)[0])
            t2 = time.perf_counter()
            toc_s.append(t1 - t0)
            plane_a.append(t2 - t1)
            silk_at, w = pack_plan_silk(slot)
            words.append(w)
            rows.append(len(slot["silk_rows"]))
        pk_words = dec._alloc_packed_slots(FRAME, 1)[1].shape[0]
        print(f"mixed plan {silk} B={B}: ToC parse ms/step median="
              f"{statistics.median(toc_s) * 1e3} plane A ms/step median="
              f"{statistics.median(plane_a) * 1e3} upload words/step median="
              f"{statistics.median(words)} (fixed {slot['fixed_words']}, SILK rows median "
              f"{statistics.median(rows)}); packed fallback slot words {pk_words} ({where})")
    lm, chunk, active, with_plc = dec._step_picks(slot)
    step = dec._mixed_plan_serving_step(lm, chunk, active, dec._plan_size_class(slot), False)
    buf = slot["host"][:w].to(dev)
    state = init_state(B, C, device=dev, silk_hist=True)
    ring = torch.zeros(B, FRAME, C, device=dev)

    def run():
        eager(step)(state, ring, buf, silk_at=silk_at)

    step_ms = cuda_ms(run, 30)
    replay = cuda_ms(lambda: step(state, ring, buf, silk_at=silk_at), 30)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 5
    print(f"device step B={B} mixed plan internal lm={lm} chunk={chunk} words={w}: eager ms="
          f"{step_ms} kernels/step={kernels} replayed ms={replay} audio_s_per_s eager="
          f"{B * FRAME / 48000.0 / (step_ms / 1e3)} replayed "
          f"{B * FRAME / 48000.0 / (replay / 1e3)} ({where})")


def kernel_counters() -> dict:
    """The six kernel wrappers by kernel name; each counts its launches."""
    from opus_tpu_torch.dryrun import kernel_wrappers

    return kernel_wrappers()


def silk_inputs(fs_khz: int, chunk: int, order: int, rows: int, seed: int, dev):
    """Synthetic silk_synth inputs of one frame (as tests/test_torch_silk.py
    makes them): rows 0-1 voiced at lags chunk + 2 and 18 fs_khz (the
    clamp's edge and the longest lag, whose taps reach the history's first
    sample), rows 2-3 with an LPC pole pair at radius 0.995 and rows 4-5 at
    0.999, odd rows from 3 on unvoiced; LTP taps summing below 1.  Returns
    (args, kw)."""
    rng = np.random.default_rng(seed)
    S = 5 * fs_khz
    L, H = 4 * S, 18 * fs_khz + 2
    gexc = (rng.standard_normal((rows, L)) * 300).astype(np.float32)
    a1 = (rng.standard_normal((rows, order)) * 0.05).astype(np.float32)
    a2 = (rng.standard_normal((rows, order)) * 0.05).astype(np.float32)
    for r, radius, th in ((2, 0.995, 0.2), (3, 0.995, 0.05), (4, 0.999, 0.2), (5, 0.999, 0.05)):
        for a in (a1, a2):
            a[r] = 0.0
            a[r, :2] = [2 * radius * np.cos(th), -radius ** 2]
    voiced = np.array([r < 3 or r % 2 == 0 for r in range(rows)])
    lags = rng.integers(chunk + 2, 18 * fs_khz + 1, (rows, 4)).astype(np.int32)
    lags[0], lags[1] = chunk + 2, 18 * fs_khz
    b = (rng.uniform(0.0, 0.35, (rows, 4, 5)) * np.array([0.3, 0.6, 1.0, 0.6, 0.3])
         ).astype(np.float32)
    head = (rng.standard_normal((rows, H)) * 1000).astype(np.float32)
    hist = (rng.standard_normal((rows, order)) * 1000).astype(np.float32)
    args = [torch.tensor(a, device=dev) for a in (gexc, a1, a2, voiced, lags, b, head, hist)]
    return args, dict(subfr_len=S, nb_subfr=4, chunk=chunk)


def check_silk(args, kw: dict, label: str, recorded: bool = False) -> dict:
    """silk_synth vs the plain version run in float64 (within SILK_F64_TOL
    of each row's peak; the float32 plain version within LPC_PEAK_TOL) and
    vs the float32 plain version: on synthetic rows within SILK_PLAIN_TOL
    beyond the plain version's own distance from the float64 run, row by
    row; on recorded inputs within SILK_REAL_TOL.  The new history must be
    the output's last samples.  Returns the kernel's max abs error against
    the plain version ("max_abs_err", output and history) and its largest
    error against the float64 run ("f64_rel", of the row's peak)."""
    from opus_tpu_torch.dsp.silk_synthesis import _silk_synth_ref, silk_synthesis_step

    got, got_hist = silk_synthesis_step(*args, **kw)
    want, want_hist = _silk_synth_ref(*args, **kw)
    f64, _ = _silk_synth_ref(*[a.double() if a.is_floating_point() else a for a in args], **kw)
    torch.cuda.synchronize()
    order = args[1].shape[1]
    err_row = (got - want).abs().amax(dim=1)
    err = max(float(err_row.max()), float((got_hist - want_hist).abs().max()))
    plain_row = (want.double() - f64).abs().amax(dim=1)
    peak = f64.abs().amax(dim=1).clamp_min(1e-30)
    kernel_row = (got.double() - f64).abs().amax(dim=1)
    rel_k, rel_p = float((kernel_row / peak).max()), float((plain_row / peak).max())
    excess = float((err_row.double() - plain_row).max())
    print(f"kernel silk_synth {label} rows={got.shape[0]} L={got.shape[1]} order={order} "
          f"chunk={kw['chunk']} voiced rows={int(args[3].sum())} lags "
          f"{int(args[4].min())}-{int(args[4].max())}: max_abs_err vs plain={err} LSB (beyond "
          f"the plain version's own float64 error: {excess}); vs float64 max abs kernel="
          f"{float(kernel_row.max())} plain={float(plain_row.max())} LSB, max_err_of_row_peak "
          f"kernel={rel_k} plain={rel_p}")
    close = err < SILK_REAL_TOL if recorded else excess < SILK_PLAIN_TOL
    if not (bool(torch.isfinite(got).all()) and close and rel_k < SILK_F64_TOL
            and rel_p < LPC_PEAK_TOL and torch.equal(got_hist, got[:, -order:])):
        raise AssertionError(f"silk_synth off its plain version or the float64 run ({label}): "
                             f"{err} LSB ({excess} beyond the plain version's own error), "
                             f"kernel {rel_k}, plain {rel_p} of the row peak")
    return {"max_abs_err": err, "f64_rel": rel_k}


def silk_bytes(args, kw: dict) -> tuple[int, int]:
    """(bytes silk_synth must move on these inputs, every byte of its
    arguments and outputs).  Every row reads its voiced flag, gexc, a1, a2
    and lpc_hist and writes xq and the new history; an unvoiced row's
    output depends on nothing else.  A voiced row also reads its lags, its
    LTP taps and the samples of head that its taps reach: subframe k reads
    head[H + kS - lag_k - 2 : H + kS - lag_k + S + 2], clamped at 0 (what
    lies past head is P of the frame's earlier subframes, on chip)."""
    gexc, a1, a2, voiced, lags, b_taps, head, hist = args
    rows, L = gexc.shape
    order, H = a1.shape[1], head.shape[1]
    S, nb = kw["subfr_len"], kw["nb_subfr"]
    v = voiced.cpu().numpy()
    lag = lags.cpu().numpy()[v].astype(np.int64)
    pos = np.arange(H)
    reach = np.zeros((len(lag), H), bool)
    for k in range(nb):
        lo = H + k * S - lag[:, k] - 2
        reach |= (pos >= lo[:, None]) & (pos < lo[:, None] + S + 4)
    every_row = voiced.element_size() + 4 * (2 * L + 4 * order)
    voiced_row = 4 * (nb + nb * b_taps.shape[2])  # lags, LTP taps
    needed = rows * every_row + int(v.sum()) * voiced_row + 4 * int(reach.sum())
    whole = sum(a.numel() * a.element_size() for a in args) + 4 * (gexc.numel() + hist.numel())
    return needed, whole


def silk_times(args, kw: dict) -> dict:
    """ms of the wrapper, the bare kernel launch on C arguments prepared in
    advance (also as one replay of a CUDA graph) and the plain version,
    with the bound: the bytes these inputs need (silk_bytes) over the HBM
    rate, or the sequential LPC's dependent chain (one multiply-add, 4
    cycles, a sample) at CLOCK_HZ, whichever is larger; both terms are
    kept (the chunked kernel is not bound by that chain; the bound stays
    the first design's, so that the shares compare).  16 copies of the
    inputs (64 MB at B=1024, 16 kHz) cycle beyond the 50 MB L2."""
    from opus_tpu_torch import _build
    from opus_tpu_torch.dsp import silk_synthesis as ss

    sets = [[a.clone() for a in args] + [torch.empty_like(args[0]), torch.empty_like(args[7])]
            for _ in range(16)]
    prepared = [ss._kernel_args(*a, **kw) for a in sets]
    L = args[0].shape[1]
    nbytes, whole = silk_bytes(args, kw)
    bound, by = chain_bound_ms(nbytes, 4 * L)
    return {"ms": best_ms(cycled(lambda a: ss.silk_synthesis_step(*a[:8], **kw), sets), 40),
            "kernel_ms": best_ms(bare("opus_silk_synth", prepared), 40),
            "graph_ms": graph_ms(_build.library().opus_silk_synth, prepared),
            "plain_ms": cuda_ms(lambda: ss._silk_synth_ref(*args, **kw), 2),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "bytes_whole_args": whole,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "chain_ms": 4 * L / CLOCK_HZ * 1e3}


def print_silk_times(t: dict, label: str, where: str) -> None:
    print(f"time silk_synth {label}: wrapper_ms={t['ms']} kernel_alone_ms={t['kernel_ms']} "
          f"cuda_graph_ms_per_launch={t['graph_ms']} plain_ms={t['plain_ms']} "
          f"bound_ms={t['bound_ms']} ({t['bound_by']}; bytes needed "
          f"{t['bytes']} -> {t['bytes_ms']} ms, of {t['bytes_whole_args']} in the arguments; "
          f"LPC chain {t['chain_ms']} ms) share_of_bound={t['bound_ms'] / t['kernel_ms']} "
          f"({where})")


def silk_phase(dev, where: str) -> dict:
    """silk_synth vs its plain version and the float64 run on synthetic
    inputs of B rows at 8, 12 and 16 kHz; times at 16 kHz."""
    checks = []
    for fs_khz, chunk, order in SILK_RATES:
        args, kw = silk_inputs(fs_khz, chunk, order, B, 50 + fs_khz, dev)
        checks.append(check_silk(args, kw, f"synthetic {fs_khz} kHz"))
    t = silk_times(args, kw)
    print_silk_times(t, f"rows={B} 16 kHz synthetic", where)
    return {"max_abs_err": max(c["max_abs_err"] for c in checks),
            "f64_rel": max(c["f64_rel"] for c in checks), "times": t}


def voice(f0, idx, rate: int, f: int, rng) -> np.ndarray:
    """Frame f at `rate` of the voice streams idx: each a pulse train of its
    own pitch f0[idx] with a 3 Hz vibrato, a slow level swing and noise."""
    n = rate // 50
    t = (f * n + np.arange(n)) / rate
    ph = 2 * np.pi * f0[idx, None] * t + 2.0 * np.sin(2 * np.pi * 3.0 * t)
    level = 0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t + idx[:, None])
    sig = 0.3 * np.sign(np.sin(ph)) * level + 0.02 * rng.standard_normal((len(idx), n))
    return sig.astype(np.float32)


def make_silk_payloads(batch: int, fs_khz: int, steps: int) -> list:
    """batches[step][stream]: SILK payloads (no ToC) at SILK_BYTES a 20 ms
    frame from the port's native encoder at fs_khz, of the mixed traffic's
    voice content (pitches 100-280 Hz)."""
    from opus_tpu_torch.native.frontend import NativeSilkEncoderBatch

    rng = np.random.default_rng(3)
    f0 = 100.0 + 180.0 * rng.random(batch)
    idx = np.arange(batch)
    enc = NativeSilkEncoderBatch(batch, fs_khz)
    batches = []
    for f in range(steps):
        pcm = np.round(voice(f0, idx, 1000 * fs_khz, f, rng) * 32767).astype(np.int16)
        pay, lens = enc.encode_batch(pcm, SILK_BYTES)
        batches.append([bytes(pay[i, : lens[i]]) for i in range(batch)])
    return batches


def silk_f64_decoder(batch: int, fs_khz: int):
    """A BatchedSilkDecoder on the CPU whose synthesis is the plain version
    run in float64, its LPC history kept in float64: the run that the card
    and the port's CPU run drift from."""
    from opus_tpu_torch.batch.silk_pipeline import _CHUNK, BatchedSilkDecoder
    from opus_tpu_torch.dsp.silk_synthesis import _silk_synth_ref

    dec = BatchedSilkDecoder(batch, fs_khz, device="cpu")
    dec.lpc_hist = dec.lpc_hist.double()

    def synthesize(pl):
        up = [torch.from_numpy(pl[k])
              for k in ("gexc", "a1", "a2", "voiced", "lags", "b", "head")]
        up = [a.double() if a.is_floating_point() else a for a in up]
        xq, dec.lpc_hist = _silk_synth_ref(*up, dec.lpc_hist, subfr_len=5 * fs_khz, nb_subfr=4,
                                           chunk=_CHUNK[fs_khz])
        return xq

    dec.synthesize = synthesize
    return dec


def silk_path(dev, name: str, fs_khz: int, batch: int, steps: int, where: str) -> dict:
    """Drive BatchedSilkDecoder.decode_frames at `batch` streams of
    make_silk_payloads for `steps` steps, with the launch counts set to 0
    just before and read just after: one silk_synth launch a step, voiced
    rows on every step after the first.  The host front end (`planes`) and
    the device step (`synthesize`: upload and launch, by CUDA events) are
    timed every step, and the inputs of the first step with voiced rows are
    recorded.  Streams 0-31 (SILK_PATH_STREAMS) are held to the port's CPU
    run of their payloads and to its float64 run (`silk_f64_decoder`): the
    card's max abs and RMS drift from the float64 run (int16 LSBs) within
    SILK_DRIFT_FACTOR times the CPU run's, plus SILK_DRIFT_FLOOR."""
    from opus_tpu_torch.batch.silk_pipeline import BatchedSilkDecoder

    batches = make_silk_payloads(batch, fs_khz, steps)
    dec = BatchedSilkDecoder(batch, fs_khz, device=dev)
    real_planes, real_synth = dec.planes, dec.synthesize
    rec = {"host_s": [], "dev_ms": [], "voiced": [], "inputs": None}

    def planes(payloads):
        t0 = time.perf_counter()
        out = real_planes(payloads)
        rec["host_s"].append(time.perf_counter() - t0)
        rec["voiced"].append(int(out["voiced"].sum()))
        return out

    def synthesize(pl):
        if rec["inputs"] is None and pl["voiced"].any():
            rec["inputs"] = ({k: v.copy() for k, v in pl.items()}, dec.lpc_hist.clone())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        xq = real_synth(pl)
        end.record()
        end.synchronize()
        rec["dev_ms"].append(start.elapsed_time(end))
        return xq

    dec.planes, dec.synthesize = planes, synthesize
    counters = kernel_counters()
    pcm = []
    t0 = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    for payloads in batches:
        xq = dec.decode_frames(payloads)
        if xq.shape != (batch, 20 * fs_khz) or not np.isfinite(xq).all():
            raise AssertionError(f"{name}: {xq.shape} output or non-finite values")
        pcm.append(xq[:SILK_PATH_STREAMS].copy())
    launches = {k: fn.launches for k, fn in counters.items()}
    wall = time.perf_counter() - t0
    rate = batch * 0.02 * steps / wall
    print(f"main path {name}: B={batch} fs={fs_khz} kHz, {steps} steps, voiced rows by step "
          f"{rec['voiced']}, kernel launches {launches}")
    print(f"serve e2e {name} B={batch}: audio_s_per_s={rate} over {steps} steps in {wall} s; "
          f"host front end ms/step median={statistics.median(rec['host_s']) * 1e3} runs="
          f"{[round(s * 1e3, 1) for s in rec['host_s']]}; device ms/step (upload + silk_synth, "
          f"CUDA events) median={statistics.median(rec['dev_ms'])} ({where})")
    if launches["silk_synth"] != steps or sum(launches.values()) != steps:
        raise AssertionError(f"{name}: kernel launches {launches} over {steps} steps "
                             f"(one silk_synth a step)")
    if min(rec["voiced"][1:]) == 0 or rec["inputs"] is None:
        raise AssertionError(f"{name}: a step after the first has no voiced row "
                             f"({rec['voiced']})")
    n = min(batch, SILK_PATH_STREAMS)
    card_pcm = np.concatenate(pcm, axis=1)
    runs = {"cpu": BatchedSilkDecoder(n, fs_khz, device="cpu"),
            "f64": silk_f64_decoder(n, fs_khz)}
    runs = {k: np.concatenate([d.decode_frames(p[:n]) for p in batches], axis=1)
            for k, d in runs.items()}

    def drift(a, b):
        d = (a - b).astype(np.float64)
        return float(np.abs(d).max()), float(np.sqrt(np.mean(d ** 2)))

    card_cpu, card_f64, cpu_f64 = (drift(card_pcm, runs["cpu"]), drift(card_pcm, runs["f64"]),
                                   drift(runs["cpu"], runs["f64"]))
    limit = [SILK_DRIFT_FACTOR * c + f for c, f in zip(cpu_f64, SILK_DRIFT_FLOOR)]
    print(f"{name}: streams 0-{n - 1}, int16 LSBs (max abs, RMS): card vs the port's CPU run "
          f"{card_cpu}; card vs its float64 run {card_f64} (gates {limit}); CPU vs float64 "
          f"{cpu_f64}")
    if not (card_f64[0] <= limit[0] and card_f64[1] <= limit[1]):
        raise AssertionError(f"{name}: streams 0-{n - 1} drift {card_f64} from the float64 run "
                             f"(the CPU run's {cpu_f64}, gates {limit})")
    err, rms = card_cpu
    return {"launches": launches, "chunks": [], "pcm_err": err, "pcm_rms": rms,
            "drift_f64": card_f64, "cpu_drift_f64": cpu_f64, "rate": rate,
            "host_ms": statistics.median(rec["host_s"]) * 1e3,
            "dev_ms": statistics.median(rec["dev_ms"]), "inputs": rec["inputs"],
            "kw": dict(subfr_len=5 * fs_khz, nb_subfr=4, chunk=20 if fs_khz > 8 else 10)}


def silk_on_real_inputs(path: dict, dev, where: str) -> dict:
    """silk_synth vs its plain version and the float64 run on the recorded
    inputs of the silk-only path's first step with voiced rows, and its
    times there."""
    planes, hist = path["inputs"]
    up = {k: torch.from_numpy(v).to(dev) for k, v in planes.items()}
    args = [up["gexc"], up["a1"], up["a2"], up["voiced"], up["lags"], up["b"], up["head"], hist]
    check = check_silk(args, path["kw"], "silk-only step", recorded=True)
    t = silk_times(args, path["kw"])
    print_silk_times(t, f"rows={args[0].shape[0]} silk-only step", where)
    return {**check, "times": t}


def load_ms_group(group: str, sessions: int) -> tuple[list, list, list]:
    """(layout [channels, streams, coupled, mapping...], steps[p][i],
    libopus's final ranges ranges[p][i]) of one group of the committed
    multistream fixture, read with numpy alone: session i of the batch
    replays fixture session i % (the group's sessions)."""
    data = np.load(MS_FIXTURE, allow_pickle=False)
    blob, lengths = data[f"{group}_packets"].tobytes(), data[f"{group}_lengths"]
    ends = np.cumsum(lengths.ravel())
    flat = [blob[e - n : e] for e, n in zip(ends, lengths.ravel())]
    k, n_p = lengths.shape
    ranges = data[f"{group}_ranges"]
    steps = [[flat[(i % k) * n_p + p] for i in range(sessions)] for p in range(n_p)]
    want = [[int(ranges[i % k, p]) for i in range(sessions)] for p in range(n_p)]
    return data[f"{group}_layout"].tolist(), steps, want


def ms_serve_steps(bmd, steps: list, frames: int, keep: int = 4, sample=(),
                   captured=None) -> dict:
    """Serve one multistream packet a session per call (`frames` core steps
    of 20 ms each); keep sessions 0..keep-1's PCM, every session's final
    ranges after each call, the post-filter activity of every core step
    (CELT cores) and the PCM and final ranges of the sessions `sample`.
    captured["step"] counts the packets."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    core = bmd.core
    pcm, ranges, chunks, s_pcm = [], [], [], []
    for t, packets in enumerate(steps):
        if captured is not None:
            captured["step"] = t
        out = bmd.serve([packets], FRAME)
        if out.shape != (bmd.batch, FRAME, bmd.channels) or not np.isfinite(out).all():
            raise AssertionError(f"multistream serve returned {out.shape} PCM or non-finite "
                                 f"values")
        pcm.append(out[:keep])
        s_pcm.append(out[list(sample)])
        ranges.append(bmd.final_ranges())
        if isinstance(core, BatchedCeltDecoder):
            slots = core._plan_slots if core.transfer == "plan" else core._slots
            for slot in slots[:frames]:
                chunk, active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
                chunks.append(chunk if active else None)
    return {"pcm": np.concatenate(pcm, axis=1), "ranges": ranges, "chunks": chunks, "last": out,
            "sample": sampled(s_pcm, [[r[i] for i in sample] for r in ranges], sample)}


MS_PATHS = {  # path -> (fixture group, sessions, mode, transfer, frames a packet)
    "multistream": ("ambi", MS_SESSIONS, "celt", "plan", 1),
    "multistream-p10": ("ambi", MS_SESSIONS, "celt", "p10", 1),
    "multistream-opus": ("silk", MS_CHECKED_SESSIONS, "opus", "p10", 1),
    "multistream-40ms": ("c40", MS_CHECKED_SESSIONS, "celt", "plan", 2),
}


def ms_path(dev, name: str, where: str) -> dict:
    """Serve the fixture's sessions through BatchedMultistreamDecoder with the
    launch counts set to 0 just before and read just after.  Every
    session's final range must equal libopus's after every packet.  On the
    8-channel paths (multistream: plan, multistream-p10): no plan fallback,
    the post-filter once a step with an active filter and the rotation
    twice a plan step, no concealment, and sessions 0-3 within CPU_PCM_TOL
    of the port's CPU run with equal ranges.  On the CELT paths the
    post-filter, and on plan the rotation, are held to their plain versions
    on the first step's recorded inputs (the elementary streams' shapes)."""
    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder

    group, sessions, mode, transfer, frames = MS_PATHS[name]
    layout, steps, want_ranges = load_ms_group(group, sessions)
    ch, streams, coupled, *mapping = layout

    def make(n, device):
        bmd = BatchedMultistreamDecoder(n, ch, streams, coupled, mapping, mode=mode,
                                        device=device)
        bmd.core.transfer = transfer
        return bmd

    bmd = make(sessions, dev)
    counters = kernel_counters()
    captured = {}
    with recording_inputs(captured):
        for fn in counters.values():
            fn.launches = 0
        got = ms_serve_steps(bmd, steps, frames,
                             sample=LIBRARY_ROWS[:LIBRARY_SESSIONS] if name == "multistream"
                             else (), captured=captured)
        launches = {k: fn.launches for k, fn in counters.items()}
    wrong = [p for p, (g, w) in enumerate(zip(got["ranges"], want_ranges)) if g != w]
    fallbacks = getattr(bmd.core, "plan_fallbacks", 0)
    print(f"main path {name}: {sessions} sessions x {streams} streams ({sessions * streams} "
          f"elementary, {coupled} coupled a session), {mode} core on {transfer}, "
          f"{len(steps)} packets x {frames} frames, post-filter chunks {got['chunks']}, plan "
          f"fallbacks {fallbacks}, kernel launches {launches}; packets whose final ranges "
          f"differ from libopus's: {wrong}; {graph_summary(bmd.core)}; kernel inputs recorded "
          f"from the eager warm-up of packets {recorded_from(captured)}")
    if wrong or fallbacks:
        raise AssertionError(f"{name}: final ranges differ from libopus's after packets "
                             f"{wrong}, or {fallbacks} plan fallbacks")
    real = None
    if mode == "celt":
        label = f"{name} step 1 ({sessions * streams} elementary streams)"
        real = {"postfilter": postfilter_on_real_inputs(captured["postfilter"][0], where, label)}
        if transfer == "plan":
            real["rotation"] = rotation_on_real_chains(captured["rotation"], where, label)
    out = {"launches": launches, "chunks": [], "pf_chunks": got["chunks"], "pcm_err": None,
           "real": real, "final_ring": got["last"], "final_ranges": got["ranges"][-1],
           "sample": got["sample"], "layout": layout, "steps": steps}
    if group != "ambi":
        return out
    plc = check_launches(launches, got["chunks"], len(steps) if transfer == "plan" else 0,
                         [], None)
    if plc or launches["silk_synth"]:
        raise AssertionError(f"{name}: kernel launches {launches}")
    want = ms_serve_steps(make(4, "cpu"), [pk[:4] for pk in steps], frames)
    err = float(np.abs(got["pcm"] - want["pcm"]).max())
    ranges_equal = [r[:4] for r in got["ranges"]] == want["ranges"]
    print(f"{name}: sessions 0-3 vs the port's CPU run: max_abs_err={err}, final ranges equal "
          f"{ranges_equal}")
    if not (err < CPU_PCM_TOL and ranges_equal):
        raise AssertionError(f"{name}: sessions 0-3 off the CPU run ({err}) or ranges differ")
    out["pcm_err"] = err
    return out


def ms_rate(dev, name: str, where: str) -> float:
    """The multistream serve rate as the reference benchmark defines it
    (steps x sessions x 0.02 / s): median of 5 runs of every fixture step
    after a warm-up run, beside the elementary-stream rate."""
    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder

    group, sessions, mode, transfer, _ = MS_PATHS[name]
    (ch, streams, coupled, *mapping), steps, _ = load_ms_group(group, sessions)
    bmd = BatchedMultistreamDecoder(sessions, ch, streams, coupled, mapping, mode=mode,
                                    device=dev)
    bmd.core.transfer = transfer
    bmd.serve(steps, FRAME)  # warm-up
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        bmd.serve(steps, FRAME)
        runs.append(time.perf_counter() - t0)
    if getattr(bmd.core, "plan_fallbacks", 0):
        raise AssertionError(f"{name} steps fell back while timing")
    rates = sorted(len(steps) * sessions * 0.02 / r for r in runs)
    rate = statistics.median(rates)
    print(f"serve e2e {name} sessions={sessions} ({sessions * streams} elementary streams) "
          f"{len(steps)} steps/run: sessions_audio_s_per_s median={rate} runs={rates}; "
          f"elementary_audio_s_per_s median={rate * streams} ({where})")
    return rate


def multichip_serve(steps: list, serve, gather, core) -> dict:
    """One sharded path on this rank: its steps served one a call, with the
    launch counts set to 0 just before and read just after, the plane-A
    call (`core.native.decode_batch_plan_into`) timed, and each step's
    post-filter activity read from the core's plan slot; then the gathered
    ring (`gather()`), final ranges and fallbacks (collectives), the
    gather's ms, and MULTICHIP_RUNS timed runs of every step in one call,
    each started together on every rank.  `core` is the rank's CELT or
    Opus decoder, or the core of its multistream decoder."""
    import torch.distributed as dist

    from opus_tpu_torch.batch.sharded import gather_fallbacks
    from opus_tpu_torch.dsp.tables import pf_chunk_for

    counters = kernel_counters()
    plane_a, chunks = [], []
    native = core.native
    real = native.decode_batch_plan_into

    def timed_plane_a(*args):
        t0 = time.perf_counter()
        try:
            return real(*args)
        finally:
            plane_a.append(time.perf_counter() - t0)

    native.decode_batch_plan_into = timed_plane_a
    try:
        for fn in counters.values():
            fn.launches = 0
        for packets in steps:
            serve([packets])
            s = core._plan_slots[0]
            chunk, active = pf_chunk_for(s["meta"][:, 6:9], s["gains"])
            chunks.append(chunk if active else None)
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        del native.decode_batch_plan_into
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring, ranges = gather()
    ring = ring.cpu().numpy()
    gather_ms = (time.perf_counter() - t0) * 1e3
    out = {"launches": launches, "chunks": chunks, "ring": ring,
           "ranges": ranges, "fallbacks": gather_fallbacks(core),
           "plane_a_ms": statistics.median(plane_a) * 1e3, "gather_ms": gather_ms, "walls": []}
    for _ in range(MULTICHIP_RUNS):
        dist.barrier()
        t0 = time.perf_counter()
        serve(steps)
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
    return out


def multichip_rank(rank: int, world: int, dev, traffic: dict) -> dict:
    """A rank of the multichip phase: its block of each path's batch served
    by the ordinary decoders at spec.local streams with their own plane A,
    gathered by batch/sharded.py; the launch gates held on this rank (the
    post-filter on every step with an active filter, 2 rotations a plan
    step, no other kernel).  Rank 0 keeps the gathered rings; the others
    return their counts and times."""
    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.batch.sharded import gather_final_ranges, gather_ring, gather_sessions
    from opus_tpu_torch.mesh import ShardSpec

    spec = ShardSpec(B, world, rank)
    celt = BatchedCeltDecoder(spec.local, C, transfer="plan", device=dev)
    mixed = BatchedOpusDecoder(spec.local, C, transfer="plan", silk_transfer="internal",
                               device=dev)
    (ch, streams, coupled, *mapping), ms_steps = traffic["multistream"]
    ms_spec = ShardSpec(MS_SESSIONS, world, rank)
    ms = BatchedMultistreamDecoder(ms_spec.local, ch, streams, coupled, mapping, mode="celt",
                                   device=dev)
    ms.core.transfer = "plan"
    out = {
        "multichip-plan": multichip_serve(
            [spec.rows(pk) for pk in traffic["plan"]], lambda steps: celt.serve(steps, FRAME),
            lambda: (gather_ring(celt), gather_final_ranges(celt)), celt),
        "multichip-mixed": multichip_serve(
            [spec.rows(pk) for pk in traffic["mixed"]], mixed.serve,
            lambda: (gather_ring(mixed), gather_final_ranges(mixed)), mixed),
        "multichip-multistream": multichip_serve(
            [ms_spec.rows(pk) for pk in ms_steps], lambda steps: ms.serve(steps, FRAME),
            lambda: (gather_sessions(ms), gather_final_ranges(ms)), ms.core),
    }
    for name, path in out.items():
        print(f"{name} rank {rank} of {world} on {dev}: kernel launches {path['launches']}, "
              f"post-filter chunks {path['chunks']}, plane A ms/step median "
              f"{path['plane_a_ms']}, gather ms {path['gather_ms']}, run walls (s) "
              f"{path['walls']}", flush=True)
        if path["fallbacks"] != [0] * world:
            raise AssertionError(f"{name}: plan fallbacks by rank {path['fallbacks']}")
        if check_launches(path["launches"], path["chunks"], len(path["chunks"]), [], None):
            raise AssertionError(f"{name} rank {rank} concealed")
        if path["launches"]["silk_synth"] or path["launches"]["pvq_search"]:
            raise AssertionError(f"{name} rank {rank}: kernel launches {path['launches']}")
        if rank:
            del path["ring"]
    return out


def multichip_phase(dev, where: str, clean, mixed, paths: dict) -> dict:
    """The sharded paths over every card of the machine: a world of
    torch.cuda.device_count() NCCL ranks, rank r on cuda:r (mesh.run_ranks;
    a failed rank, a failed NCCL start or the deadline raises).  Each
    path's gathered ring must be within MULTICHIP_TOL of the unsharded
    path's ring from this run, with equal final ranges and no plan
    fallback on any rank.  Prints each path's rate with the world size and
    each rank's plane-A ms a step; returns the paths with their launches
    summed over the ranks."""
    from opus_tpu_torch.mesh import run_ranks

    world = torch.cuda.device_count()
    layout, ms_steps, _ = load_ms_group("ambi", MS_SESSIONS)
    traffic = {"plan": clean, "mixed": mixed, "multistream": (layout, ms_steps)}
    print(f"multichip: world {world} (NCCL, rank r on cuda:r) ({where})", flush=True)
    ranks = run_ranks(multichip_rank, world, device="cuda", args=(traffic,),
                      deadline_s=MULTICHIP_DEADLINE_S)
    out = {}
    for name, base, steps in (("multichip-plan", "plan", len(clean)),
                              ("multichip-mixed", "mixed", len(mixed)),
                              ("multichip-multistream", "multistream", len(ms_steps))):
        r0 = ranks[0][name]
        err = float(np.abs(r0["ring"] - paths[base]["final_ring"]).max())
        ranges_equal = r0["ranges"] == paths[base]["final_ranges"]
        streams = MS_SESSIONS if base == "multistream" else B
        runs = sorted(steps * streams * FRAME / 48000.0 / max(r[name]["walls"][i] for r in ranks)
                      for i in range(MULTICHIP_RUNS))
        rate = statistics.median(runs)
        unit = "sessions_audio_s_per_s" if base == "multistream" else "audio_s_per_s"
        print(f"serve e2e {name} world={world} B={streams} {steps} steps/run: {unit} median="
              f"{rate} runs={runs}; plane A ms/step by rank "
              f"{[r[name]['plane_a_ms'] for r in ranks]}; gather ms by rank "
              f"{[r[name]['gather_ms'] for r in ranks]}; |gathered ring - unsharded {base} "
              f"ring| max={err}; final ranges equal {ranges_equal}; plan fallbacks by rank "
              f"{r0['fallbacks']} ({where})")
        if not (err <= MULTICHIP_TOL and ranges_equal):
            raise AssertionError(f"{name}: gathered ring {err} off the unsharded {base} ring, "
                                 f"or final ranges differ")
        launches = {k: sum(r[name]["launches"][k] for r in ranks) for k in r0["launches"]}
        out[name] = {"launches": launches, "chunks": [], "rate": rate, "world": world}
    return out


def tp_inputs() -> tuple:
    """The full-width tp case's inputs as numpy: the reference's example
    planes at B stereo, lm=3 (post-filter periods 15/120/240, gains
    0/0.1875/0.375), and a random decode history and pre-emphasis."""
    from opus_tpu_torch.dryrun import _example_args
    from opus_tpu_torch.dsp.synthesis import DECODE_BUFFER_SIZE, OVERLAP

    rng = np.random.default_rng(TP_SEED)
    mem = (rng.standard_normal((B, C, DECODE_BUFFER_SIZE + OVERLAP)) * 100).astype(np.float32)
    pre = (rng.standard_normal((B, C)) * 10).astype(np.float32)
    return _example_args(B, 3, C), (mem, pre)


def tp_rank(rank: int, world: int, dev) -> dict:
    """A rank of the full-width tp case: its channel of the B stereo
    streams through a channels=1 step for TP_FRAMES frames, the counts set
    to 0 just before and read just after, the channels joined over the tp
    group; then each rank's step timed alone, in turns, and on rank 0 the
    unsharded stereo step's frames and time."""
    import torch.distributed as dist

    from opus_tpu_torch.dryrun import grid_synthesis
    from opus_tpu_torch.dsp.synthesis import make_synthesis_step
    from opus_tpu_torch.mesh import GridSpec, grid_groups, replicas_equal
    from opus_tpu_torch.state import synth_state_from_numpy

    grid = GridSpec(B, C, 1, world, rank)
    groups = grid_groups(1, world)
    args, state = tp_inputs()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    out = grid_synthesis(grid, groups, 3, args, state, device=dev, frames=TP_FRAMES)
    launches = {k: fn.launches for k, fn in counters.items()}
    res = {"launches": launches, "gathered_equal": replicas_equal(out["pcm"], groups[1]),
           "backend": dist.get_backend(), "tp_gather_ms": out["tp_gather_ms"]}
    if rank == 0:
        step = make_synthesis_step(3, False, C, 1, device=dev)
        st = synth_state_from_numpy(*state, dev)
        inputs = [torch.as_tensor(a).to(dev) for a in args]
        whole = []
        for _ in range(TP_FRAMES):
            st, pcm = step(st, *inputs)
            whole.append(pcm)
        res["err"] = float((out["pcm"] - torch.cat(whole, dim=1)).abs().max())
        res["shape"] = tuple(out["pcm"].shape)
        res["finite"] = bool(torch.isfinite(out["pcm"]).all())
    for r in range(world):  # one rank on the card at a time
        dist.barrier()
        if r == rank:
            res["ms"] = cuda_ms(out["step"], TP_REPS)
            if rank == 0:
                res["unsharded_ms"] = cuda_ms(lambda: step(st, *inputs), TP_REPS)
        torch.cuda.synchronize()
    return res


def grid_launches(ranks: list) -> dict:
    """A path's launches, summed over its ranks (every kernel's count)."""
    return {k: sum(r["launches"][k] for r in ranks) for k in kernel_counters()}


def grid_phase(where: str) -> dict:
    """The dry run's dp x tp grid and the full-width tp case, each as ranks
    sharing cuda:0 under gloo (run_ranks' ranks_per_card; NCCL refuses two
    ranks on one card).  Gates: every phase of the dry run (its own), the
    post-filter and rotation launched on every rank of the grid; the tp
    case's gathered frames within MULTICHIP_TOL of the unsharded step,
    equal on both ranks, and the post-filter launched once a frame on each
    rank.  Prints each rank's launches, its step's device ms, the gathers'
    ms and the backend."""
    from opus_tpu_torch.dryrun import dryrun_multichip
    from opus_tpu_torch.mesh import run_ranks

    out = {}
    for world in GRID_WORLDS:
        res = dryrun_multichip(world, device="cuda", ranks_per_card=world)
        name = f"grid-{res['dp']}x{res['tp']}"
        for r, rank in enumerate(res["ranks"]):
            print(f"{name} rank {r} ({rank['device']}, {res['backend']}): kernel launches "
                  f"{rank['launches']}, CELT step device ms (warm, the ranks at once) "
                  f"{rank['celt_step_ms']}, tp gather "
                  f"ms {rank['tp_gather_ms']}, dp gather ms {rank['dp_gather_ms']} ({where})",
                  flush=True)
            if not (rank["launches"]["postfilter"] and rank["launches"]["rotation"]):
                raise AssertionError(f"{name} rank {r}: kernel launches {rank['launches']}")
        out[name] = {"launches": grid_launches(res["ranks"]), "chunks": []}
    print(f"tp-full: the synthesis step at B={B} stereo lm=3 over 2 ranks sharing cuda:0, "
          f"{TP_FRAMES} frames ({where})", flush=True)
    ranks = run_ranks(tp_rank, 2, device="cuda", ranks_per_card=2,
                      deadline_s=MULTICHIP_DEADLINE_S)
    r0 = ranks[0]
    for r, rank in enumerate(ranks):
        print(f"tp-full rank {r} (channel {r}, {rank['backend']}): kernel launches "
              f"{rank['launches']}, channels=1 step device ms {rank['ms']}, tp gather ms "
              f"{rank['tp_gather_ms']} ({where})", flush=True)
        want = {k: TP_FRAMES if k == "postfilter" else 0 for k in rank["launches"]}
        if rank["launches"] != want or not rank["gathered_equal"]:
            raise AssertionError(f"tp-full rank {r}: launches {rank['launches']}, gathered "
                                 f"frames equal on the ranks {rank['gathered_equal']}")
    print(f"tp-full: gathered {r0['shape']} |split - unsharded| max={r0['err']}; unsharded "
          f"stereo step device ms {r0['unsharded_ms']} ({where})", flush=True)
    if not (r0["finite"] and r0["shape"] == (B, TP_FRAMES * 960, C)
            and r0["err"] <= MULTICHIP_TOL):
        raise AssertionError(f"tp-full: {r0['shape']} finite {r0['finite']}, off the unsharded "
                             f"step by {r0['err']}")
    out["tp-full"] = {"launches": grid_launches(ranks), "chunks": []}
    return out


def pvq_inputs(seed: int, batch: int, channels: int, dev):
    """Synthetic pvq_search inputs at the encode plane's shapes (N2 = 960,
    P = 160 leaf rows a stream): random spans, band ops and leaves (planes
    -1..2 and offsets past both ends, which the gather clamps; rows 140-159
    unused, n = 0, with garbage), and in streams 0-7 the edge cases: n = 1,
    2, 3, 176 with K below and above n / 2 (stream 0); all-zero spans (1);
    spans whose sum |x| is below 1e-15 (2) or at least 64 (3), where the
    prefill collapses |x| to e1; equal |x| everywhere, ties (4); K = 200 on
    n = 176, one leaf's prefill leaving 148 pulses, so that 128 trips leave
    20 unplaced (5); every band mid/side (6) or an intensity mix (7).
    Stream 0 also holds a leaf at each edge of the kernel's width classes
    (n = 1, 8, 9, 16, 17, 32, 33, 64, 65, 176), with K below and above n / 2,
    on both planes.  Returns [x, band_ops, leaves] on `dev`."""
    rng = np.random.default_rng(seed)
    n2, P = 960, ENC_P_MAX
    x = (rng.standard_normal((batch, channels, n2)) * 0.1).astype(np.float32)
    ops = np.zeros((batch, 21, 4), np.float32)
    ops[:, :, 0] = rng.integers(0, 4, (batch, 21))
    th = rng.uniform(0, np.pi / 2, (batch, 21))
    ops[:, :, 1] = np.cos(th)
    ops[:, :, 2] = np.sin(th) * rng.choice([-1.0, 1.0], (batch, 21))
    n = rng.integers(1, 177, (batch, P))
    lv = np.stack([rng.integers(-1, 3, (batch, P)), rng.integers(-8, n2, (batch, P)), n,
                   np.minimum(128, 1 + (rng.uniform(0, 1.5, (batch, P)) * n).astype(int))],
                  -1).astype(np.int32)
    lv[:, 140:, 2] = 0

    def put(b, leaves):
        lv[b, : len(leaves)] = leaves

    sizes = [(1, 1), (1, 3), (2, 1), (2, 2), (2, 5), (3, 1), (3, 2), (3, 7), (176, 40),
             (176, 88), (176, 89), (176, 128)]
    edges = [(nn, k) for nn in pvq_edges() for k in (max(1, nn // 4), min(128, nn // 2 + 1))]
    put(0, [(p, 200 + 7 * i, nn, k) for i, (nn, k) in enumerate(sizes + edges)
            for p in (0, 1)])
    x[1, :, :300] = 0.0
    put(1, [(p, o, nn, k) for p in (0, 1) for o, nn, k in
            ((0, 176, 100), (5, 176, 30), (60, 64, 40), (100, 7, 1), (120, 2, 2))])
    x[2, :, 300:600] = rng.standard_normal((channels, 300)) * 3e-18
    put(2, [(p, 300 + o, nn, k) for p in (0, 1) for o, nn, k in
            ((0, 176, 100), (10, 64, 40), (40, 176, 20), (90, 16, 3))])
    x[3, :, 600:] = rng.uniform(0.5, 1.0, (channels, 360)) * rng.choice([-1.0, 1.0],
                                                                          (channels, 360))
    put(3, [(p, 600 + o, nn, k) for p in (0, 1) for o, nn, k in
            ((0, 176, 100), (100, 100, 60), (180, 176, 128), (20, 100, 30))])
    x[4] = 0.25 * rng.choice([-1.0, 1.0], (channels, n2))
    ops[5, :, 0] = 0.0
    span = np.full(176, 0.99 * 10.0 / 200.8)  # sum 10: rcp * |x| = 0.99 or 2.0115
    span[rng.permutation(176)[:26]] = 2.0115 * 10.0 / 200.8
    x[5, 0, :176] = span * rng.choice([-1.0, 1.0], 176)
    put(5, [(0, 0, 176, 200), (0, 200, 176, 200), (1, 400, 176, 200), (1, 0, 176, 128)])
    ops[6, :, 0] = 2.0
    ops[7, :, 0] = 3.0
    return [torch.tensor(a, device=dev) for a in (x, ops, lv)]


def pvq_edges() -> list:
    """The leaf widths at the edges of pvq_search's width classes (the least
    and greatest n of each) and of the widest class's slots (64, 65)."""
    from opus_tpu_torch.dsp.pvq_search import LANES, class_ranges

    return sorted({n for r in class_ranges(ENC_N_MAX) for n in r} | {2 * LANES, 2 * LANES + 1})


def pvq_one_class(seed: int, batch: int, channels: int, cls: int, dev):
    """pvq_inputs with every used leaf's n drawn anew inside width class
    `cls` of pvq_search's class_ranges, K drawn as pvq_inputs draws it: a
    batch in which every other class is empty."""
    from opus_tpu_torch.dsp.pvq_search import class_ranges

    x, ops, lv = (t.numpy() for t in pvq_inputs(seed, batch, channels, "cpu"))
    rng = np.random.default_rng(seed + 1000)
    lo, hi = class_ranges(ENC_N_MAX)[cls]
    used = lv[..., 2] > 0
    n = rng.integers(lo, hi + 1, used.shape)
    lv[..., 3] = np.where(used, np.minimum(128, 1 + (rng.uniform(0, 1.5, n.shape) * n)
                                           .astype(int)), lv[..., 3])
    lv[..., 2] = np.where(used, n, 0)
    return [torch.tensor(a, device=dev) for a in (x, ops, lv)]


def check_pvq(x, ops, leaves, label: str) -> dict:
    """pvq_search vs its plain version: the packed int16 iy equal, pulse for
    pulse, and left equal on every row.  Returns the rows, the leaves by
    width class, the trips the leaves need and the unplaced pulses."""
    from opus_tpu_torch.dsp.pvq_search import (_prefill, _pvq_search_ref, class_ranges,
                                               leaf_order, pvq_search, unpack)

    order = leaf_order(leaves.cpu().numpy(), ENC_N_MAX)
    iy, left = pvq_search(x, ops, leaves, order)
    want_pad, want_left = _pvq_search_ref(x, ops, leaves)
    trips = _prefill(x, ops, leaves, 3, ENC_N_MAX)[4].clamp(0, ENC_T_MAX)
    torch.cuda.synchronize()
    if iy.dtype != torch.int16 or tuple(iy.shape) != (order.total,):
        raise AssertionError(f"pvq_search gave iy {iy.dtype} {tuple(iy.shape)}, not int16 "
                             f"({order.total},) ({label})")
    diff = (int((unpack(iy, leaves) != want_pad).any(-1).sum())
            + int((left != want_left).sum()))
    valid = int((leaves[..., 2] > 0).sum())
    out = {"rows": leaves.shape[0] * leaves.shape[1], "valid": valid, "classes": order.counts,
           "max_trips": int(trips.max()), "trips": int(trips.sum()),
           "unplaced": int(left.sum()), "pulses": int(iy.abs().sum()), "iy_bytes": iy.numel() * 2}
    print(f"kernel pvq_search {label}: x {tuple(x.shape)}, {out['rows']} rows ({valid} leaves; "
          f"by width class {class_ranges(ENC_N_MAX)}: {order.counts}), {out['pulses']} pulses "
          f"in {out['iy_bytes']} B packed, trips needed {out['trips']} (longest "
          f"{out['max_trips']}), unplaced after {ENC_T_MAX} trips {out['unplaced']}; rows "
          f"differing from the plain version: {diff}")
    if diff:
        raise AssertionError(f"pvq_search differs from its plain version on {diff} rows "
                             f"({label})")
    return out


def pvq_phase(dev, where: str) -> None:
    """pvq_search vs its plain version on the synthetic leaves, stereo and
    mono (in both, the K = 200 leaves must leave pulses unplaced), then on a
    batch of each width class alone, stereo and mono."""
    from opus_tpu_torch.dsp.pvq_search import class_ranges

    for seed, channels in ((60, 2), (61, 1)):
        got = check_pvq(*pvq_inputs(seed, 64, channels, dev), f"synthetic C={channels}")
        if got["unplaced"] == 0:
            raise AssertionError(f"the synthetic leaves (C={channels}) left no pulse unplaced")
    for cls, (lo, hi) in enumerate(class_ranges(ENC_N_MAX)):
        for channels in (2, 1):
            got = check_pvq(*pvq_one_class(62 + cls, 16, channels, cls, dev),
                            f"synthetic n {lo}-{hi} only, C={channels}")
            if sum(1 for c in got["classes"] if c) != 1:
                raise AssertionError(f"the n {lo}-{hi} batch spans classes {got['classes']}")


def music_pcm(batch: int, steps: int, seed: int = 9) -> np.ndarray:
    """[steps, batch, 960, 2] float32 music-like PCM: stream i a tone of
    220 Hz x 2^((i % 24) / 12) and a 3 kHz partial with noise, the right
    channel 13 samples late (the reference's encode benchmark's signal,
    tools/tpu_encbench.py, with one tone a stream), scaled to 0.5-1.0 of
    full amplitude across the batch; the last stream all zero."""
    rng = np.random.default_rng(seed)
    f0 = 220.0 * 2.0 ** ((np.arange(batch) % 24) / 12.0)
    t = np.arange(steps * FRAME + 13) / 48000.0
    sig = (0.4 * np.sin(2 * np.pi * f0[:, None] * t + rng.uniform(0, 2 * np.pi, (batch, 1)))
           + 0.2 * np.sin(2 * np.pi * 3000.0 * t)
           + 0.05 * rng.standard_normal((batch, t.size)))
    sig *= (0.5 + 0.5 * np.arange(batch) / batch)[:, None]
    sig[-1] = 0.0
    pcm = np.stack([sig[:, 13:], sig[:, :-13]], -1).astype(np.float32)
    return pcm.reshape(batch, steps, FRAME, 2).transpose(1, 0, 2, 3)


def best_snr(decoded: np.ndarray, ref: np.ndarray) -> float:
    """SNR (dB) of the decoded channel mean against the input's, at the
    best delay of 0-399 samples, after the first frame."""
    r = ref.mean(-1).astype(np.float64)
    g = decoded.mean(-1).astype(np.float64)
    n = len(r) - 400
    best = -1e9
    for lag in range(400):
        e = r[FRAME:n] - g[FRAME + lag : n + lag]
        best = max(best, 10 * np.log10((r[FRAME:n] ** 2).sum() / max((e ** 2).sum(), 1e-12)))
    return best


def pvq_bytes(x, ops, leaves) -> dict:
    """Bytes pvq_search must move for these inputs, by part: the positions
    of x its leaves cover (every channel plane), the band ops of the
    streams with a leaf, the used rows of the leaf table, the row list
    with the starts, the packed int16 iy and left ([B, P] int32, 0 on the
    unused rows) written."""
    from opus_tpu_torch.dsp.pvq_search import leaf_order

    B, C, n2 = x.shape
    lv = leaves.cpu().numpy().astype(np.int64)
    order = leaf_order(lv, ENC_N_MAX)
    b, p = np.nonzero(lv[..., 2] > 0)
    off, n = lv[b, p, 1], lv[b, p, 2]
    cover = np.zeros((B, n2 + 1), np.int64)  # +1 at a span's start, -1 past its end
    np.add.at(cover, (b, np.clip(off, 0, n2)), 1)
    np.add.at(cover, (b, np.clip(off + n, 0, n2)), -1)
    covered = int((np.cumsum(cover, axis=1)[:, :n2] > 0).sum())
    parts = {"x": covered * C * 4, "band_ops": len(np.unique(b)) * 21 * 16,
             "leaf_rows": len(b) * 16, "row_list": order.rows.nbytes, "iy": order.total * 2,
             "left": lv.shape[0] * lv.shape[1] * 4}
    return {"needed": sum(parts.values()), "parts": parts}


def pvq_times(x, ops, leaves, need: dict) -> dict:
    """ms of the wrapper, the bare kernel launch on C arguments prepared in
    advance (also as one replay of a CUDA graph, and with the L2 flushed
    before each launch) and the plain version (packed), with the bound:
    the bytes these inputs need (pvq_bytes) over the HBM rate, or the
    longest leaf's trips (need["max_trips"]) at PVQ_TRIP_CYCLES each,
    whichever is larger.  Two output copies alternate; but for the flushed
    time the inputs are read from the L2, where they fit (about 10 MB at
    B = 1,024: x at the covered positions is most of it) and where the
    encode step leaves them."""
    from opus_tpu_torch import _build
    from opus_tpu_torch.dsp import pvq_search as pq

    order = pq.leaf_order(leaves.cpu().numpy(), ENC_N_MAX)
    rows = torch.from_numpy(order.rows).to(x.device)
    outs = [(torch.empty(order.total, dtype=torch.int16, device=x.device),
             torch.empty(leaves.shape[:2], dtype=torch.int32, device=x.device)) for _ in range(2)]
    prepared = [pq._kernel_args(x, ops, leaves, rows, order, iy, left, 3, ENC_T_MAX)
                for iy, left in outs]
    nbytes = pvq_bytes(x, ops, leaves)
    bound, by = chain_bound_ms(nbytes["needed"], need["max_trips"] * PVQ_TRIP_CYCLES)

    def plain():
        iy, left = pq._pvq_search_ref(x, ops, leaves)
        return pq.pack(iy, leaves), left

    lib = _build.library().opus_pvq_search
    return {"ms": best_ms(lambda: pq.pvq_search(x, ops, leaves, order.on(rows)), 10),
            "kernel_ms": best_ms(bare("opus_pvq_search", prepared), 10),
            "kernel_l2_flushed_ms": l2_flushed_ms(lib, prepared, 10),
            "graph_ms": graph_ms(lib, prepared, 10),
            "plain_ms": cuda_ms(plain, 1),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes["needed"],
            "bytes_parts": nbytes["parts"],
            "bytes_ms": nbytes["needed"] / HBM_BYTES_PER_S * 1e3,
            "chain_ms": need["max_trips"] * PVQ_TRIP_CYCLES / CLOCK_HZ * 1e3}


def encode_path(dev, where: str) -> dict:
    """The encode plane's main path: BatchedPlanEncoder(B, 2, 96000) on the
    card for ENC_STEPS steps of music_pcm (the first a warm-up), with the
    launch counts set to 0 just before and read just after: one pvq_search
    launch a step.  Every packet must be 240 bytes; each step's packets are
    served (ToC stripped) by the port's BatchedCeltDecoder(B, 2,
    transfer="plan"), whose final ranges must all equal the encoder's;
    streams 0-3 are decoded by the port's scalar CeltDecoder (equal final
    ranges) and their SNR against the input must lie within ENC_SNR_TOL_DB
    of the port's CPU run of the same PCM at B=4.  The search's inputs of
    the first step are recorded: the kernel must equal its plain version on
    all B x 160 rows, and the uploaded row list must be the table's
    leaf_order.  Prints the rate end to end (host clock around encode_step,
    median of the timed steps), the host ms a step by phase, the device plane
    (analyze + search on resident inputs, CUDA events), the packed iy
    download and the kernel's times and bound."""
    from opus_tpu_torch.batch.encode_pipeline import BatchedPlanEncoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.celt.decoder import CeltDecoder
    from opus_tpu_torch.dsp.pvq_search import leaf_order

    pcm = music_pcm(B, ENC_STEPS)
    enc = BatchedPlanEncoder(B, C, 96000, device=dev)
    dec = BatchedCeltDecoder(B, C, transfer="plan", device=dev)
    rec = {}
    real_search = enc._srch

    def search(x, ops, leaves, order):
        if not rec:
            rec.update(x=x.clone(), ops=ops.clone(), leaves=leaves.clone(),
                       order=order.on(order.device_rows.clone()))
        return real_search(x, ops, leaves, order)

    enc._srch = search
    counters = kernel_counters()
    walls, phases, packets = [], [], []
    for fn in counters.values():
        fn.launches = 0
    for step in pcm:
        t0 = time.perf_counter()
        pk = enc.encode_step(step)
        walls.append(time.perf_counter() - t0)
        phases.append(enc.step_ms)
        ranges = enc.final_ranges()
        sizes = {len(p) for p in pk}
        if sizes != {NBYTES}:
            raise AssertionError(f"encode: packet sizes {sizes}, not {NBYTES} bytes")
        dec.serve([[p[1:] for p in pk]], FRAME)
        got = dec.final_ranges()
        wrong = [i for i in range(B) if got[i] != ranges[i]]
        if wrong:
            raise AssertionError(f"encode step {len(packets)}: {len(wrong)} decoder final ranges "
                                 f"differ from the encoder's (streams {wrong[:8]})")
        packets.append(pk)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"main path encode: B={B} stereo 96 kbps, {ENC_STEPS} steps, every packet {NBYTES} "
          f"B, all {B} plan-decoder final ranges equal to the encoder's on every step "
          f"(decoder plan fallbacks {dec.plan_fallbacks}), kernel launches {launches}, host "
          f"fallback streams by step {[p['fallback_streams'] for p in phases]}")
    if launches["pvq_search"] != ENC_STEPS:
        raise AssertionError(f"encode: pvq_search launched {launches['pvq_search']} times over "
                             f"{ENC_STEPS} steps")

    cpu = BatchedPlanEncoder(ENC_CPU_STREAMS, C, 96000, device="cpu")
    cpu_packets = [cpu.encode_step(step[:ENC_CPU_STREAMS]) for step in pcm]
    snr = []
    for i in range(ENC_CPU_STREAMS):
        out = {}
        for name, pks in (("card", [p[i] for p in packets]), ("cpu", [p[i] for p in cpu_packets])):
            d = CeltDecoder(C)
            out[name] = np.concatenate([d.decode(p[1:], FRAME) for p in pks])
            if name == "card" and d.final_range != enc.final_ranges()[i]:
                raise AssertionError(f"encode stream {i}: the scalar decoder's final range "
                                     f"differs from the encoder's")
        ref = pcm[:, i].reshape(-1, C)
        s_card, s_cpu = best_snr(out["card"], ref), best_snr(out["cpu"], ref)
        same = sum(a[i] == b[i] for a, b in zip(packets, cpu_packets))
        print(f"encode stream {i}: scalar decoder final range equal; SNR card {s_card} dB, CPU "
              f"run {s_cpu} dB; packets equal to the CPU run's on {same} of {ENC_STEPS} steps")
        if not abs(s_card - s_cpu) <= ENC_SNR_TOL_DB:
            raise AssertionError(f"encode stream {i}: SNR {s_card} dB vs the CPU run's {s_cpu}")
        snr.append(s_card)

    real = check_pvq(rec["x"], rec["ops"], rec["leaves"], f"recorded encode step 0 (B={B})")
    want, got = leaf_order(rec["leaves"].cpu().numpy(), ENC_N_MAX), rec["order"]
    if not (np.array_equal(got.device_rows.cpu().numpy(), want.rows)
            and got.counts == want.counts and got.total == want.total):
        raise AssertionError("encode: the row list the encoder uploaded is not its leaf "
                             "table's leaf_order")
    timed = walls[1:]
    rate = B * FRAME / 48000.0 / statistics.median(timed)
    host = {k: statistics.median(p[k] for p in phases[1:])
            for k in ("plan", "emit", "fallback", "analyze_and_download",
                      "search_and_iy_download")}
    print(f"encode e2e B={B} stereo 96 kbps: audio_s_per_s median={rate} over steps 1-"
          f"{ENC_STEPS - 1} (s a step {timed}); host ms a step (median): {host} ({where})")

    pcm_d = torch.from_numpy(np.ascontiguousarray(pcm[1])).to(dev)
    im, pm = enc._in_mem.clone(), enc._pm.clone()
    x, ops, leaves, order = rec["x"], rec["ops"], rec["leaves"], rec["order"]
    dev_ms = cuda_ms(lambda: real_search(enc._ana(pcm_d, im, pm)[0], ops, leaves, order), 10)
    iy = real_search(x, ops, leaves, order)[0]
    pinned = torch.empty(iy.shape, dtype=iy.dtype, pin_memory=True)
    iy_ms = cuda_ms(lambda: pinned.copy_(iy, non_blocking=True), 10)
    t = pvq_times(x, ops, leaves, real)
    print(f"encode device plane B={B}: analyze + search on resident inputs {dev_ms} ms a step "
          f"(CUDA events) = {B * 0.02 / dev_ms * 1e3} audio_s_per_s; iy download (packed int16, "
          f"{iy.numel() * iy.element_size()} B into pinned memory, one copy) {iy_ms} ms "
          f"({where})")
    print(f"time pvq_search recorded step (B={B}, 160 rows a stream, leaves by width class "
          f"{real['classes']}): wrapper_ms={t['ms']} kernel_alone_ms={t['kernel_ms']} "
          f"cuda_graph_ms_per_launch={t['graph_ms']} plain_ms={t['plain_ms']} bound_ms="
          f"{t['bound_ms']} ({t['bound_by']}; bytes needed {t['bytes']} {t['bytes_parts']} -> "
          f"{t['bytes_ms']} ms; longest leaf {real['max_trips']} trips x {PVQ_TRIP_CYCLES} "
          f"cycles -> {t['chain_ms']} ms) share_of_bound={t['bound_ms'] / t['kernel_ms']}; "
          f"with the L2 flushed first: kernel_l2_flushed_ms={t['kernel_l2_flushed_ms']} "
          f"share_of_bound={t['bound_ms'] / t['kernel_l2_flushed_ms']}; the padded kernel's "
          f"recorded {PVQ_PADDED_RECORDED_MS} ms (inputs beyond the L2; not measured here) "
          f"against the same bound: share {t['bound_ms'] / PVQ_PADDED_RECORDED_MS} ({where})")
    return {"launches": launches, "chunks": [], "rate": rate, "host_ms": host,
            "dev_ms": dev_ms, "iy_ms": iy_ms, "iy_bytes": iy.numel() * iy.element_size(),
            "times": t, "real": real, "snr": snr}


def packet_kind(pkt: bytes) -> str:
    """The kind of a packet's stream from its ToC: "celt stereo", "silk mono" ..."""
    from opus_tpu_torch import query_packet_channel_count, query_packet_codec_mode

    mode = query_packet_codec_mode(pkt).name.split("_")[0].lower()
    return f"{mode} {query_packet_channel_count(pkt).name.lower()}"


def hold_to_scalar(name: str, sample: dict, columns: list, gate: bool, where: str = "",
                   make=None, kind=packet_kind) -> dict:
    """Decode each sampled stream's packets again with the port's scalar
    decoder (`make()`; by default Decoder at 48 kHz stereo; columns[j] are
    stream sample["rows"][j]'s packets, None where lost) and hold the
    device run to it: the final range after every decoded packet, PCM
    max-abs and the RFC 8251 score over the stream's frames.  With `gate`,
    a range that differs, an error of LIBRARY_TOL or more or a score below
    PASS_QUALITY raises.  Returns the worst error, the lowest score, the
    ranges that were equal and the scalar ms a frame by kind."""
    from opus_tpu_torch import Decoder, DecoderConfiguration
    from opus_tpu_torch.conformance import PASS_QUALITY, compare

    make = make or (lambda: Decoder(DecoderConfiguration()))
    secs, frames = {}, {}
    errs, scores, wrong, decoded = [], [], [], 0
    for j, (row, col) in enumerate(zip(sample["rows"], columns)):
        dec = make()
        k = kind(next(p for p in col if p is not None))
        out = []
        for f, pkt in enumerate(col):
            t0 = time.perf_counter()
            out.append(dec.decode(pkt, FRAME))
            secs[k] = secs.get(k, 0.0) + time.perf_counter() - t0
            frames[k] = frames.get(k, 0) + 1
            if pkt is not None:
                decoded += 1
                if dec.final_range != sample["ranges"][f][j]:
                    wrong.append((row, f))
        ref, got = np.concatenate(out), sample["pcm"][j]
        errs.append(float(np.abs(got - ref).max()))
        scores.append(compare(ref, got))
    j_err, j_score = int(np.argmax(errs)), int(np.argmin(scores))
    ms = {k: secs[k] / frames[k] * 1e3 for k in secs}
    print(f"library {name}: {len(columns)} streams (rows {sample['rows']}) x {len(columns[0])} "
          f"steps against the port's scalar decoder: final ranges equal after "
          f"{decoded - len(wrong)} of {decoded} decoded packets (differing: {wrong[:8]}), worst "
          f"max_abs_err={errs[j_err]} (row {sample['rows'][j_err]}), lowest RFC 8251 score="
          f"{scores[j_score]} (row {sample['rows'][j_score]}); scalar decode ms a frame by "
          f"kind {ms} ({'gated' if gate else 'recorded, not gated'}; {where})")
    if gate and (wrong or errs[j_err] >= LIBRARY_TOL or scores[j_score] < PASS_QUALITY):
        raise AssertionError(f"library {name}: the device decoder is off the port's scalar "
                             f"decoder (ranges differ at {wrong[:8]}, max abs {errs[j_err]}, "
                             f"score {scores[j_score]})")
    return {"worst_err": errs[j_err], "lowest_score": scores[j_score],
            "ranges_equal": decoded - len(wrong), "decoded": decoded, "ms_by_kind": ms}


def cli_signals() -> dict:
    """The CLI phase's 4 s inputs: music, the signal of the encoder's SNR
    floor (tests/test_encoder.py `_sig`: 440 and 1870 Hz tones and noise,
    the right channel 0.8 x, 5 samples late), and mono 16 kHz speech-like
    pulses (`voice`, 140 Hz)."""
    rng = np.random.default_rng(21)
    n = 48000 * CLI_SECONDS
    t = np.arange(n) / 48000
    s = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.15 * np.sin(2 * np.pi * 1870 * t)
         + 0.05 * rng.standard_normal(n))
    music = np.stack([s, 0.8 * np.roll(s, 5)], -1)
    speech = np.concatenate([voice(np.array([140.0]), np.array([0]), 16000, f, rng)[0]
                             for f in range(50 * CLI_SECONDS)])[:, None]
    return {"music": music, "speech": speech}


def write_wav(path, pcm: np.ndarray, rate: int) -> np.ndarray:
    """Write 16-bit PCM; returns the float samples the CLI reads back."""
    import wave

    q = np.round(np.clip(pcm, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(q.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(q.tobytes())
    return q.astype(np.float32) / 32768.0


def read_wav(path) -> tuple[np.ndarray, int]:
    import wave

    with wave.open(str(path), "rb") as w:
        raw, ch, rate = w.readframes(w.getnframes()), w.getnchannels(), w.getframerate()
    return np.frombuffer(raw, np.int16).reshape(-1, ch), rate


def run_cli(workdir: pathlib.Path, case: str, results: dict) -> None:
    """`python3 -m opus_tpu_torch` on one CLI case in `workdir`: encode, then
    info and decode together, a subprocess each; results[(case, command)] =
    (return code, stdout, stderr, wall s).  Runs on a thread of its own
    beside the other case and the scalar decodes; a process still running
    when this returns (a timeout) is killed."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    opts = CLI_CASES[case][2]
    procs = []
    try:
        for group in ([["encode", f"{case}.wav", f"{case}.opus", *opts]],
                      [["info", f"{case}.opus"], ["decode", f"{case}.opus", f"{case}.out.wav"]]):
            procs = [(args[0], time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "opus_tpu_torch", *args], cwd=workdir, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)) for args in group]
            for cmd, t0, proc in procs:
                out, err = proc.communicate(timeout=300)
                results[case, cmd] = (proc.returncode, out, err, time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001  (raised again by check_cli on the main thread)
        results["error"] = e
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def check_cli(workdir: pathlib.Path, results: dict, inputs: dict, where: str) -> dict:
    """Gate the CLI round trip: every command exits 0; the Ogg file reads
    back (every page's CRC) with the head that was written and the packet
    count and bytes `info` printed; an in-process Encoder of the same
    session writes the same packets on a native encoder, and the port's
    Decoder reads each to the encoder's final range and to the samples of
    the decoded WAV, which holds the input's whole frames; the music SNR
    after the 120-sample codec delay (from sample 4800, as the floor's
    test) is above CLI_SNR_DB; the speech SNR is printed."""
    from opus_tpu_torch import Channels, Decoder, DecoderConfiguration, SamplingRate
    from opus_tpu_torch.encoder import Encoder, EncoderConfiguration
    from opus_tpu_torch.ogg import OggOpusReader, OpusHead

    if "error" in results:
        raise results["error"]
    walls, enc_ms, dec_ms, snrs = {}, {}, {}, {}
    for case, (rate, ch, opts) in CLI_CASES.items():
        for cmd in ("encode", "info", "decode"):
            rc, out, err, wall = results[case, cmd]
            walls[f"{case} {cmd}"] = wall
            print(f"library cli {case} {cmd}: rc {rc}, {wall} s: {out.strip()}")
            if rc != 0:
                raise AssertionError(f"python3 -m opus_tpu_torch {cmd} ({case}) exited {rc}: "
                                     f"{err[-2000:]}")
        reader = OggOpusReader((workdir / f"{case}.opus").read_bytes())
        packets = reader.packets[2:]
        if reader.packets[0] != OpusHead(channels=ch, pre_skip=0,
                                         input_sample_rate=rate).to_bytes():
            raise AssertionError(f"cli {case}: head {reader.head} is not the one written")
        info = results[case, "info"][1]
        if f"packets: {len(packets)}, bytes: {sum(map(len, packets))}," not in info:
            raise AssertionError(f"cli {case}: info printed {info!r} for {len(packets)} packets")
        app = "voice" if "voice" in opts else "music"
        bitrate = int(opts[opts.index("--bitrate") + 1])
        enc = Encoder(EncoderConfiguration(SamplingRate(rate), Channels(ch), bitrate,
                                           application=app, vbr="--vbr" in opts, bandwidth="FB"))
        if enc._native_enc is None:
            raise AssertionError(f"cli {case}: the Encoder runs the Python {app} encoder")
        dec = Decoder(DecoderConfiguration(SamplingRate.HZ_48000, Channels(ch)))
        pcm = inputs[case]
        frame = rate // 50
        n = len(pcm) // frame
        if len(packets) != n:
            raise AssertionError(f"cli {case}: {len(packets)} packets for {n} frames")
        out, t_enc, t_dec = [], 0.0, 0.0
        for i in range(n):
            t0 = time.perf_counter()
            pkt = enc.encode(pcm[i * frame : (i + 1) * frame])
            t1 = time.perf_counter()
            out.append(dec.decode_float(pkt, 5760))
            t_dec += time.perf_counter() - t1
            t_enc += t1 - t0
            if pkt != packets[i] or dec.final_range != enc.final_range:
                raise AssertionError(f"cli {case}: packet {i} differs from the file's, or the "
                                     f"decoder's final range {dec.final_range} is not the "
                                     f"encoder's {enc.final_range}")
        enc_ms[f"{app} {Channels(ch).name.lower()}"] = t_enc / n * 1e3
        dec_ms[case] = t_dec / n * 1e3
        y = np.concatenate(out)
        wav, wav_rate = read_wav(workdir / f"{case}.out.wav")
        if wav_rate != 48000 or wav.shape != (n * 960, ch) or not np.array_equal(
                wav, (np.clip(y, -1, 1) * 32767).astype(np.int16)):
            raise AssertionError(f"cli {case}: the decoded WAV ({wav.shape} at {wav_rate} Hz) is "
                                 f"not the Decoder's {n} frames")
        x = pcm.astype(np.float64)
        if rate == 48000:
            ref, got = x[: len(y) - CLI_DELAY], y[CLI_DELAY:].astype(np.float64)
            err = got[4800:] - ref[4800:]
            snrs[case] = float(10 * np.log10((ref[4800:] ** 2).sum() / (err ** 2).sum()))
        else:  # 16 kHz speech against every third sample of the 48 kHz output
            snrs[case] = float(best_snr(y[::3, :1], x[: len(y) // 3]))
    print(f"library cli: SNR dB {snrs} (music gated above {CLI_SNR_DB}; speech recorded, "
          f"at its best delay); encode ms a frame {enc_ms}; decode ms a frame {dec_ms}; walls "
          f"s {walls} ({where})")
    if not snrs["music"] > CLI_SNR_DB:
        raise AssertionError(f"cli music: SNR {snrs['music']} dB is not above {CLI_SNR_DB}")
    return {"walls": walls, "encode_ms": enc_ms, "decode_ms": dec_ms, "snr": snrs}


def encode_kinds(where: str) -> dict:
    """Every Encoder session kind the library serves, 1 s each: it must run
    on a native encoder, and the port's Decoder must read every coded packet
    to the encoder's final range.  Returns the encode ms a frame by kind."""
    from opus_tpu_torch import Channels, Decoder, DecoderConfiguration, SamplingRate
    from opus_tpu_torch.encoder import Encoder, EncoderConfiguration

    x = cli_signals()["music"][:48000].astype(np.float32)
    ms = {}
    for kind, app, ch, bitrate, opts in ENCODE_KINDS:
        enc = Encoder(EncoderConfiguration(SamplingRate.HZ_48000, Channels(ch), bitrate,
                                           application=app, **opts))
        if enc._native_enc is None:
            raise AssertionError(f"encode {kind}: the Encoder runs its Python encoder")
        dec = Decoder(DecoderConfiguration(SamplingRate.HZ_48000, Channels(ch)))
        secs = 0.0
        for i in range(50):
            t0 = time.perf_counter()
            pkt = enc.encode(x[i * 960 : (i + 1) * 960, :ch])
            secs += time.perf_counter() - t0
            dec.decode_float(pkt, 960)
            if dec.final_range != enc.final_range:
                raise AssertionError(f"encode {kind}: frame {i}'s final range differs")
        ms[kind] = secs / 50 * 1e3
    print(f"library encode: native encoder on every session kind, every final range equal to "
          f"the port's Decoder's; encode ms a frame {ms} ({where})")
    return ms


def library_phase(paths: dict, traffic: dict, where: str) -> dict:
    """The codec library on the card's host.  The sampled streams of the
    plan and mixed paths (LIBRARY_ROWS of B) and LIBRARY_SESSIONS sessions
    of the multistream path are decoded again by the port's scalar Decoder
    and MultistreamDecoder and the device runs held to them (gated); the
    loss paths' numbers are printed, not gated.  Meanwhile a thread for each
    CLI case runs its round trip, which is then checked; then every Encoder
    session kind is driven.  Launches no kernel."""
    from opus_tpu_torch import SamplingRate
    from opus_tpu_torch.multistream import MultistreamDecoder

    workdir = pathlib.Path(tempfile.mkdtemp(prefix="opus_cli_"))
    try:
        inputs = {case: write_wav(workdir / f"{case}.wav", sig, CLI_CASES[case][0])
                  for case, sig in cli_signals().items()}
        results = {}
        clis = [threading.Thread(target=run_cli, args=(workdir, case, results))
                for case in CLI_CASES]
        for t in clis:
            t.start()
        held = {}
        for name, gate in (("plan", True), ("mixed", True), ("plan-loss", False),
                           ("mixed-loss", False)):
            sample = paths[name]["sample"]
            prefix = TOC_CELT if name.startswith("plan") else b""
            columns = [[None if pk[i] is None else prefix + pk[i] for pk in traffic[name]]
                       for i in sample["rows"]]
            held[name] = hold_to_scalar(name, sample, columns, gate, where)
        ms = paths["multistream"]
        ch, streams, coupled, *mapping = ms["layout"]
        held["multistream"] = hold_to_scalar(
            "multistream", ms["sample"], [[pk[i] for pk in ms["steps"]]
                                          for i in ms["sample"]["rows"]], True, where,
            make=lambda: MultistreamDecoder(SamplingRate.HZ_48000, ch, streams, coupled, mapping),
            kind=lambda pkt: "multistream session")
        for t in clis:
            t.join()
        out = {"held": held, "cli": check_cli(workdir, results, inputs, where),
               "encode_ms": encode_kinds(where)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    where = card()
    print(where)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    import opus_tpu_torch  # noqa: F401  (sets full-fp32 matmuls)
    from opus_tpu_torch.dryrun import dryrun_multichip

    start = time.perf_counter()
    walls = {}

    def timed(name: str, fn, *args):
        """fn(*args), its wall time kept under `name` and printed."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        print(f"wall {name}: {walls[name]} s")
        return out

    timed("build", build)
    pf = timed("postfilter phase", postfilter_phase, dev, where)
    rot = timed("rotation phase", rotation_phase, dev, where)
    plc = timed("plc phase", plc_phase, dev, where)
    silk = timed("silk_synth phase", silk_phase, dev, where)

    clean = make_payloads()
    lossy = with_losses(clean)
    plan_lossy = with_plan_losses(clean)
    mixed = make_mixed_payloads(clean)
    mixed_lossy = with_mixed_losses(mixed)
    paths = {"p10": timed("p10", main_path, dev, "p10", lossy, where),
             "plan": timed("plan", main_path, dev, "plan", clean, where),
             "plan-loss": timed("plan-loss", main_path, dev, "plan-loss", plan_lossy, where),
             "mixed": timed("mixed", mixed_path, dev, "mixed", mixed, where),
             "mixed-loss": timed("mixed-loss", mixed_path, dev, "mixed-loss", mixed_lossy, where),
             "mixed-p10": timed("mixed-p10", mixed_path, dev, "mixed-p10",
                                mixed_lossy[:MIXED_P10_STEPS], where)}
    timed("graphs", graphs_phase, dev, {"lossy": lossy, "clean": clean, "plan_lossy": plan_lossy,
                                        "mixed": mixed, "mixed_lossy": mixed_lossy}, where)
    switch = with_switches(mixed)
    paths["mixed-switch"] = timed("mixed-switch", mixed_path, dev, "mixed-switch", switch, where)
    paths["mixed-switch-p10"] = timed("mixed-switch-p10", mixed_path, dev, "mixed-switch-p10",
                                      switch, where)
    paths.update(timed("run_pipelined", pipelined_phase, dev, clean, mixed, where))
    paths["silk-only"] = timed("silk-only", silk_path, dev, "silk-only", 16, B, SILK_STEPS, where)
    paths["silk-only-nb"] = timed("silk-only-nb", silk_path, dev, "silk-only-nb", 8, SILK_NB_B,
                                  SILK_NB_STEPS, where)
    silk_real = timed("silk_synth on silk-only inputs", silk_on_real_inputs, paths["silk-only"],
                      dev, where)
    for name in MS_PATHS:
        paths[name] = timed(name, ms_path, dev, name, where)
    library = timed("library", library_phase, paths, {
        "plan": clean, "plan-loss": plan_lossy, "mixed": mixed, "mixed-loss": mixed_lossy}, where)
    paths.update(timed("multichip", multichip_phase, dev, where, clean, mixed, paths))
    world = paths["multichip-plan"]["world"]
    timed("dryrun_multichip", lambda: dryrun_multichip(world, device="cuda"))
    paths.update(timed("grid", grid_phase, where))
    timed("pvq_search phase", pvq_phase, dev, where)
    paths["encode"] = timed("encode", encode_path, dev, where)
    plan = paths["plan"]

    rate_p10 = timed("rate p10", serve_rate, dev, "p10", lossy, where)
    rate_plan = timed("rate plan", serve_rate, dev, "plan", clean, where)
    rate_loss = timed("rate plan-loss", serve_rate, dev, "plan", plan_lossy, where, "plan-loss")
    p10_device(dev, lossy, where)
    plan_device(dev, clean, where)
    print(f"serve e2e summary B={B}: p10={rate_p10} plan={rate_plan} plan-loss={rate_loss} "
          f"audio_s_per_s, plan fallbacks 0 ({where})")
    rate_mixed = timed("rate mixed", mixed_rate, dev, mixed, "plan", "internal", where, "mixed")
    rate_mixed_loss = timed("rate mixed-loss", mixed_rate, dev, mixed_lossy, "plan", "internal",
                            where, "mixed-loss")
    mixed_device(dev, mixed, where)
    rate_switch = timed("rate mixed-switch", switch_rate, dev, switch, where)
    print(f"serve e2e mixed summary B={B} (plan, internal SILK): mixed={rate_mixed} "
          f"mixed-loss={rate_mixed_loss} mixed-switch={rate_switch} audio_s_per_s, plan "
          f"fallbacks 0 ({where})")
    rate_ms = {name: timed(f"rate {name}", ms_rate, dev, name, where)
               for name in ("multistream", "multistream-p10")}
    print(f"serve e2e multichip summary world={world}: plan="
          f"{paths['multichip-plan']['rate']} (unsharded {rate_plan}), mixed="
          f"{paths['multichip-mixed']['rate']} (unsharded {rate_mixed}) audio_s_per_s; "
          f"multistream={paths['multichip-multistream']['rate']} (unsharded "
          f"{rate_ms['multistream']}) sessions_audio_s_per_s ({where})")
    silk_only = paths["silk-only"]
    print(f"serve e2e slice summary: silk-only B={B} WB audio_s_per_s={silk_only['rate']} "
          f"(host front end {silk_only['host_ms']} ms/step, device {silk_only['dev_ms']} "
          f"ms/step); multistream {MS_SESSIONS} sessions sessions_audio_s_per_s plan="
          f"{rate_ms['multistream']} p10={rate_ms['multistream-p10']} ({where})")
    encode = paths["encode"]
    print(f"encode e2e slice summary: B={B} stereo 96 kbps audio_s_per_s={encode['rate']} "
          f"(host ms a step: plan {encode['host_ms']['plan']}, emit {encode['host_ms']['emit']}, "
          f"fallback {encode['host_ms']['fallback']}); device plane {encode['dev_ms']} ms a step "
          f"= {B * 0.02 / encode['dev_ms'] * 1e3} audio_s_per_s; iy download {encode['iy_ms']} "
          f"ms ({encode['iy_bytes']} B packed) ({where})")
    print("library summary: " + json.dumps({
        path: {"worst_max_abs_err": v["worst_err"], "lowest_rfc8251_score": v["lowest_score"],
               "final_ranges_equal": f"{v['ranges_equal']} of {v['decoded']}",
               "scalar_decode_ms_a_frame": v["ms_by_kind"]}
        for path, v in library["held"].items()})
        + f"; encode ms a frame {library['encode_ms']}; CLI walls s {library['cli']['walls']}, "
          f"SNR dB {library['cli']['snr']}; phase wall {walls['library']} s ({where})")
    print("wall by phase (s): " + json.dumps({k: round(v, 1) for k, v in walls.items()})
          + f"; total {time.perf_counter() - start} s")

    def launches(kernel):
        by_path = {k: v["launches"][kernel] for k, v in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def real_errs(kernel):
        """The kernel's max abs error against its plain version on each
        path's recorded inputs."""
        return {k: v["real"][kernel]["max_abs_err"] for k, v in paths.items()
                if v.get("real") and kernel in v["real"]}

    chunks = [c for p in paths.values() for c in p["chunks"] if c]
    main_chunk = max(set(chunks), key=chunks.count)
    pf_t = pf["times"][main_chunk]
    pf_real = plan["real"]["postfilter"]
    # Post-filter: the bytes these inputs need (pf_bytes); the arithmetic,
    # 3 filters x (5 taps: 3 mul + 4 add, envelope mul + add) per output
    # sample, is far below the byte time.
    pf_flops = B * C * 960 * 3 * 9
    pf_bound, pf_by = bound_ms(pf_t["bytes"][0], pf_flops)
    pf_bound_real = bound_ms(pf_real["times"]["bytes"][0], pf_flops)[0]
    # Rotation at the plan step's plane: x, cc, ss, k_pos, m_pos read,
    # out written; about 12 operations per element over both recurrences.
    n2 = 1920
    rot_bound, rot_by = bound_ms(6 * B * n2 * 4, 12 * B * n2)
    rot_real = plan["real"]["rotation"]
    # The concealment scans at the first lossy step's shapes (the compact
    # variant: 128 pitch rows, fine search; 256 synthesis rows).
    plc_real = paths["plan-loss"]["real"]["plc"]
    k = min(r for r, _ in plc_real["pitch"])
    pt_t, pt_c = plc_real["pitch"][k, 310], plc_real["pitch"][k, 155]
    ls_t = plc_real["synth"][min(plc_real["synth"])]
    # silk_synth at the silk-only path's first voiced step (B=1024, WB)
    silk_t = silk_real["times"]
    pvq_t = encode["times"]  # pvq_search on the encode path's first step
    print(json.dumps({"kernels": [
        {"name": "postfilter", "route": "cuda", "source": "opus_tpu_torch/csrc/postfilter.cu",
         "replaces": "opus_tpu/dsp/pallas_pf.py:89", **launches("postfilter"),
         "max_abs_err": max(pf["max_abs_err"], *real_errs("postfilter").values()),
         "max_abs_err_real_by_path": real_errs("postfilter"),
         "ms": pf_t["ms"], "plain_ms": pf_t["plain_ms"],
         "bound_ms": pf_bound, "bound_by": pf_by, "library_ms": None,
         "shape": f"B={B} C={C} lm=3 chunk={main_chunk}",
         "kernel_ms": pf_t["kernel_ms"],
         "bound_ms_whole_rows": bound_ms(pf_t["bytes"][1], pf_flops)[0],
         "ms_real": pf_real["times"]["ms"], "kernel_ms_real": pf_real["times"]["kernel_ms"],
         "plain_ms_real": pf_real["times"]["plain_ms"], "bound_ms_real": pf_bound_real},
        {"name": "rotation", "route": "cuda", "source": "opus_tpu_torch/csrc/rotation.cu",
         "replaces": "opus_tpu/dsp/pallas_rot.py:46", **launches("rotation"),
         "max_abs_err": max(rot["max_abs_err"], *real_errs("rotation").values()),
         "max_abs_err_real_by_path": real_errs("rotation"),
         "ms": rot["times"]["ms"], "plain_ms": rot["times"]["plain_ms"],
         "bound_ms": rot_bound, "bound_by": rot_by, "library_ms": None,
         "shape": f"B={B} n2={n2}",
         "kernel_ms": rot["times"]["kernel_ms"],
         **{f"{key}_real_{p}": rot_real["times"][p][key]
            for p in ("A", "B") for key in ("ms", "kernel_ms", "plain_ms")}},
        {"name": "pitch_track", "route": "cuda", "source": "opus_tpu_torch/csrc/plc.cu",
         "replaces": "opus_tpu/dsp/plc_exec.py:85", **launches("pitch_track"),
         "max_abs_err": 0, "ms": pt_t["ms"], "plain_ms": pt_t["plain_ms"],
         "bound_ms": pt_t["bound_ms"], "bound_by": pt_t["bound_by"], "library_ms": None,
         "shape": f"rows={k} length=664 n_lags=310 (plan-loss step, fine search)",
         "bound_note": "dependent chain at 1.98 GHz: 4 cycles x (21 lane samples + 5 tree "
                       "levels) + 8 cycles x 310 lags; with the energy summed in order "
                       f"(4 cycles x 664 + 8 x 310) it was {pt_t['chain_ms_serial_sum']} ms",
         "kernel_ms": pt_t["kernel_ms"], "ms_syn_rows_1024": plc["pitch"]["ms"],
         "kernel_ms_syn_rows_1024": plc["pitch"]["kernel_ms"],
         "plain_ms_syn_rows_1024": plc["pitch"]["plain_ms"],
         "coarse_shape": f"rows={k} length=332 n_lags=155, y at stride 2 (plan-loss step)",
         "ms_coarse": pt_c["ms"], "kernel_ms_coarse": pt_c["kernel_ms"],
         "plain_ms_coarse": pt_c["plain_ms"], "bound_ms_coarse": pt_c["bound_ms"],
         "bound_by_coarse": pt_c["bound_by"]},
        {"name": "lpc_synth", "route": "cuda", "source": "opus_tpu_torch/csrc/plc.cu",
         "replaces": "opus_tpu/dsp/plc_exec.py:298", **launches("lpc_synth"),
         "max_abs_err": max(plc["synth_err"], plc_real["synth_err"]),
         "max_abs_err_vs": "the plain version in float64",
         "ms": ls_t["ms"], "plain_ms": ls_t["plain_ms"],
         "bound_ms": ls_t["bound_ms"], "bound_by": ls_t["bound_by"], "library_ms": None,
         "shape": f"rows={min(plc_real['synth'])} el=1080 (plan-loss step)",
         "bound_note": "48 flops a sample of the sequential recurrence at 67 TFLOP/s fp32, "
                       "or the bytes; the sequential walk's dependent chain (4 cycles x 1080 "
                       f"samples at 1.98 GHz, {ls_t['chain_ms']} ms) does not bound the "
                       "chunked kernel",
         "kernel_ms": ls_t["kernel_ms"], "ms_syn_rows_2048": plc["synth"]["ms"],
         "kernel_ms_syn_rows_2048": plc["synth"]["kernel_ms"],
         "plain_ms_syn_rows_2048": plc["synth"]["plain_ms"]},
        {"name": "silk_synth", "route": "cuda", "source": "opus_tpu_torch/csrc/silk.cu",
         "replaces": "opus_tpu/dsp/silk_synthesis.py:64", **launches("silk_synth"),
         "replaces_also": "opus_tpu/dsp/silk_synthesis.py:33",
         "max_abs_err": max(silk["max_abs_err"], silk_real["max_abs_err"]),
         "max_abs_err_vs": "the plain version (int16 LSBs; synthetic rows near peaks of 100k "
                           "carry the plain version's own float32 error)",
         "max_abs_err_real": silk_real["max_abs_err"],
         "max_err_of_row_peak_vs_float64": max(silk["f64_rel"], silk_real["f64_rel"]),
         "ms": silk_t["ms"], "plain_ms": silk_t["plain_ms"],
         "bound_ms": silk_t["bound_ms"], "bound_by": silk_t["bound_by"], "library_ms": None,
         "shape": f"rows={B} 16 kHz order=16 chunk=20 L=320 (silk-only step)",
         "bound_note": f"max(bytes needed {silk_t['bytes']} (of {silk_t['bytes_whole_args']} "
                       f"in the arguments) at 3.35 TB/s = {silk_t['bytes_ms']} ms, the "
                       f"sequential LPC's chain 320 samples x 4 cycles at 1.98 GHz = "
                       f"{silk_t['chain_ms']} ms)",
         "kernel_ms": silk_t["kernel_ms"], "graph_ms": silk_t["graph_ms"],
         "ms_syn": silk["times"]["ms"], "kernel_ms_syn": silk["times"]["kernel_ms"],
         "graph_ms_syn": silk["times"]["graph_ms"], "plain_ms_syn": silk["times"]["plain_ms"]},
        {"name": "pvq_search", "route": "cuda", "source": "opus_tpu_torch/csrc/pvq.cu",
         "replaces": "opus_tpu/dsp/encode_exec.py:265", **launches("pvq_search"),
         "max_abs_err": 0,
         "max_abs_err_vs": "the plain version (pulses; iy and left must be equal)",
         "ms": pvq_t["ms"], "plain_ms": pvq_t["plain_ms"],
         "bound_ms": pvq_t["bound_ms"], "bound_by": pvq_t["bound_by"], "library_ms": None,
         "shape": f"B={B} P={ENC_P_MAX} N_MAX={ENC_N_MAX} t_max={ENC_T_MAX} (encode step 0: "
                  f"{encode['real']['valid']} leaves, longest {encode['real']['max_trips']} "
                  f"trips)",
         "bound_note": f"max(bytes needed {pvq_t['bytes']} (x at the positions the leaves "
                       f"cover, band ops, the used leaf rows, the row list, the packed int16 iy "
                       f"and left written) at 3.35 TB/s = {pvq_t['bytes_ms']} ms, the longest "
                       f"leaf's {encode['real']['max_trips']} trips x {PVQ_TRIP_CYCLES} cycles "
                       f"at 1.98 GHz = {pvq_t['chain_ms']} ms)",
         "kernel_ms": pvq_t["kernel_ms"], "kernel_l2_flushed_ms": pvq_t["kernel_l2_flushed_ms"],
         "graph_ms": pvq_t["graph_ms"], "iy_bytes": encode["iy_bytes"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
