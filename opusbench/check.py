"""Whether a run is correct: the program's output against the plain
reference, after the window has closed.

What the timed path produced is kept as it is produced (`Captures`):
after every serve() call of the window (and of the traced segment), the
PCM of its last step for a sample of streams drawn from the seed
(`sample_streams`, spread over the configuration's packet pools),
gathered on the device; and the final range of every stream's packet at
every step: after the call where a call serves one step, and where it
serves many (the offline regime), after each step's host decode, read
through the adapter's `PLANE_A` method (`Captures.hook`).

Two numbers are compared, each with its limit from the cell's file:

* `range_mismatches`: captured final ranges of packets that were not
  lost which differ from libopus's final range for that packet, recorded
  with the pool (the reference decoder reads every pool packet to the
  same range: opusbench/tests/test_reference.py).  Plane A's entropy
  decode of every stream; exact, so its limit is 0.
* `pcm_max_abs`: the largest absolute difference, at full scale 1.0,
  between a sampled stream's captured PCM and the reference decoder's
  PCM of the same step, over the frames decoded from a packet that
  follow a frame decoded from a packet.  The reference (`reference/`,
  numpy, float64) decodes each sampled stream's whole packet history,
  losses included, from its first step, in a worker process of its own
  (`python3 -m opusbench.check`), so its state is worked out again from
  the packets.
* `plc_max_abs`: the same over the other frames: each lost packet's
  concealment and the frame after it, whose overlap and post-filter
  carry the concealment on.  A concealed frame is an extrapolation, so a
  float32 decoder (libopus's float build too) lies further from the
  float64 reference there than on decoded frames; a cell whose traffic
  loses packets gives it a limit of its own.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from .spec import ROOT
from .traffic.schedule import Schedule, rng_for


def sample_streams(schedule: Schedule, count: int, seed: int) -> np.ndarray:
    """`count` streams drawn from the seed, taken from the pools in turn
    so that every pool of the mix has its share."""
    rng = rng_for(seed, "check")
    by_pool = [list(rng.permutation(np.flatnonzero(schedule.kind == k)))
               for k in range(len(schedule.pools))]
    picked = []
    while len(picked) < count and any(by_pool):
        for rows in by_pool:
            if rows and len(picked) < count:
                picked.append(int(rows.pop()))
    return np.array(sorted(picked), np.int64)


class Captures:
    """The timed path's outputs, kept after each serve() call.  The PCM
    rows land in device buffers made before timing (`rows` at a time, a
    new buffer only when a window outgrows them), so keeping them
    allocates nothing on the device in the window."""

    def __init__(self, adapter, streams: np.ndarray, device, rows: int):
        import torch

        self.adapter, self.streams, self.rows = adapter, streams, max(1, rows)
        self.index = torch.as_tensor(streams, device=device)
        self.buffers: list = []
        self.hooked = False
        self.clear()

    def clear(self) -> None:
        self.steps, self.pcm, self.range_steps, self.ranges = [], None, [], []

    def take(self, dec, step: int) -> None:
        """`step` is the global index of the step the decoder served last."""
        import torch

        ring = self.adapter.ring(dec)
        buf, row = divmod(len(self.steps), self.rows)
        if buf == len(self.buffers):
            self.buffers.append(ring.new_empty((self.rows, len(self.streams)) + ring.shape[1:]))
        torch.index_select(ring, 0, self.index, out=self.buffers[buf][row])
        self.steps.append(step)
        if not self.hooked:
            self.take_ranges(dec, step)

    def take_ranges(self, dec, step: int) -> None:
        self.range_steps.append(step)
        self.ranges.append(self.adapter.ranges(dec))

    def hook(self, ctx) -> None:
        """Keep every step's final ranges from inside a serve() call: wrap
        the decoder's host decodes of one step (the adapter's `PLANE_A`,
        each dotted attributes) so that each call that returns is followed
        by a read of the ranges while `ctx.capturing`.  `ctx.step` counts
        the steps of the call under way; a decode that raises counts none
        (the program decodes that step another way, on another path)."""
        for path in self.adapter.PLANE_A:
            *owners, attr = path.split(".")
            obj = ctx.dec
            for name in owners:
                obj = getattr(obj, name)
            setattr(obj, attr, self._ranged(ctx, getattr(obj, attr)))
        self.hooked = True

    def _ranged(self, ctx, fn):
        def ranged(*a, **k):
            out = fn(*a, **k)
            if ctx.capturing:
                self.take_ranges(ctx.dec, ctx.step)
            ctx.step += 1
            return out

        return ranged

    def to_host(self) -> None:
        """The kept PCM as one host array [captures, sampled, frame, C]."""
        import torch

        n = len(self.steps)
        self.pcm = torch.cat(self.buffers)[:n].cpu().numpy() if n else None
        self.buffers = []


def _worker_args(cell: str, seed: int, stream: int, steps: list, out: str) -> list:
    job = json.dumps({"cell": cell, "seed": seed, "stream": stream, "steps": steps, "out": out})
    return [sys.executable, "-m", "opusbench.check", job]


def reference_pcm(cell: str, seed: int, streams: np.ndarray, steps: list) -> dict:
    """The reference decoder's PCM of each sampled stream at the captured
    steps: {stream: float64 [len(steps), 960, channels]}; one worker process a
    stream, all at once, each waited for."""
    with tempfile.TemporaryDirectory(prefix="opusbench-check-") as tmp:
        procs = []
        try:
            for b in streams:
                out = os.path.join(tmp, f"{b}.npy")
                procs.append((int(b), out, subprocess.Popen(
                    _worker_args(cell, seed, int(b), steps, out), cwd=ROOT,
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
            result = {}
            for b, out, p in procs:
                _, err = p.communicate()
                if p.returncode != 0:
                    raise RuntimeError(f"reference worker for stream {b} failed:\n"
                                       f"{err.decode(errors='replace')[-2000:]}")
                result[b] = np.load(out)
            return result
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


def compare(schedule: Schedule, caps: Captures, ref: dict, streams: np.ndarray) -> dict:
    """The numbers compared, with what they were taken over."""
    mism = compared = 0
    for t, got in zip(caps.range_steps, caps.ranges):
        keep = ~schedule.lost_at(t)
        mism += int(((got != schedule.libopus_ranges(t)) & keep).sum())
        compared += int(keep.sum())
    prog = caps.pcm.swapaxes(0, 1)  # [sampled, captures, frame, C]
    steps = np.asarray(caps.steps)
    worst = {"pcm": (0.0, None), "plc": (0.0, None)}
    frames = {"pcm": 0, "plc": 0}
    for j, b in enumerate(streams):
        err = np.abs(prog[j].astype(np.float64) - ref[int(b)]).max(axis=(1, 2))
        err[~np.isfinite(err)] = np.inf
        plc = np.array([schedule.lost_at(t)[b] or (t > 0 and schedule.lost_at(t - 1)[b])
                        for t in steps])
        for kind, rows in (("pcm", ~plc), ("plc", plc)):
            frames[kind] += int(rows.sum())
            if rows.any():
                k = int(np.argmax(np.where(rows, err, -1.0)))
                if err[k] >= worst[kind][0]:
                    worst[kind] = (float(err[k]), (int(b), int(steps[k])))
    lost = sum(int(schedule.lost_at(t)[streams].sum()) for t in range(int(steps.max()) + 1))
    return {"range_mismatches": mism, "ranges_compared": compared,
            "pcm_max_abs": worst["pcm"][0], "pcm_worst_at": worst["pcm"][1],
            "plc_max_abs": worst["plc"][0], "plc_worst_at": worst["plc"][1],
            "pcm_frames": frames["pcm"], "plc_frames": frames["plc"],
            "sampled_lost_frames": lost}


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): correct when every number is at
    or under its limit and something was compared."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = (numbers["ranges_compared"] > 0 and numbers["pcm_frames"] > 0
          and ("plc_max_abs" not in limits or numbers["plc_frames"] > 0)
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return ok, checks


def _worker(job: dict) -> None:
    """Decode one stream's packets from step 0 with the reference and save
    its PCM at the captured steps."""
    from .reference import reference_decoder
    from .spec import Cell

    cell = Cell(job["cell"])
    schedule = Schedule(cell.config, cell.traffic, job["seed"])
    b, want = job["stream"], job["steps"]
    dec, out, at = reference_decoder(cell.config), [], 0
    for t in range(max(want) + 1):
        pcm = dec.decode_float(schedule.packet(b, t), 960)
        while at < len(want) and want[at] == t:
            out.append(pcm)
            at += 1
    np.save(job["out"], np.stack(out).astype(np.float64))


if __name__ == "__main__":
    _worker(json.loads(sys.argv[1]))
