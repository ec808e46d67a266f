"""Turn a cell's traffic and a seed into each stream's packets.

A configuration names its packet pools and the share of streams each
pool serves (`mix`); a traffic mix names the stream count and the loss
rate.  From `--seed` the schedule draws, for every stream, its pool (the
shares exactly, in a seeded order), the sequence it plays (every sequence
of a pool about equally often), the frame it starts from, and which of
its packets are lost (exactly `loss` of all stream-steps of a period, at
seeded places).  Stream b plays its sequence from its offset, looping, so
the traffic repeats with the pools' period of `FRAMES` steps: one period
of per-step packet lists is built here, before any timing.
"""

from __future__ import annotations

import pathlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


class Pool:
    """One recorded pool: whole Opus packets by (sequence, frame), with
    libopus's final range after each."""

    def __init__(self, name: str):
        with np.load(HERE / f"{name}.npz", allow_pickle=False) as z:
            data, lens = z["data"].tobytes(), z["lens"]
            self.ranges = z["ranges"].astype(np.uint32)
            self.kind = str(z["kind"])
        self.name = name
        self.sequences, self.frames = lens.shape
        ends = np.cumsum(lens.ravel())
        starts = ends - lens.ravel()
        self.packets = [[data[starts[s * self.frames + f]:ends[s * self.frames + f]]
                         for f in range(self.frames)] for s in range(self.sequences)]


def rng_for(seed: int, purpose: str) -> np.random.Generator:
    """A generator for one purpose of one seed: any whole number, negative
    or wider than 64 bits included."""
    words = [int(w) for w in divmod(int(seed) % 2**128, 2**64)]
    return np.random.default_rng(words + [sum(map(ord, purpose)), len(purpose)])


class Schedule:
    """Every stream's pool, sequence, offset and losses for one seed.

    `period[t]` is step t's list of packets (None where lost), as the
    decoder adapter's `entry` makes them; `packet(b, t)` is stream b's
    whole packet at global step t (None where lost), as a reference
    decoder reads it."""

    def __init__(self, config: dict, traffic: dict, seed: int, entry=lambda p: p,
                 pools: dict | None = None):
        pools = pools or {m["pool"]: Pool(m["pool"]) for m in config["mix"]}
        self.pools = [pools[m["pool"]] for m in config["mix"]]
        frames = {p.frames for p in self.pools}
        if len(frames) != 1:
            raise ValueError(f"pools of different periods: {frames}")
        self.steps_per_period = frames.pop()
        B = self.streams = int(traffic["streams"])
        shares = np.array([m["share"] for m in config["mix"]], float)
        counts = np.floor(shares / shares.sum() * B).astype(int)
        counts[: B - counts.sum()] += 1
        rng = rng_for(seed, "streams")
        self.kind = rng.permutation(np.repeat(np.arange(len(counts)), counts))
        self.seq = np.zeros(B, np.int64)
        for k, pool in enumerate(self.pools):
            mine = np.flatnonzero(self.kind == k)
            self.seq[mine] = rng.permutation(np.arange(len(mine)) % pool.sequences)
        self.offset = rng.integers(0, self.steps_per_period, B)
        P = self.steps_per_period
        self.lost = np.zeros((P, B), bool)
        n_lost = int(round(float(traffic.get("loss", 0.0)) * P * B))
        self.lost.flat[rng_for(seed, "losses").choice(P * B, n_lost, replace=False)] = True
        self.period = [[None if self.lost[t, b] else entry(self._played(b, t)) for b in range(B)]
                       for t in range(P)]

    def _played(self, b: int, t: int) -> bytes:
        return self.pools[self.kind[b]].packets[self.seq[b]][(self.offset[b] + t)
                                                             % self.steps_per_period]

    def packet(self, b: int, t: int):
        """Stream b's whole packet at global step t, None where lost."""
        return None if self.lost[t % self.steps_per_period, b] else self._played(b, t)

    def libopus_ranges(self, t: int) -> np.ndarray:
        """libopus's final range of every stream's packet at global step t
        (lost streams' entries are meaningless: see `lost_at`)."""
        P = self.steps_per_period
        f = (self.offset + t) % P
        out = np.zeros(self.streams, np.uint32)
        for k, pool in enumerate(self.pools):
            mine = self.kind == k
            out[mine] = pool.ranges[self.seq[mine], f[mine]]
        return out

    def lost_at(self, t: int) -> np.ndarray:
        return self.lost[t % self.steps_per_period]
