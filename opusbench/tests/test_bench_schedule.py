"""The traffic schedule: one seed, one traffic; another seed, another."""

import numpy as np
import pytest

from opusbench.spec import load_json
from opusbench.traffic.schedule import Pool, Schedule

VOICE = load_json("configs", "webrtc_voice_mixed")
MUSIC = load_json("configs", "celt_music_fb_stereo_96k")


@pytest.fixture(scope="module")
def pools():
    return {m["pool"]: Pool(m["pool"]) for m in VOICE["mix"] + MUSIC["mix"]}


def traffic(streams, loss):
    return {"streams": streams, "loss": loss}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, -3, 2**70 + 1])
def test_same_seed_same_schedule(pools, seed):
    a = Schedule(VOICE, traffic(300, 0.05), seed, pools=pools)
    b = Schedule(VOICE, traffic(300, 0.05), seed, pools=pools)
    for key in ("kind", "seq", "offset", "lost"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key
    assert a.period == b.period


def test_seeds_differ(pools):
    a = Schedule(VOICE, traffic(300, 0.05), 1, pools=pools)
    b = Schedule(VOICE, traffic(300, 0.05), 2, pools=pools)
    assert not np.array_equal(a.kind, b.kind)
    assert not np.array_equal(a.offset, b.offset)
    assert not np.array_equal(a.lost, b.lost)
    assert a.period != b.period


@pytest.mark.parametrize("seed", range(4))
def test_loss_share_and_mix_are_the_same_for_every_seed(pools, seed):
    s = Schedule(VOICE, traffic(320, 0.05), seed, pools=pools)
    assert s.lost.shape == (50, 320)
    assert s.lost.sum() == round(0.05 * 50 * 320)  # 5% of a period, exactly
    per_stream = s.lost.mean(axis=0)
    assert 0.0 <= per_stream.min() and per_stream.max() < 0.25
    assert sorted(np.bincount(s.kind).tolist()) == [106, 107, 107]
    uses = np.bincount(s.seq[s.kind == 0], minlength=64)
    assert uses.max() - uses.min() <= 1  # every sequence of a pool about equally often
    assert sum(p is None for step in s.period for p in step) == s.lost.sum()


def test_music_has_no_loss_and_plays_from_offsets(pools):
    s = Schedule(MUSIC, traffic(1024, 0.0), 5, pools=pools)
    assert not s.lost.any()
    b, pool = 17, s.pools[0]
    for t in (0, 1, 49, 50, 123):
        assert s.packet(b, t) == pool.packets[s.seq[b]][(s.offset[b] + t) % 50]
        assert s.libopus_ranges(t)[b] == pool.ranges[s.seq[b], (s.offset[b] + t) % 50]
    assert s.period[3][b] == s.packet(b, 3)


def test_pools_are_libopus_single_frames(pools):
    for pool in pools.values():
        assert (pool.sequences, pool.frames) == (64, 50)
        assert all(p[0] & 3 == 0 for seq in pool.packets for p in seq)
        assert "libopus" in pool.kind
