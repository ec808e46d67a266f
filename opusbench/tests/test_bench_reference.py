"""The frozen reference decoder against libopus, whose output the pools
recorded: every final range equal, the PCM within RFC 8251's criterion
(the opus_compare quality of the conformance test vectors, 90 or more)."""

import numpy as np
import pytest

from opusbench.reference import decoder
from opusbench.reference.conformance import PASS_QUALITY, compare
from opusbench.traffic.schedule import HERE, Pool

POOLS = ("celt_music_fb_stereo_96k", "voice_silk_wb_mono_20k",
         "voice_hybrid_fb_mono_32k", "voice_celt_fb_mono_32k")


@pytest.mark.parametrize("name", POOLS)
def test_reference_is_libopus(name):
    pool = Pool(name)
    with np.load(HERE / f"{name}.npz") as z:
        want, seqs = z["pcm"], z["pcm_sequences"]
    for pcm, s in zip(want, seqs):
        dec, out = decoder(pcm.shape[-1]), []
        for f, packet in enumerate(pool.packets[s]):
            out.append(dec.decode_float(packet, 960))
            assert dec.final_range == pool.ranges[s, f], (s, f)
        got = np.concatenate(out)
        assert compare(pcm, got) >= PASS_QUALITY
        assert np.abs(got - pcm).max() < 1e-5  # float64 against libopus's float build


@pytest.mark.parametrize("name", POOLS)
def test_final_range_needs_no_history(name):
    """A packet's final range is the one libopus recorded whatever was
    decoded before it: played looped, from an offset, after losses (so
    the harness may hold every stream's ranges to the pool's)."""
    pool = Pool(name)
    rng = np.random.default_rng(3)
    dec = decoder(1 if "mono" in name else 2)
    s, o = 5, 31
    for t in range(80):
        if rng.random() < 0.1:
            dec.decode_float(None, 960)
            continue
        f = (o + t) % 50
        dec.decode_float(pool.packets[s][f], 960)
        assert dec.final_range == pool.ranges[s, f], t
