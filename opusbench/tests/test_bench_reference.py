"""The frozen reference decoder against libopus, whose output the pools
recorded: every final range equal, the PCM within RFC 8251's criterion
(the opus_compare quality of the conformance test vectors, 90 or more).
A multistream pool is decoded by the reference of its channel layout,
whose final range is the XOR over its elementary streams."""

import json

import numpy as np
import pytest

from opusbench.reference import Decoder, decoder, reference_decoder
from opusbench.reference.conformance import PASS_QUALITY, compare
from opusbench.reference.errors import BadArguments
from opusbench.reference.multistream import MultistreamDecoder, family_decoder
from opusbench.spec import load_json
from opusbench.traffic.record import elementary_tocs
from opusbench.traffic.schedule import HERE, Pool

SURROUND = "surround71_fb_416k"
POOLS = ("celt_music_fb_stereo_96k", "voice_silk_wb_mono_20k",
         "voice_hybrid_fb_mono_32k", "voice_celt_fb_mono_32k", SURROUND)
LAYOUT71 = {"family": 1, "channels": 8, "streams": 5, "coupled": 3,
            "mapping": [0, 6, 1, 2, 3, 4, 5, 7]}


def pool_reference(name: str):
    """A fresh reference decoder for one pool: its recorded layout's, or
    one stream of its own channel count."""
    with np.load(HERE / f"{name}.npz") as z:
        if "layout" in z.files:
            return reference_decoder({"layout": json.loads(str(z["layout"]))})
        return decoder(z["pcm"].shape[-1])


@pytest.mark.parametrize("name", POOLS)
def test_reference_is_libopus(name):
    pool = Pool(name)
    with np.load(HERE / f"{name}.npz") as z:
        want, seqs = z["pcm"], z["pcm_sequences"]
    for pcm, s in zip(want, seqs):
        dec, out = pool_reference(name), []
        for f, packet in enumerate(pool.packets[s]):
            out.append(dec.decode_float(packet, 960))
            assert dec.final_range == pool.ranges[s, f], (s, f)
        got = np.concatenate(out)
        assert got.shape == pcm.shape
        assert compare(pcm, got) >= PASS_QUALITY  # every channel (and a pair's mid)
        assert np.abs(got - pcm).max() < 1e-5  # float64 against libopus's float build


@pytest.mark.parametrize("name", POOLS)
def test_final_range_needs_no_history(name):
    """A packet's final range is the one libopus recorded whatever was
    decoded before it: played looped, from an offset, after losses (so
    the harness may hold every stream's ranges to the pool's; a session's
    XOR over its elementary streams too)."""
    pool = Pool(name)
    rng = np.random.default_rng(3)
    dec = pool_reference(name)
    s, o = 5, 31
    for t in range(80):
        if rng.random() < 0.1:
            dec.decode_float(None, 960)
            continue
        f = (o + t) % 50
        dec.decode_float(pool.packets[s][f], 960)
        assert dec.final_range == pool.ranges[s, f], t


@pytest.mark.parametrize("config", ["celt_music_fb_stereo_96k", "webrtc_voice_mixed"])
def test_reference_decoder_without_a_layout_is_the_stream_decoder(config):
    """A configuration without `layout` gets the single-stream decoder of
    its `decoder` channels: the same PCM and final ranges, packet for
    packet, as `decoder(channels)`, over a stretch of each of its pools
    with a loss in it."""
    spec = load_json("configs", config)
    assert "layout" not in spec
    channels = spec["decoder"]["channels"]
    for mix in spec["mix"]:
        pool = Pool(mix["pool"])
        got, want = reference_decoder(spec), decoder(channels)
        assert type(got) is Decoder and got.channels == channels
        for f in range(12):
            packet = None if f == 7 else pool.packets[9][f]
            a, b = got.decode_float(packet, 960), want.decode_float(packet, 960)
            assert a.dtype == b.dtype and np.array_equal(a, b), (mix["pool"], f)
            assert got.final_range == want.final_range, (mix["pool"], f)


def test_surround_pool_is_the_layout():
    """64 sequences of 50 packets, recorded with the 7.1 layout, every
    elementary packet one 20 ms frame (code 0)."""
    pool = Pool(SURROUND)
    with np.load(HERE / f"{SURROUND}.npz") as z:
        assert json.loads(str(z["layout"])) == LAYOUT71
        assert z["pcm"].shape == (2, 50 * 960, 8)
    assert (pool.sequences, pool.frames) == (64, 50)
    configs = {k: set() for k in range(5)}
    for seq in pool.packets:
        for packet in seq:
            for k, toc in enumerate(elementary_tocs(packet, 5)):
                configs[k].add(toc >> 3)
    assert configs[4] == {19}  # libopus codes the LFE stream as CELT narrowband
    assert "mapping 0 6 1 2 3 4 5 7" in pool.kind


def test_a_layout_gives_the_multistream_reference():
    dec = reference_decoder({"decoder": {"channels": 8}, "layout": LAYOUT71})
    assert isinstance(dec, MultistreamDecoder)
    assert (dec.channels, dec.streams, dec.coupled) == (8, 5, 3)
    assert [d.channels for d in dec.decoders] == [2, 2, 2, 1, 1]
    assert dec.decode_float(None, 960).shape == (960, 8)


@pytest.mark.parametrize("change", [
    {"family": 0}, {"family": 2}, {"family": 255}, {"channels": 9, "mapping": list(range(8)) + [0]},
    {"channels": 0, "mapping": []}, {"mapping": [0, 6, 1, 2, 3, 4, 5]},
    {"mapping": [0, 6, 1, 2, 3, 4, 5, 8]}, {"coupled": 6}, {"streams": 0},
])
def test_refuses_a_layout_family_1_does_not_define(change):
    with pytest.raises(BadArguments):
        family_decoder({**LAYOUT71, **change})
