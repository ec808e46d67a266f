"""The port's codec library against the reference's, on the same inputs.

The library modules of opus_tpu_torch (types, packet, softclip, rc/trace,
the SILK layer, decoder, conformance, repacketizer, ogg, the Python SILK
encoders, encoder, multistream and the CLI) are copies: each keeps the
reference's code below a docstring of its own, so its syntax tree, the
docstring dropped, must equal the reference module's, and it imports
neither torch, jax nor opus_tpu.  Then the port and the reference run the
same inputs (libopus packets through opus_tpu.oracle, or numpy signals
from a seed), and, the code being the same, their outputs must be equal:
Decoder PCM and final ranges (array_equal), Encoder, MultistreamEncoder,
Repacketizer and OggOpusWriter bytes, conformance scores, and the native
wrappers' planes, which run the port's byte-identical copy of the C++
engines.  Every Encoder session kind must run on a native encoder
(`_native_enc is not None`): the copy falls back to the Python encoders,
about 100-500 times slower, without a word when a native wrapper is
missing.  The card test holds the full-width device decoders to the
port's own Decoder at B=64 with the smoke run's gate.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from opus_tpu import oracle

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["types.py", "packet.py", "softclip.py", "rc/trace.py", "silk/stereo.py", "silk/plc.py",
          "silk/api.py", "decoder.py", "conformance.py", "repacketizer.py", "ogg.py",
          "silk/encoder.py", "silk/stereo_encoder.py", "encoder.py", "multistream.py",
          "__main__.py", "oracle.py"]

needs_libopus = pytest.mark.skipif(not oracle.available(), reason="libopus not present")


def _tree_without_docstring(path: pathlib.Path) -> ast.Module:
    tree = ast.parse(path.read_text())
    assert isinstance(tree.body[0], ast.Expr) and isinstance(tree.body[0].value, ast.Constant)
    tree.body = tree.body[1:]
    return tree


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference_module(rel):
    port = _tree_without_docstring(ROOT / "opus_tpu_torch" / rel)
    ref = _tree_without_docstring(ROOT / "opus_tpu" / rel)
    assert ast.dump(port) == ast.dump(ref), rel
    imported = {a.name.split(".")[0] for n in ast.walk(port) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(port)
                 if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
    assert not imported & {"torch", "jax", "opus_tpu"}, (rel, imported)
    doc = ast.get_docstring(ast.parse((ROOT / "opus_tpu_torch" / rel).read_text()))
    assert "reference/src" not in doc  # the reference cites its source tree by path


def test_library_imports_neither_jax_nor_the_reference():
    """The public modules load in a fresh interpreter without jax or opus_tpu,
    and the package exports the reference's public names."""
    code = ("import sys, opus_tpu_torch, opus_tpu_torch.encoder, opus_tpu_torch.multistream, "
            "opus_tpu_torch.__main__, opus_tpu_torch.bench\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'opus_tpu')))\n"
            "print(sorted(opus_tpu_torch.__all__))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout.splitlines()
    import opus_tpu

    assert out == ["[]", str(sorted(opus_tpu.__all__))]


def test_packet_layer_has_one_error_and_one_set_of_enums():
    """packet.py sits on errors.py and types.py: its refusals are the
    InvalidPacket (an OpusError) that a caller of the package catches, and
    its codec modes and bandwidths are the library's (there were once two
    classes of each, and two enum classes never compare equal)."""
    from opus_tpu import packet as ref
    from opus_tpu_torch import errors, packet

    rng = np.random.default_rng(12)
    accepted = []
    for _ in range(400):
        pk = bytes(rng.integers(0, 256, int(rng.integers(1, 12)), dtype=np.uint8))
        try:
            accepted.append((pk, ref.parse_packet(pk)))
        except ref.InvalidPacket:
            with pytest.raises(errors.InvalidPacket):
                packet.parse_packet(pk)
    assert 50 < len(accepted) < 350
    for pk, want in accepted:
        got = packet.parse_packet(pk)
        assert (got.frame_sizes, got.frame_offsets) == (want.frame_sizes, want.frame_offsets)
        assert packet.query_packet_frame_count(pk) == ref.query_packet_frame_count(pk)
        assert packet.query_packet_sample_count(pk, 48000) == \
            ref.query_packet_sample_count(pk, 48000)
        assert packet.parse_size(pk[1:] + b"\0\0") == ref.parse_size(pk[1:] + b"\0\0")
    import opus_tpu_torch
    from opus_tpu_torch import types

    celt = bytes([0xFC]) + bytes(40)
    assert packet.query_packet_codec_mode(celt) is types.CodecMode.CELT_ONLY
    assert packet.query_packet_bandwidth(celt) is types.Bandwidth.FULLBAND
    assert packet.query_packet_channel_count(celt) is types.Channels.STEREO
    assert packet.InvalidPacket is errors.InvalidPacket is opus_tpu_torch.InvalidPacket
    assert issubclass(packet.InvalidPacket, errors.OpusError)
    assert packet.MAX_FRAMES_PER_PACKET == ref.MAX_FRAMES_PER_PACKET == 48


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_MODES = {"celt": oracle.MODE_CELT_ONLY, "silk": oracle.MODE_SILK_ONLY,
          "hybrid": oracle.MODE_HYBRID}
_BW = {"NB": oracle.BANDWIDTH_NARROWBAND, "MB": oracle.BANDWIDTH_MEDIUMBAND,
       "WB": oracle.BANDWIDTH_WIDEBAND, "SWB": oracle.BANDWIDTH_SUPERWIDEBAND,
       "FB": oracle.BANDWIDTH_FULLBAND}
_DURATION = {5: oracle.FRAMESIZE_5_MS, 10: oracle.FRAMESIZE_10_MS,
             20: oracle.FRAMESIZE_20_MS, 40: oracle.FRAMESIZE_40_MS, 60: oracle.FRAMESIZE_60_MS}


def _signal(rate: int, n: int, channels: int, seed: int) -> np.ndarray:
    """A voiced pulse train with vibrato, a tone and noise; the second
    channel delayed and quieter."""
    t = np.arange(n) / rate
    rng = np.random.default_rng(seed)
    phase = np.cumsum(2 * np.pi * (130 + 30 * np.sin(2 * np.pi * 3 * t)) / rate)
    s = (0.3 * np.sign(np.sin(phase)) * np.exp(-3 * (t % 0.01) * 100)
         + 0.1 * np.sin(2 * np.pi * min(2930, rate / 3) * t) + 0.03 * rng.standard_normal(n))
    out = np.stack([s, np.roll(s, 17) * 0.8], -1) if channels == 2 else s[:, None]
    return out.astype(np.float32)


def _libopus_packets(mode, bw, channels, frame_ms, kbps, nframes, seed=5, fec=False,
                     enc_rate=48000) -> list:
    enc = oracle.Encoder(enc_rate, channels)
    enc.ctl(oracle.SET_FORCE_MODE, _MODES[mode])
    enc.ctl(oracle.SET_BITRATE, kbps * 1000)
    enc.ctl(oracle.SET_BANDWIDTH, _BW[bw])
    enc.ctl(oracle.SET_EXPERT_FRAME_DURATION, _DURATION[frame_ms])
    if fec:
        enc.ctl(oracle.SET_INBAND_FEC, 1)
        enc.ctl(oracle.SET_PACKET_LOSS_PERC, 20)
    frame = enc_rate * frame_ms // 1000
    pcm = _signal(enc_rate, frame * nframes, channels, seed)
    return [enc.encode_float(pcm[f * frame : (f + 1) * frame].ravel(), frame)
            for f in range(nframes)]


def _decoders(rate: int, channels: int, gain: int = 0):
    from opus_tpu import decoder as ref
    from opus_tpu import types as ref_types
    from opus_tpu_torch import decoder as port
    from opus_tpu_torch import types

    return (ref.Decoder(ref.DecoderConfiguration(ref_types.SamplingRate(rate),
                                                 ref_types.Channels(channels), gain=gain)),
            port.Decoder(port.DecoderConfiguration(types.SamplingRate(rate),
                                                   types.Channels(channels), gain=gain)))


# (mode, bandwidth, channels, frame ms, kbps, output rate, packets): every
# mode and bandwidth, mono and stereo, 10-60 ms, every output rate.
DECODE_CASES = {
    "celt-fb-mono-10ms-48k": ("celt", "FB", 1, 10, 48, 48000, 24),
    "celt-fb-stereo-20ms-24k": ("celt", "FB", 2, 20, 96, 24000, 16),
    "celt-wb-stereo-40ms-48k": ("celt", "WB", 2, 40, 64, 48000, 8),
    "celt-swb-mono-60ms-12k": ("celt", "SWB", 1, 60, 48, 12000, 6),
    "silk-nb-mono-20ms-8k": ("silk", "NB", 1, 20, 12, 8000, 16),
    "silk-mb-stereo-40ms-12k": ("silk", "MB", 2, 40, 24, 12000, 8),
    "silk-wb-mono-60ms-16k": ("silk", "WB", 1, 60, 20, 16000, 6),
    "silk-wb-stereo-10ms-48k": ("silk", "WB", 2, 10, 32, 48000, 20),
    "hybrid-swb-mono-20ms-48k": ("hybrid", "SWB", 1, 20, 32, 48000, 16),
    "hybrid-fb-stereo-10ms-24k": ("hybrid", "FB", 2, 10, 64, 24000, 20),
    "hybrid-fb-stereo-20ms-16k": ("hybrid", "FB", 2, 20, 48, 16000, 12),
}


@needs_libopus
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decoder_equals_reference(case):
    """Equal PCM (array_equal: the same numpy code on the same packets) and
    final ranges, which are also libopus's."""
    from opus_tpu import packet as ref_packet

    mode, bw, ch, ms, kbps, rate, n = DECODE_CASES[case]
    pkts = _libopus_packets(mode, bw, ch, ms, kbps, n)
    # the case really is of its mode and bandwidth
    assert ref_packet.query_packet_codec_mode(pkts[0]).name.startswith(mode.upper())
    assert int(ref_packet.query_packet_bandwidth(pkts[0])) == _BW[bw]
    ref, port = _decoders(rate, ch)
    lib = oracle.Decoder(rate, ch)
    fo = rate * ms // 1000
    for f, pkt in enumerate(pkts):
        want = ref.decode_float(pkt, fo)
        got = port.decode_float(pkt, fo)
        lib.decode_float(pkt, fo)
        assert got.shape == want.shape == (fo, ch)
        assert np.array_equal(got, want), (case, f)
        assert port.final_range == ref.final_range == lib.final_range, (case, f)


# (mode, bandwidth, channels, kbps, output rate, lost frames, frames decoded
# from the next packet's LBRR): 20 ms packets, 16 of them.
LOSS_CASES = {
    "plc-celt-stereo": ("celt", "FB", 2, 64, 48000, (5, 11, 12), ()),
    "plc-silk-wb-mono": ("silk", "WB", 1, 20, 16000, (4, 5, 9), ()),
    "plc-hybrid-stereo": ("hybrid", "FB", 2, 48, 48000, (7,), ()),
    "fec-silk-wb-mono": ("silk", "WB", 1, 24, 16000, (), (3, 8)),
    "fec-hybrid-stereo": ("hybrid", "SWB", 2, 48, 48000, (10,), (6,)),
}


@needs_libopus
@pytest.mark.parametrize("case", LOSS_CASES)
def test_decoder_loss_and_fec_equal_reference(case):
    """A lost packet (concealment) and decode_fec=True on the next packet
    of a stream with LBRR: equal PCM; equal final ranges on decoded frames."""
    mode, bw, ch, kbps, rate, lost, fec = LOSS_CASES[case]
    pkts = _libopus_packets(mode, bw, ch, 20, kbps, 16, seed=8, fec=bool(fec))
    ref, port = _decoders(rate, ch)
    fo = rate // 50
    for f in range(16):
        if f in fec:
            want = ref.decode_float(pkts[f + 1], fo, decode_fec=True)
            got = port.decode_float(pkts[f + 1], fo, decode_fec=True)
        else:
            pkt = None if f in lost else pkts[f]
            want, got = ref.decode_float(pkt, fo), port.decode_float(pkt, fo)
        assert np.array_equal(got, want), (case, f)
        assert port.final_range == ref.final_range, (case, f)


@needs_libopus
def test_decoder_gain_and_int16_soft_clip_equal_reference():
    """A Q8 gain (+6 dB) on float output, and the int16 path, which soft
    clips a loud stream: equal samples."""
    pkts = _libopus_packets("celt", "FB", 2, 20, 96, 12, seed=3)
    ref, port = _decoders(48000, 2, gain=1536)
    for pkt in pkts:
        assert np.array_equal(port.decode_float(pkt, 960), ref.decode_float(pkt, 960))
    loud = oracle.Encoder(48000, 1)
    loud.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    loud.ctl(oracle.SET_BITRATE, 64000)
    sig = np.clip(1.6 * _signal(48000, 960 * 8, 1, 4), -1, 1)
    ref, port = _decoders(48000, 1, gain=768)
    plain = _decoders(48000, 1, gain=768)[1]
    over = 0
    for f in range(8):
        pkt = loud.encode_float(np.ascontiguousarray(sig[f * 960 : (f + 1) * 960]).ravel(), 960)
        want = ref.decode(pkt, 960, dtype=np.int16)
        got = port.decode(pkt, 960, dtype=np.int16)
        assert got.dtype == want.dtype == np.int16 and np.array_equal(got, want)
        over += int((np.abs(plain.decode_float(pkt, 960)) > 1.0).sum())
    assert over > 0  # the float output leaves +-1, so the int16 path soft clips
    assert np.array_equal(port.decode(None, 960, dtype=np.int16),
                          ref.decode(None, 960, dtype=np.int16))


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001  (the outcome is compared, not handled)
        return type(e).__name__


@needs_libopus
def test_decoder_errors_equal_reference():
    """tests/test_decoder.py:74's cases and a refused packet: the same
    exception class names, raised from the port's own classes."""
    from opus_tpu_torch import errors

    pkts = _libopus_packets("celt", "FB", 2, 20, 64, 2)
    ref, port = _decoders(48000, 2)
    for call in (lambda d: d.decode_float(b"\xfc\x00", 961),
                 lambda d: d.decode_float(pkts[0], 960),
                 lambda d: d.decode_float(None, 960),
                 lambda d: d.final_range,
                 lambda d: d.decode_float(pkts[1], 480),
                 lambda d: d.decode_float(b"\xff\x81", 960),
                 lambda d: d.decode_float(b"", 960)):
        want, got = _outcome(call, ref), _outcome(call, port)
        if isinstance(want, str):
            assert got == want
        elif isinstance(want, np.ndarray):
            assert np.array_equal(got, want)
        else:
            assert got == want
    with pytest.raises(errors.BadArguments):
        port.decode_float(b"\xfc\x00", 961)
    with pytest.raises(errors.BufferTooSmall):
        port.decode_float(pkts[1], 480)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

# application, channels, input rate, bitrate, frame ms, options, and the
# native wrapper the session must run on.
ENCODE_CASES = {
    "music-cbr-mono-20ms": ("music", 1, 48000, 64000, 20, {}, "NativeCeltEncoder"),
    "music-vbr-stereo-20ms": ("music", 2, 48000, 96000, 20, {"vbr": True}, "NativeCeltEncoder"),
    "music-cbr-stereo-40ms": ("music", 2, 48000, 128000, 40, {}, "NativeCeltEncoder"),
    "music-vbr-mono-40ms": ("music", 1, 48000, 48000, 40, {"vbr": True}, "NativeCeltEncoder"),
    "voice-mono-16k": ("voice", 1, 16000, 20000, 20, {}, "NativeVoiceEncoder"),
    "voice-stereo-48k": ("voice", 2, 48000, 32000, 20, {}, "NativeStereoVoiceEncoder"),
    "hybrid-mono": ("hybrid", 1, 48000, 32000, 20, {}, "NativeHybridEncoder"),
    "hybrid-stereo-fec": ("hybrid", 2, 48000, 48000, 20, {"fec": True}, "NativeHybridEncoder"),
    "voice-mono-fec": ("voice", 1, 48000, 24000, 20, {"fec": True}, "NativeVoiceEncoder"),
    "voice-mono-dtx": ("voice", 1, 16000, 16000, 20, {"dtx": True}, "NativeVoiceEncoder"),
}


@pytest.mark.parametrize("case", ENCODE_CASES)
def test_encoder_equals_reference(case):
    """Byte-equal packets and equal final ranges, on a native encoder in
    both packages, through a set_bitrate and set_complexity change after
    the fifth frame; the port's Decoder reads every coded packet of a mono
    session to the encoder's final range."""
    from opus_tpu import encoder as ref
    from opus_tpu import types as ref_types
    from opus_tpu_torch import decoder, encoder, types

    app, ch, rate, bitrate, ms, opts, native = ENCODE_CASES[case]
    encs = [mod.Encoder(mod.EncoderConfiguration(t.SamplingRate(rate), t.Channels(ch), bitrate,
                                                 application=app, **opts))
            for mod, t in ((ref, ref_types), (encoder, types))]
    for e in encs:
        assert type(e._native_enc).__name__ == native
    assert type(encs[1]._native_enc).__module__ == "opus_tpu_torch.native.frontend"
    frame = rate * ms // 1000
    n = 10 if ms == 20 else 6
    pcm = _signal(rate, frame * n, ch, seed=6)
    if opts.get("dtx"):
        pcm[frame * 3 : frame * 8] = 0.0
    dec = decoder.Decoder(decoder.DecoderConfiguration(types.SamplingRate.HZ_48000,
                                                       types.Channels(ch)))
    sizes = []
    for f in range(n):
        if f == 5:
            for e in encs:
                e.set_bitrate(bitrate * 3 // 2)
                e.set_complexity(5)
        x = pcm[f * frame : (f + 1) * frame]
        want, got = encs[0].encode(x), encs[1].encode(x)
        assert got == want, (case, f)
        assert encs[1].final_range == encs[0].final_range, (case, f)
        sizes.append(len(got))
        if ch == 1:
            dec.decode_float(got, 48 * ms)
            # a DTX packet is its ToC alone: the decoder conceals, range 0
            assert dec.final_range == (encs[1].final_range if len(got) > 1 else 0), (case, f)
    if opts.get("dtx"):
        assert min(sizes) <= 2  # DTX sent its one-byte packets in the silence


# ---------------------------------------------------------------------------
# Containers, the metric
# ---------------------------------------------------------------------------

@needs_libopus
def test_repacketizer_equals_reference():
    """Merge three packets, split each back out, pad one to 400 bytes:
    byte-equal output, and the port's Decoder reads the merged packet as
    the parts."""
    from opus_tpu import repacketizer as ref
    from opus_tpu_torch import parse_packet, repacketizer

    pkts = _libopus_packets("celt", "FB", 1, 20, 64, 4)
    outs = []
    for mod in (ref, repacketizer):
        rp = mod.Repacketizer()
        for p in pkts[:3]:
            rp.cat(p)
        outs.append([rp.out(), *[rp.out_range(i, i + 1) for i in range(3)],
                     rp.out_range(0, 1, pad_to=400), rp.nb_frames])
    assert outs[1] == outs[0]
    merged = outs[1][0]
    assert parse_packet(merged).frame_count == 3 and len(outs[1][4]) == 400
    a, b = _decoders(48000, 1)[1], _decoders(48000, 1)[1]
    parts = np.concatenate([a.decode_float(p, 960) for p in pkts[:3]])
    assert np.array_equal(b.decode_float(merged, 2880), parts)


@needs_libopus
def test_multistream_equals_reference():
    """The 8-channel layout (6 streams, 2 coupled): libopus multistream
    packets decode to equal PCM and final ranges in both
    MultistreamDecoders, and MultistreamEncoder writes equal bytes, which
    both decoders read back alike."""
    from opus_tpu import multistream as ref
    from opus_tpu import types as ref_types
    from opus_tpu_torch import multistream, types

    streams, coupled, mapping, frame = 6, 2, list(range(8)), 960
    rng = np.random.default_rng(5)
    t = np.arange(frame * 4) / 48000
    pcm = np.stack([0.3 * np.sin(2 * np.pi * (200 + 80 * k) * t)
                    + 0.02 * rng.standard_normal(t.size) for k in range(8)], -1).astype(np.float32)
    lib = oracle.MultistreamEncoder(48000, 8, streams, coupled, mapping)
    lib.ctl(oracle.SET_BITRATE, 512000)
    lib.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    encs = [mod.MultistreamEncoder(tt.SamplingRate.HZ_48000, 8, streams, coupled, mapping, 64000)
            for mod, tt in ((ref, ref_types), (multistream, types))]
    # one pair of decoders for libopus's packets, one for the encoders'
    decs = [[mod.MultistreamDecoder(tt.SamplingRate.HZ_48000, 8, streams, coupled, mapping)
             for mod, tt in ((ref, ref_types), (multistream, types))] for _ in range(2)]
    for f in range(4):
        x = pcm[f * frame : (f + 1) * frame]
        want_pkt, pkt = encs[0].encode(x), encs[1].encode(x)
        assert pkt == want_pkt and encs[1].final_range == encs[0].final_range
        for (d_ref, d_port), p in zip(decs, (lib.encode_float(np.ascontiguousarray(x).ravel(),
                                                              frame), pkt)):
            want, got = d_ref.decode(p, frame), d_port.decode(p, frame)
            assert got.shape == (frame, 8) and np.array_equal(got, want)
            assert d_port.final_range == d_ref.final_range
        assert decs[1][1].final_range == encs[1].final_range


@pytest.mark.parametrize("family", [0, 1])
def test_ogg_equals_reference(family):
    """OggOpusWriter writes equal bytes (a stereo head, or a family-1 5.1
    head); OggOpusReader reads back equal heads, packets and granules, and
    refuses a corrupted page as the reference does."""
    from opus_tpu import ogg as ref
    from opus_tpu_torch import errors, ogg

    rng = np.random.default_rng(family)
    pkts = [bytes(rng.integers(0, 256, int(rng.integers(1, 700)), dtype=np.uint8))
            for _ in range(7)]
    head = dict(channels=2, pre_skip=312) if family == 0 else dict(
        channels=6, pre_skip=120, mapping_family=1, streams=4, coupled=2,
        mapping=(0, 4, 1, 2, 3, 5))
    files = []
    for mod in (ref, ogg):
        buf = io.BytesIO()
        w = mod.OggOpusWriter(buf, mod.OpusHead(**head))
        for i, p in enumerate(pkts):
            w.write_packet(p, 960, end_of_stream=i == len(pkts) - 1 and family == 0)
        w.close()
        files.append(buf.getvalue())
    assert files[1] == files[0]
    want, got = ref.OggOpusReader(files[0]), ogg.OggOpusReader(files[1])
    assert got.packets == want.packets and got.granules == want.granules
    assert got.audio_packets == pkts
    assert dataclasses.astuple(got.head) == dataclasses.astuple(want.head)
    assert ogg.ogg_crc(files[0]) == ref.ogg_crc(files[0])
    bad = bytearray(files[1])
    bad[-3] ^= 0x40
    with pytest.raises(errors.InvalidPacket):
        ogg.OggOpusReader(bytes(bad))


@needs_libopus
def test_range_trace_replay_equals_reference():
    """rc/trace.py: the port's CeltDecoder read through its
    TracingRangeDecoder records the reference's ops, and replay re-encodes
    them to the packet's bytes (all but the last, which the raw-bit tail
    may change) and to the reference's replay."""
    from opus_tpu.celt import decoder as ref_celt
    from opus_tpu.rc import trace as ref
    from opus_tpu_torch.celt import decoder as celt
    from opus_tpu_torch.rc import trace

    decs = [ref_celt.CeltDecoder(1), celt.CeltDecoder(1)]
    for pkt in _libopus_packets("celt", "FB", 1, 20, 64, 6, seed=3):
        body = pkt[1:]
        traces = [ref.TracingRangeDecoder(body), trace.TracingRangeDecoder(body)]
        for d, tr in zip(decs, traces):
            d.decode(body, 960, dec=tr)
        assert traces[1].ops == traces[0].ops
        out = trace.replay(traces[1].ops, len(body))
        assert out == ref.replay(traces[0].ops, len(body)) and out[:-1] == body[:-1]
        assert trace.first_divergence(traces[1].ops, body) == \
            ref.first_divergence(traces[0].ops, body)


CONFORMANCE_PAIRS = {
    "equal-stereo": (2, 0.0, 0, 1.0),
    "noise-stereo": (2, 1e-3, 0, 1.0),
    "delayed-mono": (1, 0.0, 48, 1.0),
    "quieter-stereo": (2, 0.0, 0, 0.5),
    "noisy-mono-fails": (1, 0.2, 0, 1.0),
}


@pytest.mark.parametrize("case", CONFORMANCE_PAIRS)
def test_conformance_compare_equals_reference(case):
    """compare() scores equal floats on passing and failing pairs."""
    from opus_tpu import conformance as ref
    from opus_tpu_torch import conformance

    ch, noise, delay, scale = CONFORMANCE_PAIRS[case]
    rng = np.random.default_rng(3)
    x = _signal(48000, 9600, ch, seed=2)
    y = scale * np.roll(x, delay, axis=0) + noise * rng.standard_normal(x.shape)
    want = ref.compare(x, y.astype(np.float32))
    assert conformance.compare(x, y.astype(np.float32)) == want
    assert conformance.PASS_QUALITY == ref.PASS_QUALITY == 90.0
    assert (want >= 90.0) == (case in ("equal-stereo", "noise-stereo"))


# ---------------------------------------------------------------------------
# Native wrappers
# ---------------------------------------------------------------------------

@needs_libopus
def test_native_silk_front_end_equals_reference_and_libopus():
    """NativeSilkFrontEnd: xq, planes and final ranges equal the reference
    wrapper's, and xq is sample-exact against libopus after its 13-sample
    delay (the reference's gate, tests/test_native.py:118).  NativeSilkBatch
    on four streams at once: the same xq and final ranges as the reference's
    batch and as four single-stream decoders."""
    from opus_tpu import parse_packet
    from opus_tpu.native import frontend as ref
    from opus_tpu_torch.native import frontend as port

    streams = [[p[parse_packet(p).payload_offset :] for p in
                _libopus_packets("silk", "WB", 1, 20, kbps, 8, seed=s, enc_rate=16000)]
               for s, kbps in ((1, 24), (2, 16), (3, 32), (4, 20))]
    lib = oracle.Decoder(16000, 1)
    nat, nat_ref = port.NativeSilkFrontEnd(16), ref.NativeSilkFrontEnd(16)
    tail = np.zeros(13, int)
    for f, payload in enumerate(streams[0]):
        xq, planes = nat.decode(payload, want_planes=True)
        want_xq, want_planes = nat_ref.decode(payload, want_planes=True)
        assert np.array_equal(xq, want_xq) and nat.final_range == nat_ref.final_range
        assert planes.keys() == want_planes.keys()
        for k, v in planes.items():
            assert np.array_equal(v, want_planes[k]), k
        toc = bytes([9 << 3])
        r = np.round(np.asarray(lib.decode_float(toc + payload, 320)).reshape(-1) * 32768)
        assert np.array_equal(np.concatenate([tail, xq.astype(int)])[:320], r.astype(int)), f
        assert lib.final_range == nat.final_range
        tail = xq.astype(int)[-13:]
    batch, batch_ref = port.NativeSilkBatch(4, 16), ref.NativeSilkBatch(4, 16)
    singles = [port.NativeSilkFrontEnd(16) for _ in range(4)]
    for f in range(8):
        payloads = [s[f] for s in streams]
        xq, rngs = batch.decode_batch(payloads)
        want_xq, want_rngs = batch_ref.decode_batch(payloads)
        assert np.array_equal(xq, want_xq) and np.array_equal(rngs, want_rngs)
        for i, one in enumerate(singles):
            assert np.array_equal(one.decode(payloads[i])[0], xq[i])
            assert one.final_range == int(rngs[i])


@needs_libopus
@pytest.mark.parametrize("channels,frame,kbps,downsample", [(2, 960, 128, 1), (1, 480, 48, 1),
                                                             (2, 240, 64, 2)])
def test_native_celt_front_end_equals_reference(channels, frame, kbps, downsample):
    """NativeCeltFrontEnd.decode_planes: every plane equal to the reference
    wrapper's, final ranges equal, through a reset and a band limit."""
    from opus_tpu import parse_packet
    from opus_tpu.native import frontend as ref
    from opus_tpu_torch.native import frontend as port

    pkts = [p[parse_packet(p).payload_offset :] for p in
            _libopus_packets("celt", "FB", channels, frame // 48, kbps, 8, seed=9)]
    nat, nat_ref = port.NativeCeltFrontEnd(channels, downsample), \
        ref.NativeCeltFrontEnd(channels, downsample)
    for f, payload in enumerate(pkts):
        if f == 4:
            for d in (nat, nat_ref):
                d.reset()
                d.end_band = 17
        got = nat.decode_planes(payload, frame // downsample)
        want = nat_ref.decode_planes(payload, frame // downsample)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k], v), (f, k)
        assert nat.final_range == nat_ref.final_range


def test_native_silk_encoder_equals_reference():
    """NativeSilkEncoder (no Encoder session reaches it): equal payloads and
    final ranges at 8 and 16 kHz, through a reset."""
    from opus_tpu.native import frontend as ref
    from opus_tpu_torch.native import frontend as port

    for fs in (8, 16):
        x = np.round(_signal(fs * 1000, fs * 20 * 6, 1, seed=fs)[:, 0] * 32767).astype(np.int16)
        encs = [port.NativeSilkEncoder(fs), ref.NativeSilkEncoder(fs)]
        for f in range(6):
            if f == 3:
                for e in encs:
                    e.reset()
            got, want = (e.encode(x[f * fs * 20 : (f + 1) * fs * 20], 40) for e in encs)
            assert got == want and encs[0].final_range == encs[1].final_range
    with pytest.raises(ValueError):
        port.NativeSilkEncoder(11)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["plan", "mixed"])
def test_device_decoders_held_to_the_scalar_decoder(path, cuda_device):
    """At B=64 every stream of the plan (CELT) or mixed path, served on the
    card, against the port's Decoder on the same packets: equal final
    ranges every step, PCM max-abs < 1e-3 (tests/test_mixed_plan.py:56),
    RFC 8251 score >= 90 over each stream's frames."""
    import chip_smoke as cs
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    old_b, cs.B = cs.B, 64
    try:
        clean = cs.make_payloads()
        rows = list(range(64))
        if path == "plan":
            dec = BatchedCeltDecoder(64, cs.C, transfer="plan", device=cuda_device)
            got = cs.serve_steps(dec, clean, rows)
            columns = [[cs.TOC_CELT + pk[i] for pk in clean] for i in rows]
        else:
            mixed = cs.make_mixed_payloads(clean)
            dec = BatchedOpusDecoder(64, cs.C, transfer="plan", silk_transfer="internal",
                                     device=cuda_device)
            got = cs.serve_mixed_steps(dec, mixed, sample=rows)
            columns = [[pk[i] for pk in mixed] for i in rows]
    finally:
        cs.B = old_b
    held = cs.hold_to_scalar(path, got["sample"], columns, gate=True)
    assert held["ranges_equal"] == held["decoded"] == 64 * cs.STEPS
