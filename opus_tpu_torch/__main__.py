"""The command-line codec, a copy of opus_tpu.__main__: WAV <-> Ogg Opus.

Usage:
    python -m opus_tpu_torch encode in.wav out.opus [--bitrate 64000]
        [--application music|voice|hybrid] [--frame-ms 20] [--vbr] [--dtx]
    python -m opus_tpu_torch decode in.opus out.wav [--rate 48000]
    python -m opus_tpu_torch info  in.opus

The container is Ogg Opus (RFC 7845, ogg.py); WAV IO is 16-bit PCM via
the stdlib wave module.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py and tests/test_torch_cli.py hold the two
equal).
"""

from __future__ import annotations

import argparse
import sys
import wave

import numpy as np

from .decoder import Decoder, DecoderConfiguration
from .encoder import Encoder, EncoderConfiguration
from .ogg import OggOpusReader, OggOpusWriter, OpusHead
from .types import Channels, SamplingRate


def _read_wav(path: str):
    with wave.open(path, "rb") as w:
        assert w.getsampwidth() == 2, "16-bit WAV only"
        rate = w.getframerate()
        ch = w.getnchannels()
        raw = w.readframes(w.getnframes())
    pcm = np.frombuffer(raw, dtype=np.int16).reshape(-1, ch).astype(np.float32) / 32768.0
    return pcm, rate, ch


def _write_wav(path: str, pcm: np.ndarray, rate: int) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(pcm, -1, 1) * 32767.0).astype(np.int16).tobytes())


def cmd_encode(args) -> int:
    pcm, rate, ch = _read_wav(args.infile)
    if rate not in (8000, 12000, 16000, 24000, 48000):
        print(f"unsupported WAV rate {rate}", file=sys.stderr)
        return 1
    cfg = EncoderConfiguration(
        SamplingRate(rate), Channels(ch), args.bitrate,
        application=args.application, vbr=args.vbr, dtx=args.dtx,
        bandwidth=args.bandwidth,
    )
    enc = Encoder(cfg)
    frame = rate * args.frame_ms // 1000
    n_frames = len(pcm) // frame
    head = OpusHead(channels=ch, input_sample_rate=rate, pre_skip=0)
    with open(args.outfile, "wb") as f:
        writer = OggOpusWriter(f, head)
        for i in range(n_frames):
            pkt = enc.encode(pcm[i * frame : (i + 1) * frame])
            writer.write_packet(pkt, frame * 48000 // rate,
                                end_of_stream=i == n_frames - 1)
        writer.close()
    kbps = 0.0
    import os

    kbps = os.path.getsize(args.outfile) * 8 / (n_frames * args.frame_ms)
    print(f"encoded {n_frames} x {args.frame_ms} ms ({args.application}) "
          f"-> {args.outfile} ({kbps:.1f} kbps incl. container)")
    return 0


def cmd_decode(args) -> int:
    reader = OggOpusReader(open(args.infile, "rb").read())
    rate = args.rate
    dec = None
    chunks = []
    for pkt in reader.packets[2:]:  # [0]=OpusHead, [1]=OpusTags
        if dec is None:
            from . import query_packet_channel_count

            ch = query_packet_channel_count(pkt)
            dec = Decoder(DecoderConfiguration(SamplingRate(rate), Channels(ch)))
        chunks.append(dec.decode_float(pkt, rate * 120 // 1000))
    if not chunks:
        print("no audio packets", file=sys.stderr)
        return 1
    pcm = np.concatenate(chunks)
    # RFC 7845: drop pre-skip samples, trim to the final granule position
    # (both counted at 48 kHz).
    head = reader.head
    skip = head.pre_skip * rate // 48000
    end = reader.granules[-1] * rate // 48000 if reader.granules else len(pcm)
    pcm = pcm[skip : max(skip, min(len(pcm), skip + end))]
    _write_wav(args.outfile, pcm, rate)
    print(f"decoded {len(chunks)} packets -> {args.outfile} "
          f"({len(pcm) / rate:.2f} s @ {rate} Hz, final_range {dec.final_range:#010x})")
    return 0


def cmd_info(args) -> int:
    from . import parse_packet, query_packet_bandwidth, query_packet_codec_mode

    reader = OggOpusReader(open(args.infile, "rb").read())
    n = 0
    total = 0
    first = None
    for pkt in reader.packets[2:]:
        if first is None:
            first = pkt
        n += 1
        total += len(pkt)
    if first is None:
        print("no audio packets")
        return 1
    parsed = parse_packet(first)
    print(f"packets: {n}, bytes: {total}, first packet: "
          f"mode={query_packet_codec_mode(first).name} "
          f"bw={query_packet_bandwidth(first).name} "
          f"frames={parsed.frame_count}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="opus_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("encode")
    e.add_argument("infile")
    e.add_argument("outfile")
    e.add_argument("--bitrate", type=int, default=64000)
    e.add_argument("--application", choices=["music", "voice", "hybrid"], default="music")
    e.add_argument("--frame-ms", type=int, default=20, choices=[10, 20, 40, 60])
    e.add_argument("--vbr", action="store_true")
    e.add_argument("--dtx", action="store_true")
    e.add_argument("--bandwidth", choices=["NB", "MB", "WB", "SWB", "FB"], default="FB")
    e.set_defaults(fn=cmd_encode)
    d = sub.add_parser("decode")
    d.add_argument("infile")
    d.add_argument("outfile")
    d.add_argument("--rate", type=int, default=48000)
    d.set_defaults(fn=cmd_decode)
    i = sub.add_parser("info")
    i.add_argument("infile")
    i.set_defaults(fn=cmd_info)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
