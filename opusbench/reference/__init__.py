"""The benchmark's plain reference: a scalar Opus decoder in numpy.

A frozen copy of the scalar decoder library of `opus_tpu_torch` at commit
e93197f: `decoder.py`, `packet.py`, `errors.py`, `mathops.py`,
`softclip.py`, `types.py`, `conformance.py` (the RFC 8251 quality
metric), and the packages `celt/` (bands, comb_filter, cwrs, decoder,
energy, mdct, modes, plc, rate, vq), `rc/` and `silk/` (api, bitstream,
decoder, fixed_math, nlsf, plc, resampler, stereo, tables), copied file
for file with the relative imports kept.  `multistream.py` is the decoder
half of the port's `multistream.py` at commit cd2dea1 (RFC 7845 sec.
5.1.1; its docstring lists what was changed), over the same frozen
`Decoder`.  It decodes one stream or session at a time on the host in
numpy and float64, imports nothing but numpy and the standard library,
and is not edited when the program is: it is the yardstick the benchmark
holds the batched device decoders to.  `opusbench/tests/test_bench_reference.py`
holds it to libopus.
"""

from .decoder import Decoder, DecoderConfiguration
from .multistream import family_decoder
from .types import Channels


def decoder(channels: int = 2) -> Decoder:
    """A fresh decoder to 48 kHz PCM of `channels` channels."""
    return Decoder(DecoderConfiguration(channels=Channels(channels)))


def reference_decoder(config: dict):
    """A fresh reference decoder for one stream of a configuration: for a
    configuration that names its channel layout (`layout`, RFC 7845
    channel mapping family 1) a multistream decoder of that layout, else
    the single-stream decoder of its `decoder` channels.  Either has
    `decode_float(packet or None, 960)` -> PCM [960, channels] and
    `final_range`."""
    if "layout" in config:
        return family_decoder(config["layout"])
    return decoder(config["decoder"]["channels"])


__all__ = ["Decoder", "DecoderConfiguration", "decoder", "reference_decoder"]
