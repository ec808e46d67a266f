"""The benchmark's plain reference: a scalar Opus decoder in numpy.

A frozen copy of the scalar decoder library of `opus_tpu_torch` at commit
e93197f: `decoder.py`, `packet.py`, `errors.py`, `mathops.py`,
`softclip.py`, `types.py`, `conformance.py` (the RFC 8251 quality
metric), and the packages `celt/` (bands, comb_filter, cwrs, decoder,
energy, mdct, modes, plc, rate, vq), `rc/` and `silk/` (api, bitstream,
decoder, fixed_math, nlsf, plc, resampler, stereo, tables), copied file
for file with the relative imports kept.  It decodes one stream at a time
on the host in numpy and float64, imports nothing but numpy and the
standard library, and is not edited when the program is: it is the
yardstick the benchmark holds the batched device decoders to.
`opusbench/tests/test_reference.py` holds it to libopus.
"""

from .decoder import Decoder, DecoderConfiguration
from .types import Channels


def decoder(channels: int = 2) -> Decoder:
    """A fresh decoder to 48 kHz PCM of `channels` channels."""
    return Decoder(DecoderConfiguration(channels=Channels(channels)))


__all__ = ["Decoder", "DecoderConfiguration", "decoder"]
