"""Adapter: the program's mixed-mode batch decoder,
`opus_tpu_torch.batch.opus_pipeline.BatchedOpusDecoder`.

It takes whole Opus packets (CELT, SILK and hybrid in one batch) and
serves steps of 20 ms at 48 kHz; the last step's PCM stays on the device
in `_serve_ring` [streams, 960, channels].
"""

from __future__ import annotations

import numpy as np


#: the decoder's host decodes of one step (plane A and its corrections; the
#: plan transfer's, the packed transfers'), which check.Captures wraps to
#: read every step's final ranges inside a many-step call
PLANE_A = ("_plane_a_plan", "_plane_a_packed")


def make(decoder: dict, streams: int, device):
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    return BatchedOpusDecoder(streams, decoder["channels"], transfer=decoder["transfer"],
                              silk_transfer=decoder["silk_transfer"], device=device)


def entry(packet: bytes) -> bytes:
    if packet[0] & 3:
        raise ValueError(f"not a single-frame packet: ToC {packet[0]:#x}")
    return packet


def serve(dec, steps: list) -> None:
    dec.serve(steps)


def ring(dec):
    return dec._serve_ring


def ranges(dec) -> np.ndarray:
    return np.asarray(dec.final_ranges(), np.uint32)
