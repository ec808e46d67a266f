"""Adapter: the program's CELT-only batch decoder,
`opus_tpu_torch.batch.pipeline.BatchedCeltDecoder`.

It takes each stream's CELT payload (the packet behind its one-byte ToC:
every pool packet of a CELT-only configuration is a single 20 ms frame)
and serves steps of 960 samples at 48 kHz; the last step's PCM stays on
the device in `_serve_ring` [streams, 960, channels].
"""

from __future__ import annotations

import numpy as np

FRAME = 960


#: the decoder's host decodes of one step (plane A; the plan transfer's,
#: the packed transfers'), which check.Captures wraps to read every step's
#: final ranges inside a many-step call
PLANE_A = ("native.decode_batch_plan_into", "native.decode_batch_q15_into")


def make(decoder: dict, streams: int, device):
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    return BatchedCeltDecoder(streams, decoder["channels"], transfer=decoder["transfer"],
                              device=device)


def entry(packet: bytes) -> bytes:
    if packet[0] >> 3 < 16 or packet[0] & 3:
        raise ValueError(f"not a single-frame CELT-only packet: ToC {packet[0]:#x}")
    return packet[1:]


def serve(dec, steps: list) -> None:
    dec.serve(steps, FRAME)


def ring(dec):
    return dec._serve_ring


def ranges(dec) -> np.ndarray:
    return np.asarray(dec.final_ranges(), np.uint32)
