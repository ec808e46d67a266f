"""Adapter: the program's multistream decoder,
`opus_tpu_torch.batch.multistream_pipeline.BatchedMultistreamDecoder`,
on its CELT core.

A stream of the benchmark is one RFC 7845 session: the adapter keeps its
whole multistream packet (one Opus packet for each elementary stream, all
but the last self-delimited) and serves steps of 960 samples at 48 kHz;
the last step's PCM stays on the device, un-mapped to the session's
channels, in `_serve_ring` [sessions, 960, channels].  The decoder's
settings name the layout (`channels`, `streams`, `coupled`, `mapping`),
as the configuration's `layout` does, and its core's `mode` and
`transfer`.
"""

from __future__ import annotations

import numpy as np

FRAME = 960

#: the core's host decodes of one step (plane A; the plan transfer's, the
#: packed transfers'), which check.Captures wraps to read every step's
#: final ranges inside a many-step call
PLANE_A = ("core.native.decode_batch_plan_into", "core.native.decode_batch_q15_into")


def make(decoder: dict, streams: int, device):
    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder

    dec = BatchedMultistreamDecoder(streams, decoder["channels"], decoder["streams"],
                                    decoder["coupled"], list(decoder["mapping"]),
                                    decoder["mode"], device=device)
    dec.core.transfer = decoder["transfer"]
    return dec


def entry(packet: bytes) -> bytes:
    """The whole multistream packet, checked to carry one frame a stream:
    its first elementary packet must be code 0 (one frame), and the
    program's split refuses a packet whose elementary streams disagree on
    their frame count.  (The harness hands entry the packet alone, so it
    cannot find the other elementary packets, which needs the stream
    count.)"""
    if not packet or packet[0] & 3:
        raise ValueError(f"not a multistream packet of single frames: first ToC "
                         f"{packet[:1].hex() or 'missing'}")
    return packet


def serve(dec, steps: list) -> None:
    dec.serve(steps, FRAME)


def ring(dec):
    return dec._serve_ring


def ranges(dec) -> np.ndarray:
    return np.asarray(dec.final_ranges(), np.uint32)
