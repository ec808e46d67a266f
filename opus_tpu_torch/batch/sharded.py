"""Serving decoders split over ranks (the port of the reference's
dp-sharded serving, `__graft_entry__.py:143-247`).

Each rank is one process with one device (mesh.init_ranks) and owns a
contiguous block of the batch (mesh.ShardSpec).  It serves that block with
an ordinary batched decoder of spec.local streams, plane A included: the
ranks never exchange packets or state, and a rank receives only its own
streams' packets, as a rank of a decoding fleet does.

    spec = ShardSpec(1024, world, rank)
    dec = BatchedCeltDecoder(spec.local, 2, transfer="plan", device=dev)
    dec.serve([spec.rows(packets) for packets in steps], 960)
    ring = gather_ring(dec)                      # [1024, 960, 2] on every rank

The whole batch's view (the PCM ring, the final ranges, the plan
fallbacks, the multistream frames) is assembled by the functions here
with all_gather, only when a caller asks for it; each is a collective,
called by every rank of the group together.

Each function takes the `group` to gather over (mesh.grid_groups' dp
group on a dp x tp grid, whose tp ranks serve the same streams), the
whole world by default.

The reference lets GSPMD split rows without regard to multistream
sessions, so its regroup gathers the elementary streams before it
interleaves them; here a rank owns whole sessions, un-maps them locally
and gathers the un-mapped frames (`gather_sessions`).
"""

from __future__ import annotations

import torch

from ..mesh import all_gather_rows, gather_ints
from .multistream_pipeline import BatchedMultistreamDecoder
from .opus_pipeline import BatchedOpusDecoder
from .pipeline import BatchedCeltDecoder


def gather_ring(dec: BatchedCeltDecoder | BatchedOpusDecoder, group=None) -> torch.Tensor:
    """The last served step's PCM of the whole batch, [B, frame, C], on
    every rank's device."""
    return all_gather_rows(dec._serve_ring, group)


def gather_sessions(dec: BatchedMultistreamDecoder, group=None) -> torch.Tensor:
    """The last served step's un-mapped frames of every session, [B,
    frame, channels], on every rank's device."""
    return all_gather_rows(dec.unmap_on_device(dec.core._serve_ring), group)


def gather_final_ranges(dec, group=None) -> list[int]:
    """Every stream's (or multistream session's) final range, in batch
    order."""
    return gather_ints(dec.final_ranges(), group)


def gather_fallbacks(dec: BatchedCeltDecoder | BatchedOpusDecoder, group=None) -> list[int]:
    """Each rank's count of plan steps served on the packed path (a
    multistream decoder's are its `core`'s): a rank whose streams are
    dense can overflow its plan arena where the others do not."""
    return gather_ints([dec.plan_fallbacks], group)
