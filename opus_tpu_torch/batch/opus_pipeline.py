"""Batched mixed-mode Opus decode on a torch device (the port of
opus_tpu.batch.opus_pipeline.BatchedOpusDecoder).

CELT, SILK and hybrid streams decode in one batch, one frame per stream
per step:

* Plane A (host): the ToC of every packet is parsed here (packet.py), and
  one native call per step (native/frontend.py NativeOpusFrontEnd) runs
  every stream's SILK fixed-point synthesis and its CELT symbol decode
  behind the shared range coder of hybrid streams.  Losses are concealed
  there (the exact SILK PLC; the noise regime of CELT), except a CELT
  stream's first lost frames, which plane A flags for the device conceal.
* Plane B (device): the serving steps of dsp/synthesis.py synthesise the
  CELT plane of the whole batch (the plan executor first rebuilds the
  spectra on the plan transfer), add the SILK PCM, resampled on the device
  when it ships at the internal rate, and write the step's PCM ring.  On
  a CUDA device serve() replays each step variant from a CUDA graph
  captured at its first step (dsp/graphs.py); on the CPU the steps run
  eagerly.

Fast-path contract (steady-state serving): one Opus frame per packet and
one frame duration per step; violations raise with the stream index.  A
packet entry is bytes, None (lost) or ("fec", next_packet) (recover the
lost frame from the next packet's SILK LBRR).  Mode and bandwidth
switches get the scalar decoder's exact transition PCM: plane A reports a
transition descriptor per stream, the redundant 5 ms CELT blocks of a
switch are decoded on the host by a shadow scalar CELT decoder per
stream (_collect_corrections, celt/decoder.py), and the windowed
crossfades land on the device ring after the step (dsp/transitions.py).
The one approximation left is the reference's: the first <=5 ms of a
switch into CELT whose transition depends on the CELT decode memory on
the device.  The serve loops open the tracer's spans as batch/pipeline.py
lays them out.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import packet as pkt_mod
from .. import trace
from ..celt import modes
from ..celt.decoder import CeltDecoder
from ..dsp.synthesis import (
    SynthState,
    _silk_words,
    init_state,
    make_opus_step,
    make_plan_serving_step,
    make_serving_step,
)
from ..dsp.tables import PACK_BITS, XQ_WORDS, packed_offsets, pf_chunk_for
from ..dsp.transitions import apply_corrections
from ..native.frontend import (
    PLAN_ARENA_WORDS,
    NativeOpusFrontEnd,
    compact_plan_silk,
    pack_plan_silk,
    plan_slot_views,
    plan_slot_words,
)
from .pipeline import ServingSlots

_MODE_CODE = {pkt_mod.CodecMode.SILK_ONLY: 0, pkt_mod.CodecMode.HYBRID: 1,
              pkt_mod.CodecMode.CELT_ONLY: 2}
TRANSFERS = ("p12", "p10", "p8", "plan")
#: A redundant CELT block's end band by ToC bandwidth (NB, MB, WB, SWB, FB).
CELT_END_BAND = (13, 17, 17, 19, 21)


class BatchedOpusDecoder(ServingSlots):
    """Decode a fixed batch of Opus streams (any mode), one frame per step.

    transfer: "plan" (the CELT plane as pulse vectors and a band plan, the
    spectra rebuilt on the device; a step whose plan overflows falls back
    to the packed form for that step) or a packed spectral form
    "p12"/"p10"/"p8".  silk_transfer: "pcm48" ships SILK PCM at 48 kHz,
    "internal" at the SILK internal rate (3x fewer words), resampled on
    the device; decode_frames() and run_pipelined() need "pcm48".
    """

    NB = 21

    def __init__(self, batch: int, channels: int = 2, transfer: str = "p10",
                 silk_transfer: str = "pcm48", *, device):
        if transfer not in TRANSFERS:
            raise ValueError(f"transfer {transfer!r} not in {TRANSFERS}")
        if silk_transfer not in ("pcm48", "internal"):
            raise ValueError(f"unknown silk_transfer {silk_transfer!r}")
        self.batch = batch
        self.channels = channels
        self.transfer = transfer
        self.silk_internal = silk_transfer == "internal"
        self.device = torch.device(device)
        self.native = NativeOpusFrontEnd(batch, channels, self.silk_internal)
        self.state = init_state(batch, channels, device=self.device)
        self._init_serving()
        #: plan steps served on the packed path because the plan overflowed
        self.plan_fallbacks = 0
        # decode_frames' double-buffered planes
        self._frame_slots = [
            dict(x=np.zeros((batch, 2 * 960), np.float32),
                 ble=np.zeros((batch, 2, self.NB), np.float32),
                 meta=np.zeros((batch, 16), np.int32),
                 gains=np.zeros((batch, 3), np.float32),
                 silk=np.zeros((batch, 2880 * channels), np.int16))
            for _ in range(2)
        ]
        self._frame_slot = 0
        # the redundant-block shadow decoders (_collect_corrections)
        self._shadow: dict = {}
        self._shadow_warm = np.zeros(batch, bool)

    def final_ranges(self) -> list[int]:
        return [int(r) for r in self.native.ranges]

    # --- plane A --------------------------------------------------------

    def _toc_arrays(self, packets: list):
        """The step's ToC arrays (frame48, (blob, lens, modes, bws,
        frame48, schs)).  A lost packet has lens 0; an FEC entry has lens
        -len(payload) (opus_frontend.cpp convention)."""
        B = self.batch
        if len(packets) != B:
            raise ValueError(f"{len(packets)} packets for a batch of {B}")
        modes_np = np.zeros(B, np.int32)
        bws = np.zeros(B, np.int32)
        schs = np.zeros(B, np.int32)
        lens = np.zeros(B, np.int32)
        payloads = []
        frame48 = None
        for i, pkt in enumerate(packets):
            if pkt is None:  # lost: plane A conceals from the stream's state
                payloads.append(b"")
                continue
            fec = isinstance(pkt, tuple)
            if fec:
                kind, pkt = pkt
                if kind != "fec":
                    raise ValueError(f"stream {i}: unknown packet entry {kind!r}")
            parsed = pkt_mod.parse_packet(pkt)
            if parsed.frame_count != 1:
                raise ValueError(f"stream {i}: multi-frame packets use the scalar path")
            f48 = pkt_mod.query_packet_samples_per_frame(pkt, 48000)
            if frame48 is None:
                frame48 = f48
            elif frame48 != f48:
                raise ValueError("mixed frame durations in one step not supported")
            modes_np[i] = _MODE_CODE[pkt_mod.query_packet_codec_mode(pkt)]
            bws[i] = int(pkt_mod.query_packet_bandwidth(pkt)) - int(pkt_mod.Bandwidth.NARROWBAND)
            schs[i] = 2 if (pkt[0] & 0x4) else 1
            pay = pkt[parsed.payload_offset :]
            payloads.append(pay)
            lens[i] = -len(pay) if fec else len(pay)
        if frame48 is None:  # every stream lost this step
            frame48 = getattr(self, "_last_frame48", None)
            if frame48 is None:
                raise ValueError("a first step with every packet lost has no frame size")
        self._last_frame48 = frame48
        return frame48, (b"".join(payloads), lens, modes_np, bws, frame48, schs)

    def _collect_corrections(self, packets, rcs, toc) -> list:
        """Plane A's transition descriptors -> the ring's crossfade rows
        [(stream, kind, pcm [240, C] f32)], empty on ordinary steps.

        A descriptor (opus_frontend.cpp opus_fe_decode) packs bit 0 a
        redundant CELT block present, bit 1 celt_to_silk, bits 2-12 its
        bytes, bits 13-23 its offset in the payload, bit 24 a SILK/hybrid
        -> CELT switch.  Kind 0 replaces and fades the frame head: plane
        A's 10 ms SILK PLC row on a switch into CELT, or the redundant
        block of a celt_to_silk switch; kind 1 fades the tail into the
        redundant block of a silk_to_celt switch.  The blocks are decoded
        by a shadow CeltDecoder per stream, reset for silk_to_celt; a
        celt_to_silk block continues the CELT state, so it is decoded
        only from a warm shadow (one whose last CELT activity was a
        redundant block; a real CELT or hybrid frame, decoded on the
        device, makes it cold) and is otherwise left uncorrected, as in
        the reference.  Call once per step, after plane A succeeded: every
        call advances the shadows."""
        _, _, modes_np, bws, _, schs = toc
        corrs = []
        for ii in np.flatnonzero(rcs > 0):
            i = int(ii)
            desc = int(rcs[i])
            red_present = desc & 1
            celt_to_silk = (desc >> 1) & 1
            red_bytes = (desc >> 2) & 0x7FF
            red_off = (desc >> 13) & 0x7FF
            if desc & (1 << 24) and not red_present:
                C = self.channels
                trans = self.native.trans[i, : 240 * C].reshape(240, C)
                corrs.append((i, 0, trans.astype(np.float32) / 32768.0))
            if not red_present:
                continue
            pkt = packets[i][1] if isinstance(packets[i], tuple) else packets[i]
            sh = self._shadow.get(i)
            if sh is None:
                sh = self._shadow[i] = CeltDecoder(self.channels, 1)
            red = pkt[pkt_mod.parse_packet(pkt).payload_offset :][red_off : red_off + red_bytes]
            if not celt_to_silk:
                sh.reset()
            if (not celt_to_silk or self._shadow_warm[i]) and len(red) == red_bytes > 0:
                sh.start_band = 0
                sh.end_band = CELT_END_BAND[int(bws[i])]
                sh.stream_channels = int(schs[i])
                try:
                    trace.count("shadow_decodes")
                    pcm = np.asarray(sh.decode(red, 240), np.float32)
                except Exception:  # noqa: BLE001
                    # The reference's boundary: an undecodable block leaves
                    # its stream's frame uncorrected and its shadow cold,
                    # and the batch serves on.
                    self._shadow_warm[i] = False
                    continue
                corrs.append((i, 0 if celt_to_silk else 1, pcm))
                self._shadow_warm[i] = True
            else:
                self._shadow_warm[i] = False
        if self._shadow:
            self._shadow_warm[modes_np != 0] = False
        return corrs

    def _plane_a_packed(self, packets: list, slot: dict) -> list:
        with trace.span("toc"):
            frame48, toc = self._toc_arrays(packets)
        if frame48 != slot["frame48"]:
            raise ValueError("frame duration changed mid-serve")
        with trace.span("plane_a"):
            rcs = self.native.decode_batch_packed_into(toc, slot, PACK_BITS[slot["mode"]])
        with trace.span("corrections"):
            return self._collect_corrections(packets, rcs, toc)

    def _plane_a_plan(self, packets: list, slot: dict) -> list:
        """Plan-mode decode into a mixed plan slot, the SILK rows compacted.
        Raises OverflowError when the arena or a plan capacity overflows
        (the serve loop decodes the step on the packed path instead)."""
        with trace.span("toc"):
            frame48, toc = self._toc_arrays(packets)
        if frame48 != slot["frame48"]:
            raise ValueError("frame duration changed mid-serve")
        with trace.span("plane_a"):
            rcs = self.native.decode_batch_plan_into(toc, slot)
        with trace.span("silk_pack"):
            compact_plan_silk(slot, self._silk_shape(frame48)[0])
        with trace.span("corrections"):
            return self._collect_corrections(packets, rcs, toc)

    def _silk_shape(self, frame48: int) -> tuple[int, int]:
        """(int16 samples, int32 words) of a stream's SILK region."""
        return _silk_words(int(np.log2(frame48 // 120)), self.channels, self.silk_internal)

    # --- decode_frames (48 kHz SILK, one functional step) ----------------

    def _frames_plane_a(self, packets: list) -> tuple[int, dict]:
        """Plane A of decode_frames and run_pipelined into the next of two
        slots (f32 spectra, 48 kHz SILK PCM): (frame48, slot)."""
        if self.silk_internal:
            raise ValueError("decode_frames and run_pipelined need silk_transfer='pcm48' "
                             "(internal-rate SILK is a serve()-only transfer)")
        frame48, toc = self._toc_arrays(packets)
        slot = self._frame_slots[self._frame_slot]
        self._frame_slot = 1 - self._frame_slot
        self.native.decode_batch(toc, slot)
        return frame48, slot

    def decode_frames(self, packets: list) -> np.ndarray:
        """One step: decode one frame per stream -> pcm [B, frame48, C]."""
        return self.decode_frames_on_device(packets).cpu().numpy()

    def decode_frames_on_device(self, packets: list) -> torch.Tensor:
        """decode_frames with the pcm on the device."""
        frame48, slot = self._frames_plane_a(packets)
        if frame48 > 960:
            # 40/60 ms packets are SILK-only; no CELT step is needed.
            silk = slot["silk"][:, : frame48 * self.channels]
            pcm = silk.reshape(self.batch, frame48, self.channels).astype(np.float32) / 32768.0
            return torch.from_numpy(pcm).to(self.device)
        return self._dispatch(frame48, slot)

    def run_pipelined(self, batches: list):
        """Decode a sequence of steps, one step in flight (see
        ServingSlots._one_in_flight); returns the last step's PCM on the
        device, [B, frame48, C] f32.  A step of 40/60 ms SILK-only frames
        returns the raw int16 SILK region [B, frame48 * C], as the
        reference does (unlike decode_frames' float PCM)."""

        def dispatch(prepared):
            frame48, slot = prepared
            if frame48 > 960:
                return torch.tensor(slot["silk"][:, : frame48 * self.channels],
                                    device=self.device)
            return self._dispatch(frame48, slot)

        return self._one_in_flight(self._frames_plane_a, dispatch, batches)

    def _dispatch(self, frame48: int, slot: dict):
        meta = slot["meta"]
        lm = int(np.log2(frame48 // 120))
        bound = (1 << lm) * modes.E_BANDS[meta[:, 5]]
        bound = np.where(meta[:, 0] != 0, 0, bound).astype(np.int32)
        periods = np.maximum(meta[:, 6:9], 15).astype(np.int32)  # comb_filter MINPERIOD
        short_mask = meta[:, 1] != 0
        args = [slot["x"], meta[:, 3] == 1, slot["ble"], bound, periods, slot["gains"],
                np.ascontiguousarray(meta[:, 9:12]), slot["silk"][:, : frame48 * self.channels]]
        targs = [torch.as_tensor(a).to(self.device) for a in args]
        if not short_mask.any() or short_mask.all():
            self.state, pcm = self._opus_step(lm, bool(short_mask[0]))(self.state, *targs)
            return pcm
        state_long, pcm_long = self._opus_step(lm, False)(self.state, *targs)
        state_short, pcm_short = self._opus_step(lm, True)(self.state, *targs)
        msk = torch.as_tensor(short_mask).to(self.device)
        self.state = SynthState(
            torch.where(msk[:, None, None], state_short.mem, state_long.mem),
            torch.where(msk[:, None], state_short.preemph, state_long.preemph))
        return torch.where(msk[:, None, None], pcm_short, pcm_long)

    def _opus_step(self, lm: int, short_blocks: bool):
        key = ("frames", lm, short_blocks)
        if key not in self._steps:
            self._steps[key] = make_opus_step(lm, short_blocks, self.channels,
                                              device=self.device)
        return self._steps[key]

    # --- the serving loop -------------------------------------------------

    def _packed_mode(self) -> str:
        """Spectral form of the packed path (also the plan loop's fallback)."""
        return self.transfer if self.transfer in PACK_BITS else "p10"

    def _mixed_serving_step(self, lm: int, pf_chunk: int, pf_active: bool, with_plc):
        key = ("serve", lm, pf_chunk, pf_active, with_plc)
        return self._served(key, lambda: make_serving_step(
            lm, self.batch, self.channels, pf_chunk=pf_chunk, pf_active=pf_active,
            transfer=self._packed_mode(), silk_mix=True, silk_internal=self.silk_internal,
            with_plc=with_plc, device=self.device))

    def _mixed_plan_serving_step(self, lm: int, pf_chunk: int, pf_active: bool,
                                 size_class: tuple, with_plc):
        key = ("plan", lm, pf_chunk, pf_active, size_class, with_plc)
        return self._served(key, lambda: make_plan_serving_step(
            lm, self.batch, self.channels, pf_chunk=pf_chunk, pf_active=pf_active,
            size_class=size_class, with_plc=with_plc, silk_mix=True,
            silk_internal=self.silk_internal, device=self.device))

    def _alloc_packed_slots(self, frame48: int, n_slots: int) -> tuple[list, torch.Tensor]:
        """Packed mixed slots (packed_offsets with the SILK region) over
        pinned host buffers, and the device buffer they upload into (one a
        frame length, kept: `_device_buffer`)."""
        B = self.batch
        mode = self._packed_mode()
        sw = self._silk_shape(frame48)[1]
        off = packed_offsets(B, mode, sw)
        slots = []
        for _ in range(n_slots):
            host, copied = self._host_buffer(off["end"])
            buf = host.numpy()
            slots.append(dict(
                host=host, buf=buf, mode=mode, frame48=frame48, copied=copied,
                xq=buf[off["xq"] : off["silk"]].reshape(B, XQ_WORDS[mode]),
                silk=buf[off["silk"] : off["ble"]].view(np.int16).reshape(B, 2 * sw),
                ble=buf[off["ble"] : off["meta"]].view(np.float32).reshape(B, 2, self.NB),
                meta=buf[off["meta"] : off["gains"]].reshape(B, 16),
                gains=buf[off["gains"] : off["end"]].view(np.float32).reshape(B, 3),
            ))
        return slots, self._device_buffer(("packed", frame48), off["end"])

    def _alloc_plan_slots(self, frame48: int, n_slots: int) -> tuple[list, torch.Tensor]:
        """Mixed plan slots (plan_slot_views with the SILK staging and row
        map) over pinned host buffers, each behind its head
        (`_plan_host_buffer`), and their device buffer (head and slot; one
        a frame length, kept)."""
        sw = self._silk_shape(frame48)[1]
        words = plan_slot_words(self.batch, PLAN_ARENA_WORDS, sw)
        slots = []
        for _ in range(n_slots):
            bufs = self._plan_host_buffer(words)
            slot = plan_slot_views(bufs["host"].numpy(), self.batch, PLAN_ARENA_WORDS, sw)
            slot.update(bufs, frame48=frame48)
            slots.append(slot)
        return slots, self._device_buffer(("plan", frame48), self.PLAN_HEAD + words)

    def _serve_state_and_ring(self, frame48: int):
        state = getattr(self, "_serve_state", None)
        if state is None:
            state = self._serve_state = init_state(self.batch, self.channels, device=self.device,
                                                   silk_hist=self.silk_internal)
        self._serve_ring = self._ring(frame48)
        return state, self._serve_ring

    def _step_picks(self, slot) -> tuple:
        """The host's per-step picks from the slot: (lm, post-filter chunk,
        active, concealment variant)."""
        meta = slot["meta"]
        chunk, active = pf_chunk_for(meta[:, 6:9], slot["gains"])
        return self._step_lm(meta), chunk, active, self._plc_variant(meta)

    def _packed_step(self, packets, slot, dev_buf, state, ring):
        """Plane A into a packed mixed slot, one upload, one serving step,
        then the transition crossfades on the ring."""
        self._reuse(slot)
        corrs = self._plane_a_packed(packets, slot)
        with trace.span("issue"):
            lm, chunk, active, with_plc = self._step_picks(slot)
            self._upload(slot, dev_buf, dev_buf.shape[0])
            slot["upload_words"] = dev_buf.shape[0]
            plc = self._serve_plc_state(self.channels) if with_plc else ()
            step = self._mixed_serving_step(lm, chunk, active, with_plc)
            _, _, digest = self._call_step(step, state, ring, dev_buf, *plc)
        with trace.span("crossfade"):
            apply_corrections(ring, corrs, slot["frame48"])
        return digest

    def serve(self, batches: list, n_slots: int = 4) -> np.ndarray:
        """Serving loop: per step, plane A writes one pinned slot, one
        host-to-device copy ships it, one serving step synthesises it; all
        device work is asynchronous, so plane A of step t+1 runs while the
        device runs step t (a slot is rewritten only after its previous
        copy completed).  Frames of 20 ms or shorter (longer SILK-only
        frames never touch the device: use decode_frames).  State, PCM ring
        and the conceal's LPC and pitch persist across calls.  On a CUDA
        device a step is the replay of its variant's CUDA graph.

        Returns the final step's digest (np[2]); the last frame's PCM stays
        on the device in `self._serve_ring` [B, frame48, C]."""
        with trace.span("serve_call", step=self.steps_served):
            return self._serve(batches, n_slots)

    def _serve(self, batches: list, n_slots: int) -> np.ndarray:
        first = next((p for row in batches for p in row if p is not None), None)
        if first is None:
            # an all-lost call keeps concealing at the session's frame length
            frame48 = getattr(self, "_last_frame48", None)
            if frame48 is None:
                raise ValueError("serve(): every packet in every step is lost")
        else:
            frame48 = pkt_mod.query_packet_samples_per_frame(
                first[1] if isinstance(first, tuple) else first, 48000)
        if frame48 > 960:
            raise ValueError("serve() handles <=20 ms frames; use decode_frames")
        if self.transfer == "plan":
            return self._serve_plan(batches, frame48, n_slots)
        if (getattr(self, "_pk_slots", None) is None or len(self._pk_slots) != n_slots
                or self._pk_slots[0]["frame48"] != frame48):
            self._pk_slots, self._pk_buf = self._alloc_packed_slots(frame48, n_slots)
        state, ring = self._serve_state_and_ring(frame48)
        digest = None
        for t, packets in enumerate(batches):
            with trace.span("step", step=self._next_step()):
                digest = self._packed_step(packets, self._pk_slots[t % n_slots], self._pk_buf,
                                           state, ring)
        return self._wait(digest)

    def _serve_plan(self, batches: list, frame48: int, n_slots: int) -> np.ndarray:
        """Plan-mode serving loop: per step the upload is the plan slot's
        used prefix (fixed regions, used arena) and the compacted SILK rows
        right after it, behind the slot's head, which carries where the
        rows start and where the upload ends; the device rebuilds the CELT
        spectra with the plan executor.  A step whose plan overflows a
        capacity is decoded again on the packed path for just that step
        (the state is shared)."""
        if (getattr(self, "_plan_slots", None) is None or len(self._plan_slots) != n_slots
                or self._plan_slots[0]["frame48"] != frame48):
            self._plan_slots, self._plan_buf = self._alloc_plan_slots(frame48, n_slots)
        if (getattr(self, "_fallback_slots", None) is None
                or self._fallback_slots[0]["frame48"] != frame48):
            self._fallback_slots, self._fallback_buf = self._alloc_packed_slots(frame48, 2)
        state, ring = self._serve_state_and_ring(frame48)
        digest = None
        for t, packets in enumerate(batches):
            with trace.span("step", step=self._next_step()):
                slot = self._plan_slots[t % n_slots]
                self._reuse(slot)
                try:
                    corrs = self._plane_a_plan(packets, slot)
                except OverflowError:
                    # Pathological content: ship this step as a packed
                    # spectrum (plane A restored every stream's state)
                    # instead of failing.
                    pk = self._fallback_slots[self.plan_fallbacks % 2]
                    self.plan_fallbacks += 1
                    with trace.span("overflow_step"):
                        digest = self._packed_step(packets, pk, self._fallback_buf, state, ring)
                    continue
                with trace.span("silk_pack"):
                    silk_at, words = pack_plan_silk(slot)
                with trace.span("issue"):
                    lm, chunk, active, with_plc = self._step_picks(slot)
                    slot["upload_words"] = words
                    buf, end, at = self._upload_plan(slot, self._plan_buf, words, silk_at)
                    plc = self._serve_plc_state(self.channels) if with_plc else ()
                    step = self._mixed_plan_serving_step(lm, chunk, active,
                                                         self._plan_size_class(slot), with_plc)
                    _, _, digest = self._call_step(step, state, ring, buf, *plc, end=end,
                                                   silk_at=at)
                with trace.span("crossfade"):
                    apply_corrections(ring, corrs, frame48)
        return self._wait(digest)
