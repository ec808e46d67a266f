"""Batch-of-streams CELT decode on a torch device (the port of
opus_tpu.batch.pipeline.BatchedCeltDecoder).

* Plane A (host): the port's copy of the native C++ front end,
  opus_tpu_torch.native.frontend, walks every stream's range-coded
  symbols in one call per step.
* Plane B (device): the synthesis steps of opus_tpu_torch.dsp.synthesis
  turn the whole batch's planes into PCM at once; on the plan transfer
  the plan executor (dsp/plan_exec.py) first rebuilds the band spectra
  from plane A's pulse-vector plan.  On a CUDA device serve() captures
  each step variant once as a CUDA graph and replays it (dsp/graphs.py);
  on the CPU the steps run eagerly.

The serve loops open the tracer's spans (opus_tpu_torch/trace.py; no-ops
while it is off) at their layer boundaries, one tree a serve() call:

    serve_call                  one serve() call
      step                      one step (its id: `steps_served` before it)
        slot_wait               the slot's previous copy (_reuse)
        toc                     the ToC parse (mixed)
        plane_a                 the native decode
        silk_pack               the SILK rows' compaction and packing (mixed plan)
        corrections             the shadow decode of redundant blocks (mixed)
        issue                   the host's picks, the upload and the step call
          upload                the copy's enqueue and its event
          launch | graph_build  the step call | a variant's first call
        crossfade               the transitions on the ring (mixed)
        overflow_step           a plan overflow served on the packed path
      device_wait               the digest read at serve()'s end
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..celt import modes
from ..dsp.graphs import CapturedStep, SharedPool, eager
from ..dsp.synthesis import (
    SynthState,
    init_state,
    make_pipeline_step,
    make_plan_serving_step,
    make_serving_step,
)
from ..dsp.plc_scan import LPC_ORDER
from ..dsp.tables import PACK_BITS, XQ_WORDS, packed_offsets, pf_chunk_for
from ..native.frontend import (
    PLAN_ARENA_WORDS,
    PLAN_FIXED_WORDS,
    NativeBatchFrontEnd,
    plan_slot_views,
)

TRANSFERS = ("f32", "q14", "p12", "p10", "p8", "plan")


class ServingSlots:
    """What both decoders (BatchedCeltDecoder and the mixed-mode
    BatchedOpusDecoder) share: for their serve loops, pinned host slots
    with the CUDA event of their last copy, the upload, the device buffers
    and rings the serving steps are bound to, the steps themselves (a
    CUDA graph each on the card), and the host's per-step picks of the
    plan executor's size class and of the concealment variant; and the
    run_pipelined loop."""

    #: int32 words ahead of a plan slot in its upload: the step's device
    #: scalars (word 0 the upload's end, word 1 the SILK rows' offset, in
    #: words of the slot), padded so that the slot stays 16-byte aligned.
    PLAN_HEAD = 4

    #: Plan executor size classes (p_max, f_max, iyw): the leaf-table and
    #: pulse-word windows.  The serve loop picks the smallest class the
    #: step's maxima fit (96 kbps stereo music measures pvq <= 105,
    #: fill <= 3, iyw <= 114); anything larger runs the full class.
    PLAN_CLASSES = ((112, 8, 128), (160, 16, 160), (224, 64, 192))

    #: Compact loss-concealment capacity: a step whose pitch-regime
    #: loss count is at most this (and below the batch) conceals only its
    #: flagged streams, as a sub-batch of this many rows; a step with more
    #: conceals the whole batch.  At 5% loss and B=1024 a step loses
    #: about 51.
    PLC_COMPACT_K = 128

    def _plc_variant(self, meta) -> bool | int:
        """The step's concealment variant, from the slot's host meta (no
        device sync): False without pitch-regime losses, the compact
        capacity when the loss count fits it, else True (the whole batch)."""
        n_lost = int((meta[:, 14] & 1).sum())
        if 0 < n_lost <= self.PLC_COMPACT_K < self.batch:
            trace.count("plc_steps_compact")
            return self.PLC_COMPACT_K
        if n_lost:
            trace.count("plc_steps_whole")
        return n_lost > 0

    def _host_buffer(self, words: int):
        """(int32 host tensor, its CUDA event or None): pinned when the
        device is a GPU, so the copy to the device is asynchronous."""
        pin = self.device.type == "cuda"
        return (torch.zeros(words, dtype=torch.int32, pin_memory=pin),
                torch.cuda.Event() if pin else None)

    def _plan_host_buffer(self, words: int) -> dict:
        """A plan slot's pinned host buffer behind PLAN_HEAD words of
        head: {host: the slot's `words`, head: the whole buffer, copied}."""
        head, copied = self._host_buffer(self.PLAN_HEAD + words)
        return dict(host=head[self.PLAN_HEAD :], head=head, copied=copied)

    def _init_serving(self) -> None:
        """The serving steps by variant key, and what they are bound to:
        the device buffers by slot kind, the rings by frame length and, on
        a CUDA device, the graphs' shared pool; `steps_served` counts the
        serve loops' steps (the tracer's step id)."""
        self._steps: dict = {}
        self._built: set = set()
        self.steps_served = 0
        trace.watch(self)
        self._dev_bufs: dict = {}
        self._rings: dict = {}
        self._pool = SharedPool(self.device) if self.device.type == "cuda" else None

    def _device_buffer(self, key, words: int) -> torch.Tensor:
        """The int32 device buffer one kind of slot uploads into, made once
        per key and kept: a captured step is bound to its address."""
        if key not in self._dev_bufs:
            self._dev_bufs[key] = torch.empty(words, dtype=torch.int32, device=self.device)
        return self._dev_bufs[key]

    def _ring(self, frames: int) -> torch.Tensor:
        """The PCM ring [B, frames, C], one a frame length, kept (a
        captured step is bound to it)."""
        if frames not in self._rings:
            self._rings[frames] = torch.zeros(self.batch, frames, self.channels,
                                              device=self.device)
        return self._rings[frames]

    def _served(self, key, make):
        """The serving step of variant `key`, made by make() on first use:
        on a CUDA device a CapturedStep (captured on its first call and
        replayed after), on the CPU the step itself."""
        if key not in self._steps:
            step = make()
            self._steps[key] = step if self._pool is None else CapturedStep(step, self._pool)
        return self._steps[key]

    def _next_step(self) -> int:
        """The id of the step about to be served (and one more served)."""
        self.steps_served += 1
        return self.steps_served - 1

    def _call_step(self, step, *args, **kw):
        """The step call, in the span `launch` (a replay of the variant's
        CUDA graph, or the eager step on the CPU) or, at a variant's first
        call, `graph_build` (its eager run and capture on the card),
        counted in `graph_builds`."""
        first = step not in self._built
        if first:
            self._built.add(step)
            trace.count("graph_builds")
        with trace.span("graph_build" if first else "launch"):
            return step(*args, **kw)

    def _wait(self, digest) -> np.ndarray:
        """serve()'s end: the digest read, which waits for the last step,
        then the device phase times of the captured steps' last replays."""
        with trace.span("device_wait", step=self.steps_served - 1):
            out = digest.cpu().numpy()
        for step in self._steps.values():
            if getattr(step, "pending", None) is not None:
                step.read_phases()
        return out

    def _plan_size_class(self, slot) -> tuple:
        c = slot["header"][:, 1]
        pvq_mx = int((c & 0x1FF).max(initial=0))
        fill_mx = int(((c >> 9) & 0x1FF).max(initial=0))
        # the fetch window may touch one word past the last started one
        iyw_mx = int(slot["iy_spans"].max(initial=0)) + 1
        for cls in self.PLAN_CLASSES:
            if pvq_mx <= cls[0] and fill_mx <= cls[1] and iyw_mx <= cls[2]:
                return cls
        return self.PLAN_CLASSES[-1]

    @staticmethod
    def _step_lm(meta) -> int:
        lm = int(meta[0, 2])
        if not (meta[:, 2] == lm).all():
            raise ValueError("mixed frame sizes in one step not supported")
        return lm

    def _upload(self, slot, dev_buf, words: int) -> None:
        """Copy the slot's first `words` words to the device buffer and
        mark the copy, so the slot is not rewritten while it is in flight."""
        with trace.span("upload"):
            dev_buf[:words].copy_(slot["host"][:words], non_blocking=True)
            if slot["copied"] is not None:
                slot["copied"].record()
        trace.count("upload_bytes", 4 * words)

    def _upload_plan(self, slot, dev_buf, words: int, silk_at: int = 0) -> tuple:
        """The plan upload: the step's scalars into the slot's head, then
        head and the slot's first `words` words in one copy to dev_buf
        (PLAN_HEAD + the slot's words).  Returns the step's inputs bound to
        dev_buf: (the slot's words, end, silk_at), the last two 0-d
        views of the head on the device."""
        with trace.span("upload"):
            slot["head"].numpy()[:2] = words, silk_at
            dev_buf[: self.PLAN_HEAD + words].copy_(slot["head"][: self.PLAN_HEAD + words],
                                                    non_blocking=True)
            if slot["copied"] is not None:
                slot["copied"].record()
        trace.count("upload_bytes", 4 * (self.PLAN_HEAD + words))
        return dev_buf[self.PLAN_HEAD :], dev_buf[0], dev_buf[1]

    @staticmethod
    def _reuse(slot) -> None:
        with trace.span("slot_wait"):
            if slot["copied"] is not None:
                slot["copied"].synchronize()

    def _one_in_flight(self, plane_a, dispatch, batches: list):
        """The run_pipelined loop: per step, plane A on the host, then a
        wait on the previous step's CUDA event (not a device-wide sync),
        then the step's dispatch; one step is in flight while plane A of
        the next runs.  Returns the last dispatch's result, complete."""
        out = done = None
        for packets in batches:
            prepared = plane_a(packets)
            if done is not None:
                done.synchronize()
            out = dispatch(prepared)
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        if done is not None:
            done.synchronize()
        return out

    def _serve_plc_state(self, channels: int):
        """The conceal's carried LPC [B, C, 24] and pitch [B], made on
        first use and kept across serve() calls."""
        if getattr(self, "_serve_plc_lpc", None) is None:
            self._serve_plc_lpc = torch.zeros(self.batch, channels, LPC_ORDER,
                                              device=self.device)
            self._serve_plc_pitch = torch.full((self.batch,), 15, dtype=torch.int32,
                                               device=self.device)
        return self._serve_plc_lpc, self._serve_plc_pitch


class BatchedCeltDecoder(ServingSlots):
    """Decode a fixed batch of CELT streams, one frame per stream per step.

    transfer: "f32" = exact float band shapes; "q14" = int16 Q14 shapes;
    "p12"/"p10"/"p8" = bit-packed mantissas with the band exponents folded
    into the energy plane (serve() only; decode_frames uses q14 precision
    for every quantised mode); "plan" = plane A's pulse-vector plan, the
    spectra rebuilt on the device by the plan executor (serve() only).
    """

    def __init__(self, batch: int, channels: int = 2, downsample: int = 1,
                 transfer: str = "f32", *, device):
        if transfer not in TRANSFERS:
            raise ValueError(f"transfer {transfer!r} not in {TRANSFERS}")
        self.transfer = transfer
        self.batch = batch
        self.channels = channels
        self.downsample = downsample
        self.device = torch.device(device)
        self.native = NativeBatchFrontEnd(batch, channels, downsample)
        self.state = init_state(batch, channels, device=self.device)
        self._init_serving()
        #: plan steps served as a q14 spectrum because the plan overflowed
        self.plan_fallbacks = 0

    def _pipe_step_fn(self, lm: int, short_blocks: bool):
        key = ("raw", lm, short_blocks)
        if key not in self._steps:
            self._steps[key] = make_pipeline_step(
                lm, short_blocks, self.channels, self.downsample,
                quantized=self.transfer != "f32", device=self.device,
            )
        return self._steps[key]

    def _set_end_bands(self, end_bands) -> None:
        """A step's CELT end band of each stream (int32 [B]; None leaves
        them as they are) into plane A before its decode, counting the
        streams below fullband in `band_limited_streams`."""
        if end_bands is not None:
            self.native.set_end_bands(end_bands)
            limited = int((self.native.end_bands < modes.NB_E_BANDS).sum())
            trace.count("band_limited_streams", limited)

    def _raw_args(self, frame_size: int, packets: list, stream_channels=None, end_bands=None):
        """Plane A -> raw step args; only [B]-sized numpy work on the host.

        Returns (lm, short_mask, args) with args = (xraw, mono, ble, bound,
        periods, gains, tapsets).
        """
        self._set_end_bands(end_bands)
        if self.transfer != "f32":
            x, ble, meta, gains = self.native.decode_batch_q15(
                packets, frame_size, stream_channels
            )
        else:
            x, ble, meta, gains = self.native.decode_batch_f32(
                packets, frame_size, stream_channels
            )
        lm = int(meta[0, 2])
        if not (meta[:, 2] == lm).all():
            raise ValueError("mixed frame sizes in one step not supported")
        n = (1 << lm) * modes.SHORT_MDCT_SIZE
        m = 1 << lm
        bound = m * modes.E_BANDS[meta[:, 5]]
        if self.downsample != 1:
            bound = np.minimum(bound, n // self.downsample)
        bound = np.where(meta[:, 0] != 0, 0, bound).astype(np.int32)
        periods = np.maximum(meta[:, 6:9], 15)  # comb_filter MINPERIOD clamp
        tapsets = np.ascontiguousarray(meta[:, 9:12])
        mono = meta[:, 3] == 1
        short_mask = meta[:, 1] != 0
        args = (x, mono, ble, bound, periods.astype(np.int32), gains, tapsets)
        return lm, short_mask, args

    def _dispatch(self, lm: int, short_mask: np.ndarray, args):
        """Run the right synthesis variant(s); returns pcm on the device."""
        targs = [torch.as_tensor(a).to(self.device) for a in args]
        if not short_mask.any() or short_mask.all():
            step = self._pipe_step_fn(lm, bool(short_mask[0]))
            self.state, pcm = step(self.state, *targs)
            return pcm
        state_long, pcm_long = self._pipe_step_fn(lm, False)(self.state, *targs)
        state_short, pcm_short = self._pipe_step_fn(lm, True)(self.state, *targs)
        msk = torch.as_tensor(short_mask).to(self.device)
        self.state = SynthState(
            torch.where(msk[:, None, None], state_short.mem, state_long.mem),
            torch.where(msk[:, None], state_short.preemph, state_long.preemph),
        )
        return torch.where(msk[:, None, None], pcm_short, pcm_long)

    def decode_frames(self, packets: list, frame_size: int,
                      stream_channels=None) -> np.ndarray:
        """Full pipeline step: plane A then device synthesis; pcm [B, frame, C]."""
        return self.decode_frames_on_device(packets, frame_size, stream_channels).cpu().numpy()

    def decode_frames_on_device(self, packets: list, frame_size: int,
                                stream_channels=None, end_bands=None) -> torch.Tensor:
        """decode_frames with the pcm left on the device; `end_bands`, None
        or int32 [B]: each stream's CELT end band from this frame on."""
        lm, short_mask, args = self._raw_args(frame_size, packets, stream_channels, end_bands)
        return self._dispatch(lm, short_mask, args)

    def run_pipelined(self, batches: list, frame_size: int):
        """Decode a sequence of steps with the state carried across them,
        one step in flight (ServingSlots._one_in_flight); returns the last
        step's PCM on the device, [B, frame, C]."""
        return self._one_in_flight(lambda packets: self._raw_args(frame_size, packets),
                                   lambda prepared: self._dispatch(*prepared), batches)

    def _serving_step(self, lm: int, pf_chunk: int, pf_active: bool, mode: str):
        return self._served(("serve", lm, pf_chunk, pf_active, mode), lambda: make_serving_step(
            lm, self.batch, self.channels, self.downsample, pf_chunk=pf_chunk,
            pf_active=pf_active, transfer=mode, device=self.device))

    def _plan_serving_step(self, lm: int, pf_chunk: int, pf_active: bool,
                           size_class: tuple, with_plc: bool | int = False):
        key = ("plan", lm, pf_chunk, pf_active, size_class, with_plc)
        return self._served(key, lambda: make_plan_serving_step(
            lm, self.batch, self.channels, self.downsample, pf_chunk=pf_chunk,
            pf_active=pf_active, size_class=size_class, with_plc=with_plc, device=self.device))

    def _alloc_slots(self, n_slots: int, mode: str) -> list:
        """Packed serving slots, laid out as packed_offsets: one int32
        buffer per slot whose regions are numpy views that the native
        decode writes straight into.  `copied` is the CUDA event of the
        slot's last host-to-device copy."""
        B = self.batch
        off = packed_offsets(B, mode)
        slots = []
        for _ in range(n_slots):
            host, copied = self._host_buffer(off["end"])
            buf = host.numpy()
            xq = buf[: off["ble"]]
            slots.append(dict(
                host=host,
                buf=buf,
                mode=mode,
                xq=xq.view(np.int16).reshape(B, 1920) if mode == "q14"
                else xq.reshape(B, XQ_WORDS[mode]),
                ble=buf[off["ble"] : off["meta"]].view(np.float32).reshape(B, 2, 21),
                meta=buf[off["meta"] : off["gains"]].reshape(B, 16),
                gains=buf[off["gains"] :].view(np.float32).reshape(B, 3),
                copied=copied,
            ))
        return slots

    def _alloc_plan_slots(self, n_slots: int) -> list:
        """Plan slots (native/frontend.py plan_slot_views) over host
        buffers of the full arena capacity, each behind its head
        (`_plan_host_buffer`), with their CUDA events."""
        words = self.batch * (PLAN_FIXED_WORDS + PLAN_ARENA_WORDS)
        slots = []
        for _ in range(n_slots):
            bufs = self._plan_host_buffer(words)
            slot = plan_slot_views(bufs["host"].numpy(), self.batch, PLAN_ARENA_WORDS)
            slot.update(bufs)
            slots.append(slot)
        return slots

    @staticmethod
    def _plan_upload_words(slot) -> int:
        """Words of the slot to upload: the fixed regions and the used arena
        prefix, with at least one arena word for the executor's clamped
        window fetch to land on."""
        return max(slot["used_words"], slot["fixed_words"] + 1)

    def _ring_for(self, ring, lm: int):
        n = ((1 << lm) * modes.SHORT_MDCT_SIZE) // self.downsample
        return ring if ring is not None and ring.shape[1] == n else self._ring(n)

    def _serve_state_and_ring(self):
        state = getattr(self, "_serve_state", None)
        if state is None:
            state = init_state(self.batch, self.channels, device=self.device)
        return state, getattr(self, "_serve_ring", None)

    def _packed_step(self, state, ring, packets, frame_size, slot, dev_buf, mode,
                     stream_channels, captured: bool = True):
        """Plane A into a packed slot, one upload, one serving step (its
        CUDA graph on the card unless not `captured`)."""
        self._reuse(slot)
        with trace.span("plane_a"):
            self.native.decode_batch_q15_into(packets, frame_size, slot, stream_channels)
        with trace.span("issue"):
            lm = self._step_lm(slot["meta"])
            # Specialise the post-filter to this step's actual lags.
            pf_chunk, pf_active = pf_chunk_for(slot["meta"][:, 6:9], slot["gains"])
            self._upload(slot, dev_buf, dev_buf.shape[0])
            ring = self._ring_for(ring, lm)
            step = self._serving_step(lm, pf_chunk, pf_active, mode)
            return self._call_step(step if captured else eager(step), state, ring, dev_buf)

    def serve(self, batches: list, frame_size: int, n_slots: int = 4,
              stream_channels=None, end_bands=None) -> np.ndarray:
        """Serving loop: per step, native plane A writes one slot, one
        host-to-device copy ships it, one serving step synthesises it.

        Every device call is asynchronous, so plane A of step t+1 runs on
        the host while the device runs step t.  A slot is rewritten only
        after its previous copy's event has completed.  State and PCM ring
        are updated in place and persist across calls.  On a CUDA device a
        step is the replay of its variant's CUDA graph, captured at the
        variant's first step (dsp/graphs.py).

        `end_bands`, None or one int32 [B] a step: each stream's CELT end
        band from that step's frame on (NativeBatchFrontEnd.set_end_bands);
        None keeps them (fullband unless set).

        Returns the final step's digest (np[2]); the last frame's PCM stays
        on the device in `self._serve_ring` [B, frame, C].
        """
        with trace.span("serve_call", step=self.steps_served):
            if self.transfer == "plan":
                return self._serve_plan(batches, frame_size, n_slots, stream_channels,
                                        end_bands)
            mode = self.transfer if self.transfer in PACK_BITS else "q14"
            if (not hasattr(self, "_slots") or len(self._slots) != n_slots
                    or self._slots[0]["mode"] != mode):
                self._slots = self._alloc_slots(n_slots, mode)
            dev_buf = self._device_buffer(mode, packed_offsets(self.batch, mode)["end"])
            state, ring = self._serve_state_and_ring()
            digest = None
            for t, packets in enumerate(batches):
                with trace.span("step", step=self._next_step()):
                    self._set_end_bands(None if end_bands is None else end_bands[t])
                    state, ring, digest = self._packed_step(
                        state, ring, packets, frame_size, self._slots[t % n_slots], dev_buf,
                        mode, stream_channels)
            self._serve_state = state
            self._serve_ring = ring
            return self._wait(digest)

    def _serve_plan(self, batches: list, frame_size: int, n_slots: int = 4,
                    stream_channels=None, end_bands=None) -> np.ndarray:
        """Plan-executor serving loop (the port of the reference's
        `_serve_plan`): per step, plane A writes a plan slot, only its used
        prefix (the fixed regions and the used arena) is uploaded, and the
        device rebuilds the spectra from that prefix before synthesis.

        A step whose plan overflows the arena ships as a q14 spectrum for
        just that step (the synthesis state is shared by both step kinds),
        eagerly: it is the one step a card serves without its graph.  The
        device buffer holds the plan slot behind its head (PLAN_HEAD): the
        step reads the whole buffer and where the upload ends from the
        head, so one graph serves every upload length.
        A step with pitch-regime losses (a stream's first lost frames:
        plane A ships an empty plan flagged in meta[14]) runs a step
        variant that conceals them on the device (`_plc_variant`); the
        conceal's LPC and pitch state, `_serve_plc_lpc` and
        `_serve_plc_pitch`, persist across calls like the synthesis state.
        """
        if frame_size * self.downsample < 480:
            # 2.5/5 ms frames have n <= 2 bands, which plan mode rejects
            # (every step would fall back): serve the packed path directly.
            prev, self.transfer = self.transfer, "p10"
            try:
                return self.serve(batches, frame_size, n_slots, stream_channels, end_bands)
            finally:
                self.transfer = prev
        B = self.batch
        if not hasattr(self, "_plan_slots") or len(self._plan_slots) != n_slots:
            self._plan_slots = self._alloc_plan_slots(n_slots)
        plan_buf = self._device_buffer("plan", self._plan_slots[0]["head"].shape[0])
        if not hasattr(self, "_plan_q14_slots"):
            self._plan_q14_slots = self._alloc_slots(2, "q14")
        q14_buf = self._device_buffer("q14", packed_offsets(B, "q14")["end"])
        state, ring = self._serve_state_and_ring()
        plc_state = self._serve_plc_state(self.channels)
        digest = None
        for t, packets in enumerate(batches):
            with trace.span("step", step=self._next_step()):
                slot = self._plan_slots[t % n_slots]
                self._reuse(slot)
                try:
                    with trace.span("plane_a"):
                        self._set_end_bands(None if end_bands is None else end_bands[t])
                        self.native.decode_batch_plan_into(packets, frame_size, slot,
                                                           stream_channels)
                except OverflowError:
                    # Plan capacity exceeded by this step's content (plane A
                    # restored the streams' state): ship a q14 spectrum.
                    q14_slot = self._plan_q14_slots[self.plan_fallbacks % 2]
                    self.plan_fallbacks += 1
                    with trace.span("overflow_step"):
                        state, ring, digest = self._packed_step(
                            state, ring, packets, frame_size, q14_slot, q14_buf, "q14",
                            stream_channels, captured=False)
                    continue
                with trace.span("issue"):
                    meta = slot["meta"]
                    lm = self._step_lm(meta)
                    with_plc = self._plc_variant(meta)
                    pf_chunk, pf_active = pf_chunk_for(meta[:, 6:9], slot["gains"])
                    buf, end, _ = self._upload_plan(slot, plan_buf,
                                                    self._plan_upload_words(slot))
                    ring = self._ring_for(ring, lm)
                    step = self._plan_serving_step(lm, pf_chunk, pf_active,
                                                   self._plan_size_class(slot), with_plc)
                    plc = plc_state if with_plc else ()
                    state, ring, digest = self._call_step(step, state, ring, buf, *plc,
                                                          end=end)
        self._serve_state = state
        self._serve_ring = ring
        return self._wait(digest)

    def final_ranges(self) -> list[int]:
        return self.native.final_ranges()
