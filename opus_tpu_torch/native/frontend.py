"""ctypes wrapper over the port's copy of the native CELT plane-A engine.

A copy of what the port drives from opus_tpu/native/frontend.py: the
batched decode into f32 / Q14 / packed / plan slots, the final ranges,
the batched CELT encoder (payloads for tests and the smoke run) and the
plan-slot helpers.  The engine is built from this directory's sources by
build.py; the port imports nothing of `opus_tpu`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .build import build

#: iy bit-stream fetch window of the plan executor, in u32 words per
#: stream; plans whose iy span exceeds PLAN_IYW - 1 are rejected (the
#: executor may touch one word past the last started one) and the serve
#: loop falls back to a spectral step for that frame.
PLAN_IYW = 192
#: Uploaded fixed-region words per stream of a plan slot: header 2 (arena
#: offset, packed counts) + ble 21 (Q9 log-energy pairs) + dmeta 5
#: (packed flags/periods/gains/plc) + bands 16 + 8 (21x24-bit w0 fields,
#: 21x11-bit eff fields).
PLAN_FIXED_WORDS = 2 + 21 + 5 + 24
#: Leaf-table capacities the native header pass enforces per stream
#: (anti-collapse: at most one record per band and channel, 2 * 21).
PLAN_P_MAX, PLAN_F_MAX, PLAN_A_MAX = 224, 64, 42
#: Arena capacity of a plan slot, int32 words per stream; plane A raises
#: OverflowError past it.
PLAN_ARENA_WORDS = 512
_NB = 21

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    # OMP workers must sleep between batch calls: spin-waiting starves
    # the threads that issue the device work on the same host cores.
    os.environ.setdefault("OMP_WAIT_POLICY", "passive")
    lib = ctypes.CDLL(str(build()))
    lib.celt_fe_create.restype = ctypes.c_void_p
    lib.celt_fe_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.celt_fe_destroy.argtypes = [ctypes.c_void_p]
    lib.celt_fe_rng.restype = ctypes.c_uint32
    lib.celt_fe_rng.argtypes = [ctypes.c_void_p]
    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    head = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, i32p, ctypes.c_int,
            ctypes.c_int, i32p]
    lib.celt_fe_decode_batch_f32.restype = ctypes.c_int
    lib.celt_fe_decode_batch_f32.argtypes = head + [f32p, ctypes.c_int64, f32p, i32p, f32p]
    lib.celt_fe_decode_batch_q15.restype = ctypes.c_int
    lib.celt_fe_decode_batch_q15.argtypes = head + [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, f32p, i32p, f32p]
    lib.celt_fe_decode_batch_packed.restype = ctypes.c_int
    lib.celt_fe_decode_batch_packed.argtypes = head + [
        ctypes.c_int, i32p, ctypes.c_int64, f32p, i32p, f32p]
    lib.celt_fe_decode_batch_plan.restype = ctypes.c_int
    lib.celt_fe_decode_batch_plan.argtypes = head + [
        i32p,  # header [B,4]
        f32p,  # ble [B,2,21]
        i32p,  # meta [B,16]
        f32p,  # gains [B,3]
        i32p,  # bands [B,21,2]
        i32p, ctypes.c_int64,  # arena, capacity
        ctypes.POINTER(ctypes.c_int64),  # used_words out
        f32p, ctypes.c_int64,  # xdbg, stride
    ]
    lib.celt_enc_create.restype = ctypes.c_void_p
    lib.celt_enc_create.argtypes = [ctypes.c_int]
    lib.celt_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.celt_enc_encode_batch.restype = ctypes.c_int
    lib.celt_enc_encode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), f32p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBatchFrontEnd:
    """Plane A for a fixed batch of streams, one native handle per stream.

    Each decode runs every stream's symbol decode in one C call.  None
    packets are lost: the engine conceals them (noise regime, or, in plan
    mode, pitch-regime flags for the device; see celt_frontend.cpp).
    """

    NB = _NB

    def __init__(self, batch: int, channels: int, downsample: int = 1):
        self.lib = _load()
        self.batch = batch
        self.channels = channels
        self.downsample = downsample
        self.handles = (ctypes.c_void_p * batch)(
            *[self.lib.celt_fe_create(channels, downsample) for _ in range(batch)]
        )
        # Double-buffered output planes of decode_batch_f32/_q15.
        self._slots = [
            dict(
                x=np.zeros((batch, 2 * 960), np.float32),
                xq=np.zeros((batch, 2 * 960), np.int16),
                ble=np.zeros((batch, 2, self.NB), np.float32),
                meta=np.zeros((batch, 16), np.int32),
                gains=np.zeros((batch, 3), np.float32),
            )
            for _ in range(2)
        ]
        self._slot = 0

    def __del__(self):
        try:
            for h in self.handles:
                self.lib.celt_fe_destroy(h)
        except (AttributeError, TypeError):
            pass

    def final_ranges(self) -> list:
        return [int(self.lib.celt_fe_rng(h)) for h in self.handles]

    def _inputs(self, packets: list, frame_size: int, stream_channels):
        """(blob, lens, stream channels, samples at 48 kHz) of one step."""
        blob = b"".join(p or b"" for p in packets)
        lens = np.array([0 if p is None else len(p) for p in packets], dtype=np.int32)
        if stream_channels is None:
            sch = np.full(self.batch, self.channels, dtype=np.int32)
        else:
            sch = np.ascontiguousarray(stream_channels, dtype=np.int32)
        return blob, lens, sch, frame_size * self.downsample

    def _next_slot(self) -> dict:
        slot = self._slots[self._slot]
        self._slot = 1 - self._slot
        return slot

    def _check(self, rc: int) -> None:
        if rc != self.batch:
            raise ValueError(f"native batch decode failed at stream {-rc - 1}")

    def decode_batch_f32(self, packets: list, frame_size: int, stream_channels=None):
        """(x [B, 1920] f32, ble [B,2,21], meta [B,16], gains [B,3] f32):
        views of a double-buffered slot, valid until the call after next."""
        blob, lens, sch, n48 = self._inputs(packets, frame_size, stream_channels)
        s = self._next_slot()
        x, ble, meta, gains = s["x"], s["ble"], s["meta"], s["gains"]
        self._check(self.lib.celt_fe_decode_batch_f32(
            self.handles, blob, _ptr(lens, ctypes.c_int32), self.batch, n48,
            _ptr(sch, ctypes.c_int32), _ptr(x, ctypes.c_float), x.shape[1],
            _ptr(ble, ctypes.c_float), _ptr(meta, ctypes.c_int32),
            _ptr(gains, ctypes.c_float)))
        return x, ble, meta, gains

    def decode_batch_q15(self, packets: list, frame_size: int, stream_channels=None):
        """As decode_batch_f32 with the band shapes as Q14 int16."""
        blob, lens, sch, n48 = self._inputs(packets, frame_size, stream_channels)
        s = self._next_slot()
        xq, ble, meta, gains = s["xq"], s["ble"], s["meta"], s["gains"]
        self._check(self.lib.celt_fe_decode_batch_q15(
            self.handles, blob, _ptr(lens, ctypes.c_int32), self.batch, n48,
            _ptr(sch, ctypes.c_int32), _ptr(xq, ctypes.c_int16), xq.shape[1],
            _ptr(ble, ctypes.c_float), _ptr(meta, ctypes.c_int32),
            _ptr(gains, ctypes.c_float)))
        return xq, ble, meta, gains

    def decode_batch_q15_into(self, packets: list, frame_size: int, slot: dict,
                              stream_channels=None):
        """Packed-slot decode (opus_tpu_torch.dsp.tables.packed_offsets
        layout); dispatches on the slot's mode (q14 int16 / pW bit-packed)."""
        blob, lens, sch, n48 = self._inputs(packets, frame_size, stream_channels)
        xq, ble, meta, gains = slot["xq"], slot["ble"], slot["meta"], slot["gains"]
        mode = slot.get("mode", "q14")
        common = (self.handles, blob, _ptr(lens, ctypes.c_int32), self.batch, n48,
                  _ptr(sch, ctypes.c_int32))
        tail = (_ptr(ble, ctypes.c_float), _ptr(meta, ctypes.c_int32),
                _ptr(gains, ctypes.c_float))
        if mode in ("p12", "p10", "p8"):
            rc = self.lib.celt_fe_decode_batch_packed(
                *common, int(mode[1:]), _ptr(xq, ctypes.c_int32), xq.shape[1], *tail)
        else:
            rc = self.lib.celt_fe_decode_batch_q15(
                *common, _ptr(xq, ctypes.c_int16), xq.shape[1], *tail)
        self._check(rc)
        return slot

    def decode_batch_plan_into(self, packets: list, frame_size: int, slot: dict,
                               stream_channels=None, want_xdbg: bool = False):
        """Plan-mode decode into a plan slot (alloc_plan_slots).  Returns the
        slot with slot["used_words"] = fixed words + used arena prefix and
        slot["iy_spans"]; raises OverflowError on arena exhaustion (the
        engine restores the streams' state first; callers fall back to a
        spectral step).  want_xdbg also returns the engine's own f32
        spectra in slot["xdbg"] [B, 1920] (the tests' reference)."""
        B = self.batch
        blob, lens, sch, n48 = self._inputs(packets, frame_size, stream_channels)
        used = ctypes.c_int64(0)
        xdbg = np.zeros((B, 2 * 960), np.float32) if want_xdbg else None
        rc = self.lib.celt_fe_decode_batch_plan(
            self.handles, blob, _ptr(lens, ctypes.c_int32), B, n48,
            _ptr(sch, ctypes.c_int32),
            _ptr(slot["header"], ctypes.c_int32), _ptr(slot["ble"], ctypes.c_float),
            _ptr(slot["meta"], ctypes.c_int32), _ptr(slot["gains"], ctypes.c_float),
            _ptr(slot["bands"], ctypes.c_int32),
            _ptr(slot["arena"], ctypes.c_int32), slot["arena"].shape[0],
            ctypes.byref(used),
            _ptr(xdbg, ctypes.c_float) if want_xdbg else None,
            xdbg.shape[1] if want_xdbg else 0,
        )
        if rc == -(B + 1):
            raise OverflowError("plan arena capacity exceeded")
        self._check(rc)
        counts = slot["header"][:, 1]
        if (int((counts & 0x1FF).max(initial=0)) > PLAN_P_MAX
                or int(((counts >> 9) & 0x1FF).max(initial=0)) > PLAN_F_MAX
                or int((counts >> 18).max(initial=0)) > PLAN_A_MAX):
            # The native header pass enforces these same capacities and
            # restores state before its OverflowError; reaching here means
            # the two sides disagree and the state has already advanced,
            # so a fallback re-decode would corrupt it.
            raise RuntimeError("native plan guard missed a capacity the executor needs")
        try:
            slot["iy_spans"] = check_plan_iy_span(slot)
        except OverflowError as e:
            raise RuntimeError(f"native plan guard missed: {e}") from None
        pack_plan_fixed(slot)
        slot["used_words"] = slot["fixed_words"] + int(used.value)
        slot["xdbg"] = xdbg
        return slot


class NativeCeltEncoderBatch:
    """Batch of native CELT encoders (celt_encoder.inc); one C call
    encodes every stream, CBR."""

    def __init__(self, batch: int, channels: int):
        self.lib = _load()
        self.batch = batch
        self.channels = channels
        self.handles = (ctypes.c_void_p * batch)(
            *[self.lib.celt_enc_create(channels) for _ in range(batch)]
        )

    def __del__(self):
        try:
            for h in self.handles:
                self.lib.celt_enc_destroy(h)
        except (AttributeError, TypeError):
            pass

    def encode_batch(self, pcm: np.ndarray, nb_bytes: int) -> np.ndarray:
        """pcm [B, N, channels] f32 in +-1 -> payloads [B, nb_bytes] uint8."""
        B = self.batch
        fr = np.ascontiguousarray(pcm, dtype=np.float32).reshape(B, -1)
        out = np.zeros((B, nb_bytes), np.uint8)
        rc = self.lib.celt_enc_encode_batch(
            self.handles, _ptr(fr, ctypes.c_float), fr.shape[1], B, pcm.shape[1],
            nb_bytes, _ptr(out, ctypes.c_uint8),
        )
        if rc != B:
            raise ValueError(f"native celt batch encode failed at {-rc - 1}")
        return out


def plan_slot_views(buf: np.ndarray, batch: int, arena_words_per_stream: int) -> dict:
    """A plan slot over `buf`, an int32 array of
    batch * (PLAN_FIXED_WORDS + arena_words_per_stream) words.

    `buf` holds the uploaded form: the packed fixed regions (header
    [B,2] — the device derives iy_rel from the counts word —, ble Q9
    [B,21], dmeta [B,5], bands w0 [B,16] + eff [B,8]), then a shared
    variable-fill arena of which only the used prefix ships
    (`used_words` after each decode).  The full-precision staging arrays
    (header/ble/meta/gains/bands) stay on the host for the serve loop's
    picks and the numpy oracle; they are not uploaded."""
    B = batch
    fixed = B * PLAN_FIXED_WORDS
    if buf.dtype != np.int32 or buf.shape != (fixed + B * arena_words_per_stream,):
        raise ValueError(f"plan slot buffer must be int32 [{fixed + B * arena_words_per_stream}]")
    o = 0
    views = {}
    for name, width in (("hdr_p", 2), ("ble_p", _NB), ("dmeta", 5), ("bw0_p", 16),
                        ("beff_p", 8)):
        views[name] = buf[o : o + B * width].reshape(B, width)
        o += B * width
    return dict(
        buf=buf, mode="plan", fixed_words=fixed, arena=buf[o:], **views,
        header=np.zeros((B, 4), np.int32),
        ble=np.zeros((B, 2, _NB), np.float32),
        meta=np.zeros((B, 16), np.int32),
        gains=np.zeros((B, 3), np.float32),
        bands=np.zeros((B, _NB, 2), np.int32),
        used_words=0,
    )


def alloc_plan_slots(batch: int, n_slots: int = 4,
                     arena_words_per_stream: int = PLAN_ARENA_WORDS) -> list:
    """n_slots plan slots over fresh numpy buffers (see plan_slot_views)."""
    words = batch * (PLAN_FIXED_WORDS + arena_words_per_stream)
    return [plan_slot_views(np.zeros(words, np.int32), batch, arena_words_per_stream)
            for _ in range(n_slots)]


def check_plan_iy_span(slot: dict) -> np.ndarray:
    """Reject plans whose pulse bit-stream spans past the executor's
    PLAN_IYW-word fetch window (it may touch one word beyond the last
    started one); callers fall back to a spectral step for that frame.
    Returns the per-stream iy word spans."""
    hdr = slot["header"]
    n_pvq = hdr[:, 1] & 0x1FF
    # One u32 word per pvq record; ln at [0:8], w at [8:12].
    p = np.arange(PLAN_P_MAX, dtype=np.int64)
    ridx = hdr[:, 0:1].astype(np.int64) + p[None, :]
    au32 = slot["arena"].view(np.uint32)  # >> on i32 would sign-extend
    w0 = au32[np.clip(ridx, 0, au32.shape[0] - 1)]
    rln = (w0 & 0xFF).astype(np.int64) + 1
    rwid = ((w0 >> 8) & 0xF).astype(np.int64)
    bits = np.where(p[None, :] < n_pvq[:, None], rln * rwid, 0)
    iy_words = -(-bits.sum(axis=1) // 32)
    if int(iy_words.max(initial=0)) > PLAN_IYW - 1:
        raise OverflowError("plan iy span exceeds executor fetch window")
    return iy_words


def pack_plan_fixed(slot: dict) -> None:
    """Assemble the uploaded fixed regions from the staging arrays."""
    hdr4 = slot["header"]
    B = hdr4.shape[0]
    # iy_rel (staging hdr4[:, 3]) is not uploaded: the device derives it
    # from the counts word (n_pvq + 3 n_fill + 2 n_ac).
    slot["hdr_p"][:, 0] = hdr4[:, 0]
    slot["hdr_p"][:, 1] = hdr4[:, 1]
    # ble: Q9 int16 pairs (step 1/512 in log2).
    q = np.clip(np.rint(slot["ble"] * 512.0), -32768, 32767).astype(np.int32)
    slot["ble_p"][:] = (q[:, 0] & 0xFFFF) | (q[:, 1] << 16)
    # dmeta (unpacked by dsp/synthesis.py make_plan_serving_step):
    # d0: sil|short<<1|mono<<2|hybrid<<3|plc<<4|plc1<<5|spread[6:8]
    #     |eff_end[8:13]|ts0[13:15]|ts1[15:17]|ts2[17:19]|period2[19:30]
    # d1: period0[0:11] | period1[11:22]
    # d2: gain0_f16 | gain1_f16<<16;  d3: gain2_f16 | meta[12]<<16;
    # d4: plc params
    meta = slot["meta"]
    g16 = slot["gains"].astype(np.float16).view(np.uint16).astype(np.int64)
    d = slot["dmeta"]
    d[:, 0] = (
        (meta[:, 0] & 1) | ((meta[:, 1] & 1) << 1)
        | ((meta[:, 3] == 1).astype(np.int32) << 2)
        | ((meta[:, 4] == 17).astype(np.int32) << 3)
        | ((meta[:, 14] & 1) << 4) | (((meta[:, 14] >> 1) & 1) << 5)
        | ((meta[:, 13] & 3) << 6) | ((meta[:, 5] & 0x1F) << 8)
        | ((meta[:, 9] & 3) << 13) | ((meta[:, 10] & 3) << 15)
        | ((meta[:, 11] & 3) << 17)
        | (np.clip(meta[:, 8], 0, 0x7FF) << 19)
    )
    d[:, 1] = np.clip(meta[:, 6], 0, 0x7FF) | (np.clip(meta[:, 7], 0, 0x7FF) << 11)
    d[:, 2] = (g16[:, 0] | (g16[:, 1] << 16)).astype(np.int64).astype(np.uint32).view(np.int32)
    d[:, 3] = g16[:, 2].astype(np.int32) | ((meta[:, 12] & 0xFF) << 16)
    d[:, 4] = meta[:, 15]
    # bands: w0 as a 21x24-bit little-endian stream in 16 words; eff
    # fields as a 21x11-bit stream in 8 words.
    braw = slot["bands"]
    w0u = braw[:, :, 0].astype(np.uint64) & 0xFFFFFF
    outw = np.zeros((B, 16), np.uint64)
    for j in range(_NB):
        bitpos = 24 * j
        w, sft = bitpos >> 5, bitpos & 31
        outw[:, w] |= (w0u[:, j] << sft) & 0xFFFFFFFF
        if sft + 24 > 32:
            outw[:, w + 1] |= w0u[:, j] >> (32 - sft)
    slot["bw0_p"][:] = outw.astype(np.uint32).view(np.int32)
    eff = ((braw[:, :, 1] >> 16) & 0x7FF).astype(np.uint64)
    out = np.zeros((B, 8), np.uint64)
    for j in range(_NB):
        bitpos = 11 * j
        w, s = bitpos >> 5, bitpos & 31
        out[:, w] |= (eff[:, j] << s) & 0xFFFFFFFF
        if s + 11 > 32:
            out[:, w + 1] |= eff[:, j] >> (32 - s)
    slot["beff_p"][:] = out.astype(np.uint32).view(np.int32)
