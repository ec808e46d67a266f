"""ctypes wrapper over the port's copy of the native plane-A engines.

A copy of what the port drives from opus_tpu/native/frontend.py and
opus_tpu/batch/opus_pipeline.py: the batched CELT decode into f32 / Q14 /
packed / plan slots, the mixed-mode Opus decode (CELT, SILK and hybrid
streams in one call) into packed and plan slots, the final ranges, the
batched CELT, SILK and hybrid encoders (payloads for tests and the smoke
run) and the plan-slot helpers.  The scalar codec library reaches the
one-stream wrappers: Encoder (encoder.py) encodes with NativeCeltEncoder,
NativeVoiceEncoder, NativeStereoVoiceEncoder and NativeHybridEncoder, by
those names; NativeCeltFrontEnd, NativeSilkEncoder, NativeSilkFrontEnd
and NativeSilkBatch keep the reference's constructors, methods and
return values.  The engines are built from this directory's sources by
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
    # OPUS_TPU_NATIVE_LIB: a library to load instead of the build, as the
    # reference's loader reads it: the sanitizer lane's instrumented
    # library (build.py), under LD_PRELOAD=libasan.
    override = os.environ.get("OPUS_TPU_NATIVE_LIB")
    if override and not os.path.exists(override):
        raise FileNotFoundError(f"OPUS_TPU_NATIVE_LIB={override} not found")
    lib = ctypes.CDLL(override or str(build()))
    lib.celt_fe_create.restype = ctypes.c_void_p
    lib.celt_fe_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.celt_fe_destroy.argtypes = [ctypes.c_void_p]
    lib.celt_fe_rng.restype = ctypes.c_uint32
    lib.celt_fe_rng.argtypes = [ctypes.c_void_p]
    lib.celt_fe_reset.argtypes = [ctypes.c_void_p]
    lib.celt_fe_config.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.celt_fe_decode.restype = ctypes.c_int
    lib.celt_fe_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, f64p, f32p, i32p, f64p]
    head = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, i32p, ctypes.c_int,
            ctypes.c_int, i32p]
    lib.celt_fe_decode_batch.restype = ctypes.c_int
    lib.celt_fe_decode_batch.argtypes = head + [f64p, ctypes.c_int64, f32p, i32p, f64p]
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
    u8p, i16p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16)
    u32p, vpp = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_void_p)
    lib.celt_enc_create.restype = ctypes.c_void_p
    lib.celt_enc_create.argtypes = [ctypes.c_int]
    lib.celt_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.celt_enc_reset.argtypes = [ctypes.c_void_p]
    lib.celt_enc_rng.restype = ctypes.c_uint32
    lib.celt_enc_rng.argtypes = [ctypes.c_void_p]
    lib.celt_enc_encode2.restype = ctypes.c_int
    lib.celt_enc_encode2.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int, u8p,
                                     ctypes.c_int, ctypes.c_int]
    lib.celt_enc_encode_batch.restype = ctypes.c_int
    lib.celt_enc_encode_batch.argtypes = [
        vpp, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
    # The Opus layer (opus_frontend.cpp), as opus_pipeline.py:66-112 binds it.
    lib.opus_fe_create.restype = ctypes.c_void_p
    lib.opus_fe_create.argtypes = [ctypes.c_int]
    lib.opus_fe_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_fe_set_silk_internal.argtypes = [ctypes.c_void_p, ctypes.c_int]
    ohead = [vpp, ctypes.c_char_p, i32p, ctypes.c_int, i32p, i32p, ctypes.c_int, i32p]
    lib.opus_fe_decode_batch.restype = ctypes.c_int
    lib.opus_fe_decode_batch.argtypes = ohead + [
        f32p, ctypes.c_int64, f32p, i32p, f32p, i16p, ctypes.c_int64, u32p, i32p]
    lib.opus_fe_decode_batch_packed.restype = ctypes.c_int
    lib.opus_fe_decode_batch_packed.argtypes = ohead + [
        ctypes.c_int,  # mantissa bits
        ctypes.c_int,  # device_plc: pitch-regime CELT losses -> device conceal
        i16p,  # trans_out [B, 480*ch]
        i32p, ctypes.c_int64, i16p, ctypes.c_int64, f32p, i32p, f32p, u32p, i32p]
    lib.opus_fe_decode_batch_plan.restype = ctypes.c_int
    lib.opus_fe_decode_batch_plan.argtypes = ohead + [
        i32p, f32p, i32p, f32p, i32p,  # header, ble, meta, gains, bands
        i32p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),  # arena, capacity, used
        i16p, ctypes.c_int64,  # silk staging, stride
        i16p,  # trans_out [B, 480*ch]
        u32p, i32p]
    # The SILK and hybrid encoders (silk_encoder.inc): payloads without ToC.
    lib.silk_enc_create.restype = ctypes.c_void_p
    lib.silk_enc_create.argtypes = [ctypes.c_int]
    lib.silk_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.silk_enc_reset.argtypes = [ctypes.c_void_p]
    lib.silk_enc_rng.restype = ctypes.c_uint32
    lib.silk_enc_rng.argtypes = [ctypes.c_void_p]
    lib.silk_enc_encode.restype = ctypes.c_int
    lib.silk_enc_encode.argtypes = [ctypes.c_void_p, i16p, ctypes.c_int, ctypes.c_int, u8p]
    lib.silk_enc_encode_batch.restype = ctypes.c_int
    lib.silk_enc_encode_batch.argtypes = [
        vpp, i16p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
        ctypes.c_int64, i32p]
    lib.voice_enc_create.restype = ctypes.c_void_p
    lib.voice_enc_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.voice_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.voice_enc_rng.restype = ctypes.c_uint32
    lib.voice_enc_rng.argtypes = [ctypes.c_void_p]
    lib.voice_enc_encode.restype = ctypes.c_int
    lib.voice_enc_encode.argtypes = [ctypes.c_void_p, i16p, ctypes.c_int, ctypes.c_int, u8p]
    lib.stereo_voice_enc_create.restype = ctypes.c_void_p
    lib.stereo_voice_enc_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.stereo_voice_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.stereo_voice_enc_rng.restype = ctypes.c_uint32
    lib.stereo_voice_enc_rng.argtypes = [ctypes.c_void_p]
    lib.stereo_voice_enc_encode.restype = ctypes.c_int
    lib.stereo_voice_enc_encode.argtypes = [ctypes.c_void_p, i16p, i16p, ctypes.c_int,
                                            ctypes.c_int, u8p]
    lib.hybrid_enc_create.restype = ctypes.c_void_p
    lib.hybrid_enc_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hybrid_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.hybrid_enc_rng.restype = ctypes.c_uint32
    lib.hybrid_enc_rng.argtypes = [ctypes.c_void_p]
    lib.hybrid_enc_encode.restype = ctypes.c_int
    lib.hybrid_enc_encode.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int, u8p]
    lib.hybrid_enc_encode_batch.restype = ctypes.c_int
    lib.hybrid_enc_encode_batch.argtypes = [
        vpp, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
        ctypes.c_int64, i32p]
    # The SILK decoder's plane A (silk_frontend.cpp), one stream or a batch.
    lib.silk_fe_create.restype = ctypes.c_void_p
    lib.silk_fe_create.argtypes = [ctypes.c_int]
    lib.silk_fe_destroy.argtypes = [ctypes.c_void_p]
    lib.silk_fe_decode.restype = ctypes.c_int
    lib.silk_fe_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, i16p,
                                   f32p, f32p, f32p, f32p, f32p, i32p, u32p]
    lib.silk_fe_decode_batch.restype = ctypes.c_int
    lib.silk_fe_decode_batch.argtypes = [vpp, ctypes.c_char_p, i32p, ctypes.c_int, i16p,
                                         ctypes.c_int64, u32p]
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


class NativeCeltFrontEnd:
    """Plane A of one CELT stream: decodes a frame's symbols into the
    planes dict of the reference's wrapper (the spectrum in f64, band
    energies, flags and post-filter parameters)."""

    NB_E_BANDS = 21

    def __init__(self, channels: int, downsample: int = 1):
        self.lib = _load()
        self.channels = channels
        self.downsample = downsample
        self.h = self.lib.celt_fe_create(channels, downsample)
        self.stream_channels = channels
        self.start_band = 0
        self.end_band = self.NB_E_BANDS
        self._x = np.zeros(2 * 960, np.float64)
        self._ble = np.zeros(2 * self.NB_E_BANDS, np.float32)
        self._meta = np.zeros(16, np.int32)
        self._gains = np.zeros(3, np.float64)

    def __del__(self):
        try:
            self.lib.celt_fe_destroy(self.h)
        except (AttributeError, TypeError):
            pass

    def reset(self):
        self.lib.celt_fe_reset(self.h)

    @property
    def final_range(self) -> int:
        return int(self.lib.celt_fe_rng(self.h))

    def decode_planes(self, data: bytes, frame_size: int) -> dict:
        """frame_size in samples at the decoder rate (48000/downsample)."""
        self.lib.celt_fe_config(self.h, self.start_band, self.end_band, -1)
        rc = self.lib.celt_fe_decode(
            self.h, data, len(data), frame_size * self.downsample, self.stream_channels,
            _ptr(self._x, ctypes.c_double), _ptr(self._ble, ctypes.c_float),
            _ptr(self._meta, ctypes.c_int32), _ptr(self._gains, ctypes.c_double))
        if rc != 0:
            raise ValueError(f"native celt frontend failed: {rc}")
        m = self._meta
        c_, n = int(m[3]), 120 << int(m[2])
        planes = {
            "x": self._x[: c_ * n].copy(),
            "band_log_e": self._ble.reshape(2, self.NB_E_BANDS)[: self.channels].copy(),
            "silence": bool(m[0]), "short_blocks": bool(m[1]), "lm": int(m[2]),
            "stream_channels": c_, "start": int(m[4]), "eff_end": int(m[5]),
        }
        for k in range(3):
            planes[f"pf_period{k}"] = int(m[6 + k])
            planes[f"pf_tapset{k}"] = int(m[9 + k])
            planes[f"pf_gain{k}"] = float(self._gains[k])
        return planes


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

    def reset(self):
        for h in self.handles:
            self.lib.celt_fe_reset(h)

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

    def decode_batch(self, packets: list, frame_size: int):
        """(x [B, 1920] f64, ble [B,2,21] f32, meta [B,16] i32, gains [B,3]
        f64): the planes at full precision, in new arrays."""
        blob, lens, sch, n48 = self._inputs(packets, frame_size, None)
        B = self.batch
        x = np.zeros((B, 2 * 960), np.float64)
        ble = np.zeros((B, 2, self.NB), np.float32)
        meta = np.zeros((B, 16), np.int32)
        gains = np.zeros((B, 3), np.float64)
        self._check(self.lib.celt_fe_decode_batch(
            self.handles, blob, _ptr(lens, ctypes.c_int32), B, n48,
            _ptr(sch, ctypes.c_int32), _ptr(x, ctypes.c_double), x.shape[1],
            _ptr(ble, ctypes.c_float), _ptr(meta, ctypes.c_int32),
            _ptr(gains, ctypes.c_double)))
        return x, ble, meta, gains

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

    def alloc_packed_slots(self, n_slots: int = 4, mode: str = "q14") -> list:
        """n_slots packed slots over fresh int32 buffers, laid out as
        dsp.tables.packed_offsets (xq: Q14 int16 or pW words, ble, meta,
        gains; the reference's words): decode_batch_q15_into writes the
        regions, numpy views of `buf`, and the whole buffer is one upload."""
        from ..dsp.tables import XQ_WORDS, packed_offsets

        B = self.batch
        off = packed_offsets(B, mode)
        slots = []
        for _ in range(n_slots):
            buf = np.zeros(off["end"], np.int32)
            xq = buf[: off["ble"]]
            slots.append(dict(
                buf=buf, mode=mode,
                xq=xq.view(np.int16).reshape(B, 1920) if mode == "q14"
                else xq.reshape(B, XQ_WORDS[mode]),
                ble=buf[off["ble"] : off["meta"]].view(np.float32).reshape(B, 2, self.NB),
                meta=buf[off["meta"] : off["gains"]].reshape(B, 16),
                gains=buf[off["gains"] :].view(np.float32).reshape(B, 3)))
        return slots

    def alloc_plan_slots(self, n_slots: int = 4,
                         arena_words_per_stream: int = PLAN_ARENA_WORDS) -> list:
        """n_slots plan slots of this batch (alloc_plan_slots)."""
        return alloc_plan_slots(self.batch, n_slots, arena_words_per_stream)

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
        finish_plan_slot(slot, int(used.value))
        slot["xdbg"] = xdbg
        return slot


class NativeCeltEncoder:
    """Native CELT encoder (celt_encoder.inc), one stream, CBR payloads
    (no ToC).  `end_band` and `complexity` apply from the next frame."""

    def __init__(self, channels: int):
        self.lib = _load()
        self.channels = channels
        self.end_band = 21
        self.complexity = 10
        self.h = self.lib.celt_enc_create(channels)

    def __del__(self):
        try:
            self.lib.celt_enc_destroy(self.h)
        except (AttributeError, TypeError):
            pass

    def reset(self):
        self.lib.celt_enc_reset(self.h)

    @property
    def final_range(self) -> int:
        return int(self.lib.celt_enc_rng(self.h))

    def encode(self, pcm: np.ndarray, nb_bytes: int) -> bytes:
        """pcm [N, channels] f32 in +-1 at 48 kHz -> nb_bytes of payload."""
        fr = np.ascontiguousarray(pcm, dtype=np.float32)
        out = np.zeros(nb_bytes, np.uint8)
        rc = self.lib.celt_enc_encode2(self.h, _ptr(fr, ctypes.c_float), fr.shape[0], nb_bytes,
                                       _ptr(out, ctypes.c_uint8), self.end_band, self.complexity)
        if rc != 0:
            raise ValueError(f"native celt encode failed: {rc}")
        return bytes(out)


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


#: opus_fe_* codes a stream's failure reports (opus_pipeline.py).
FALLBACK_REASON = {
    -10: "mode switch mid-stream",
    -11: "hybrid redundancy frame",
    -12: "silk-only trailing redundancy",
}


class NativeOpusFrontEnd:
    """Mixed-mode plane A (opus_frontend.cpp) for a fixed batch of
    streams, one native Opus handle per stream: each stream may carry
    CELT, SILK or hybrid packets, and one C call decodes every stream.

    Inputs per step are the ToC arrays of the serve loop: the payloads
    joined in `blob` (payload only, no ToC), `lens` (0 = lost, negative =
    FEC from that next packet's SILK LBRR), `modes` (0 SILK, 1 hybrid, 2
    CELT), `bws` (ToC bandwidth - NB), `schs` (coded channels) and the
    frame length at 48 kHz.  Every call writes the final ranges into
    `ranges` and the to-CELT transition rows (the SILK PLC whose first
    5 ms crossfades a frame head) into `trans` [B, 480*C] int16, and
    returns the per-stream transition descriptors `rcs` (> 0 on a
    transition; see opus_frontend.cpp opus_fe_decode)."""

    def __init__(self, batch: int, channels: int, silk_internal: bool):
        self.lib = _load()
        self.batch = batch
        self.channels = channels
        self.handles = (ctypes.c_void_p * batch)(
            *[self.lib.opus_fe_create(channels) for _ in range(batch)])
        for h in self.handles:
            # internal-rate SILK PCM + descriptor (meta[12]) instead of
            # 48 kHz PCM; fixed for the stream's lifetime
            self.lib.opus_fe_set_silk_internal(h, int(silk_internal))
        self.ranges = np.zeros(batch, np.uint32)
        self.trans = np.zeros((batch, 480 * channels), np.int16)

    def __del__(self):
        try:
            for h in self.handles:
                self.lib.opus_fe_destroy(h)
        except (AttributeError, TypeError):
            pass

    def _head(self, toc):
        blob, lens, modes, bws, frame48, schs = toc
        return (self.handles, blob, _ptr(lens, ctypes.c_int32), self.batch,
                _ptr(modes, ctypes.c_int32), _ptr(bws, ctypes.c_int32), frame48,
                _ptr(schs, ctypes.c_int32))

    def _check(self, rc: int, rcs) -> None:
        if rc != self.batch:
            i = -rc - 1
            code = int(rcs[i])
            raise ValueError(f"stream {i}: {FALLBACK_REASON.get(code, f'codec error {code}')}")

    def decode_batch(self, toc, slot: dict) -> np.ndarray:
        """f32 spectra, planes and 48 kHz SILK PCM into `slot` (x [B,1920],
        ble, meta, gains, silk [B, 2880*C]); returns rcs."""
        rcs = np.zeros(self.batch, np.int32)
        self._check(self.lib.opus_fe_decode_batch(
            *self._head(toc), _ptr(slot["x"], ctypes.c_float), slot["x"].shape[1],
            _ptr(slot["ble"], ctypes.c_float), _ptr(slot["meta"], ctypes.c_int32),
            _ptr(slot["gains"], ctypes.c_float), _ptr(slot["silk"], ctypes.c_int16),
            slot["silk"].shape[1], _ptr(self.ranges, ctypes.c_uint32),
            _ptr(rcs, ctypes.c_int32)), rcs)
        return rcs

    def decode_batch_packed_into(self, toc, slot: dict, mant_bits: int) -> np.ndarray:
        """A packed mixed slot (packed_offsets with silk_words): bit-packed
        band shapes and SILK PCM; pitch-regime CELT losses are flagged for
        the device conceal.  Returns rcs."""
        rcs = np.zeros(self.batch, np.int32)
        self._check(self.lib.opus_fe_decode_batch_packed(
            *self._head(toc), mant_bits, 1, _ptr(self.trans, ctypes.c_int16),
            _ptr(slot["xq"], ctypes.c_int32), slot["xq"].shape[1],
            _ptr(slot["silk"], ctypes.c_int16), slot["silk"].shape[1],
            _ptr(slot["ble"], ctypes.c_float), _ptr(slot["meta"], ctypes.c_int32),
            _ptr(slot["gains"], ctypes.c_float), _ptr(self.ranges, ctypes.c_uint32),
            _ptr(rcs, ctypes.c_int32)), rcs)
        return rcs

    def decode_batch_plan_into(self, toc, slot: dict) -> np.ndarray:
        """A mixed plan slot (plan_slot_views with silk_words): the CELT
        contribution as a plan, SILK PCM into the staging array, then the
        row map (compact_plan_silk).  Raises OverflowError when the arena
        or a plan capacity overflows (plane A restored every stream's state;
        the caller decodes the same packets on the packed path).  Returns
        rcs."""
        B = self.batch
        rcs = np.zeros(B, np.int32)
        used = ctypes.c_int64(0)
        rc = self.lib.opus_fe_decode_batch_plan(
            *self._head(toc),
            _ptr(slot["header"], ctypes.c_int32), _ptr(slot["ble"], ctypes.c_float),
            _ptr(slot["meta"], ctypes.c_int32), _ptr(slot["gains"], ctypes.c_float),
            _ptr(slot["bands"], ctypes.c_int32),
            _ptr(slot["arena"], ctypes.c_int32), slot["arena"].shape[0], ctypes.byref(used),
            _ptr(slot["silk"], ctypes.c_int16), slot["silk"].shape[1],
            _ptr(self.trans, ctypes.c_int16), _ptr(self.ranges, ctypes.c_uint32),
            _ptr(rcs, ctypes.c_int32))
        if rc == -(B + 1):
            raise OverflowError("plan arena capacity exceeded")
        if rc != B and int(rcs[-rc - 1]) == -30:
            raise OverflowError(f"stream {-rc - 1}: plan sink overflow")
        self._check(rc, rcs)
        finish_plan_slot(slot, int(used.value))
        return rcs


class NativeSilkEncoder:
    """Native SILK encoder (silk_encoder.inc), one mono stream at a fixed
    internal rate, CBR payloads (no ToC)."""

    def __init__(self, fs_khz: int):
        self.lib = _load()
        self.fs_khz = fs_khz
        self.h = self.lib.silk_enc_create(fs_khz)
        if not self.h:
            raise ValueError(f"bad internal rate {fs_khz}")
        self._out = np.zeros(1400, np.uint8)

    def __del__(self):
        try:
            self.lib.silk_enc_destroy(self.h)
        except (AttributeError, TypeError):
            pass

    def reset(self):
        self.lib.silk_enc_reset(self.h)

    @property
    def final_range(self) -> int:
        return int(self.lib.silk_enc_rng(self.h))

    def encode(self, x: np.ndarray, budget_bytes: int) -> bytes:
        """x: int16 at the internal rate (10/20/40/60 ms) -> payload."""
        xi = np.ascontiguousarray(x, dtype=np.int16)
        rc = self.lib.silk_enc_encode(self.h, _ptr(xi, ctypes.c_int16), xi.shape[0],
                                      budget_bytes, _ptr(self._out, ctypes.c_uint8))
        if rc < 0:
            raise ValueError(f"native silk encode failed: {rc}")
        return bytes(self._out[:rc])


class NativeSilkEncoderBatch:
    """Batch of native SILK encoders (silk_encoder.inc), one mono stream
    each at a fixed internal rate, CBR; one C call encodes every stream.
    Payloads carry no ToC byte."""

    def __init__(self, batch: int, fs_khz: int):
        self.lib = _load()
        self.batch = batch
        self.handles = (ctypes.c_void_p * batch)(
            *[self.lib.silk_enc_create(fs_khz) for _ in range(batch)])
        if not all(self.handles):
            raise ValueError(f"bad internal rate {fs_khz}")

    def __del__(self):
        try:
            for h in self.handles:
                self.lib.silk_enc_destroy(h)
        except (AttributeError, TypeError):
            pass

    def encode_batch(self, x: np.ndarray, budget_bytes: int):
        """x [B, n] int16 at the internal rate -> (payloads [B, 1275] u8,
        sizes [B])."""
        B = self.batch
        xi = np.ascontiguousarray(x, dtype=np.int16)
        out = np.zeros((B, 1275), np.uint8)
        sizes = np.zeros(B, np.int32)
        rc = self.lib.silk_enc_encode_batch(
            self.handles, _ptr(xi, ctypes.c_int16), xi.shape[1], B, xi.shape[1],
            budget_bytes, _ptr(out, ctypes.c_uint8), out.shape[1], _ptr(sizes, ctypes.c_int32))
        if rc != B:
            raise ValueError(f"native silk batch encode failed at {-rc - 1}")
        return out, sizes


class NativeVoiceEncoder:
    """Native mono voice (SILK-only) encoder with the input-rate
    conversion inside (silk_encoder.inc VoiceEnc)."""

    def __init__(self, fs_khz: int, in_rate_hz: int, fec: bool = False):
        self.lib = _load()
        self.h = self.lib.voice_enc_create(fs_khz, in_rate_hz, int(fec))
        if not self.h:
            raise ValueError(f"bad internal rate {fs_khz}")
        self._out = np.zeros(1400, np.uint8)

    def __del__(self):
        try:
            self.lib.voice_enc_destroy(self.h)
        except (AttributeError, TypeError):
            pass

    @property
    def final_range(self) -> int:
        return int(self.lib.voice_enc_rng(self.h))

    def encode(self, x: np.ndarray, budget_bytes: int) -> bytes:
        """x: int16 at the input rate (10/20/40/60 ms) -> SILK payload."""
        xi = np.ascontiguousarray(x, dtype=np.int16)
        rc = self.lib.voice_enc_encode(self.h, _ptr(xi, ctypes.c_int16), xi.shape[0],
                                       budget_bytes, _ptr(self._out, ctypes.c_uint8))
        if rc < 0:
            raise ValueError(f"native voice encode failed: {rc}")
        return bytes(self._out[:rc])


class NativeStereoVoiceEncoder:
    """Native stereo voice (SILK mid/side) encoder with the input-rate
    conversion of each channel inside (silk_encoder.inc StereoVoiceEnc)."""

    def __init__(self, fs_khz: int, in_rate_hz: int, fec: bool = False):
        self.lib = _load()
        self.h = self.lib.stereo_voice_enc_create(fs_khz, in_rate_hz, int(fec))
        if not self.h:
            raise ValueError(f"bad internal rate {fs_khz}")
        self._out = np.zeros(1400, np.uint8)

    def __del__(self):
        try:
            self.lib.stereo_voice_enc_destroy(self.h)
        except (AttributeError, TypeError):
            pass

    @property
    def final_range(self) -> int:
        return int(self.lib.stereo_voice_enc_rng(self.h))

    def encode(self, left: np.ndarray, right: np.ndarray, budget_bytes: int) -> bytes:
        """left/right: int16 at the input rate (10-60 ms) -> SILK payload."""
        li = np.ascontiguousarray(left, dtype=np.int16)
        ri = np.ascontiguousarray(right, dtype=np.int16)
        rc = self.lib.stereo_voice_enc_encode(self.h, _ptr(li, ctypes.c_int16),
                                              _ptr(ri, ctypes.c_int16), li.shape[0],
                                              budget_bytes, _ptr(self._out, ctypes.c_uint8))
        if rc < 0:
            raise ValueError(f"native stereo voice encode failed: {rc}")
        return bytes(self._out[:rc])


class NativeHybridEncoder:
    """Native hybrid encoder (SILK WB low band + CELT bands 17..19 behind
    one range coder; SWB 20/10 ms, CBR).  Payloads carry no ToC (the
    Opus layer's config 13 for 20 ms)."""

    def __init__(self, channels: int = 1, fec: bool = False):
        self.lib = _load()
        self.channels = channels
        self.h = self.lib.hybrid_enc_create(channels, int(fec))
        self._out = np.zeros(1400, np.uint8)

    def __del__(self):
        try:
            self.lib.hybrid_enc_destroy(self.h)
        except (AttributeError, TypeError):
            pass

    @property
    def final_range(self) -> int:
        return int(self.lib.hybrid_enc_rng(self.h))

    def encode(self, pcm: np.ndarray, nb_bytes: int) -> bytes:
        """pcm: [480|960] (mono) or [n, 2] (stereo) f32 in +-1 at 48 kHz."""
        x = np.ascontiguousarray(pcm, dtype=np.float32).reshape(-1)
        rc = self.lib.hybrid_enc_encode(self.h, _ptr(x, ctypes.c_float),
                                        x.shape[0] // self.channels, nb_bytes,
                                        _ptr(self._out, ctypes.c_uint8))
        if rc < 0:
            raise ValueError(f"native hybrid encode failed: {rc}")
        return bytes(self._out[:rc])


class NativeHybridEncoderBatch:
    """Batch of mono native hybrid encoders; one C call per step."""

    def __init__(self, batch: int):
        self.lib = _load()
        self.batch = batch
        self.handles = (ctypes.c_void_p * batch)(
            *[self.lib.hybrid_enc_create(1, 0) for _ in range(batch)])

    def __del__(self):
        try:
            for h in self.handles:
                self.lib.hybrid_enc_destroy(h)
        except (AttributeError, TypeError):
            pass

    def encode_batch(self, pcm: np.ndarray, nb_bytes: int):
        """pcm [B, n] f32 mono -> (payloads [B, nb_bytes] u8, sizes [B])."""
        B = self.batch
        x = np.ascontiguousarray(pcm, dtype=np.float32)
        out = np.zeros((B, max(nb_bytes, 1)), np.uint8)
        sizes = np.zeros(B, np.int32)
        rc = self.lib.hybrid_enc_encode_batch(
            self.handles, _ptr(x, ctypes.c_float), x.shape[1], B, x.shape[1], nb_bytes,
            _ptr(out, ctypes.c_uint8), out.shape[1], _ptr(sizes, ctypes.c_int32))
        if rc != B:
            raise ValueError(f"native hybrid batch encode failed at {-rc - 1}")
        return out, sizes


class NativeSilkFrontEnd:
    """Native SILK plane A of one mono stream: the bit-exact 20 ms frame
    decode and, on request, the device-plane parameters."""

    def __init__(self, fs_khz: int):
        self.lib = _load()
        self.fs_khz = fs_khz
        self.h = self.lib.silk_fe_create(fs_khz)
        L = 20 * fs_khz
        self._xq = np.zeros(L, np.int16)
        self._gexc = np.zeros(L, np.float32)
        self._a1 = np.zeros(16, np.float32)
        self._a2 = np.zeros(16, np.float32)
        self._bt = np.zeros(20, np.float32)
        self._head = np.zeros(18 * fs_khz + 2, np.float32)
        self._meta = np.zeros(8, np.int32)
        self._rng = ctypes.c_uint32()

    def __del__(self):
        try:
            self.lib.silk_fe_destroy(self.h)
        except (AttributeError, TypeError):
            pass

    def decode(self, payload: bytes, want_planes: bool = False):
        """Decode one 20 ms mono SILK frame -> (xq int16, planes | None)."""
        planes = (self._gexc, self._a1, self._a2, self._bt, self._head)
        args = ([_ptr(a, ctypes.c_float) for a in planes] + [_ptr(self._meta, ctypes.c_int32)]
                if want_planes else [None] * 6)
        rc = self.lib.silk_fe_decode(self.h, payload, len(payload),
                                     _ptr(self._xq, ctypes.c_int16), *args,
                                     ctypes.byref(self._rng))
        if rc != 0:
            raise ValueError(f"native silk decode failed: {rc}")
        if not want_planes:
            return self._xq.copy(), None
        return self._xq.copy(), {
            "gexc": self._gexc.copy(), "a1": self._a1.copy(), "a2": self._a2.copy(),
            "b": self._bt.reshape(4, 5).copy(), "head": self._head.copy(),
            "voiced": bool(self._meta[0]), "lags": self._meta[2:6].copy(),
        }

    @property
    def final_range(self) -> int:
        return int(self._rng.value)


class NativeSilkBatch:
    """Batch of native SILK decoders; one C call decodes every stream."""

    def __init__(self, batch: int, fs_khz: int):
        self.proto = NativeSilkFrontEnd(fs_khz)
        self.lib = self.proto.lib
        self.batch = batch
        self.fs_khz = fs_khz
        self.handles = (ctypes.c_void_p * batch)(
            *[self.lib.silk_fe_create(fs_khz) for _ in range(batch)])
        self.L = 20 * fs_khz

    def __del__(self):
        try:
            for h in self.handles:
                self.lib.silk_fe_destroy(h)
        except (AttributeError, TypeError):
            pass

    def decode_batch(self, payloads: list):
        """payloads: B mono 20 ms SILK frames (no ToC) -> (xq [B, L] int16,
        final ranges [B] u32)."""
        lens = np.array([len(p) for p in payloads], np.int32)
        xq = np.zeros((self.batch, self.L), np.int16)
        rngs = np.zeros(self.batch, np.uint32)
        rc = self.lib.silk_fe_decode_batch(
            self.handles, b"".join(payloads), _ptr(lens, ctypes.c_int32), self.batch,
            _ptr(xq, ctypes.c_int16), self.L, _ptr(rngs, ctypes.c_uint32))
        if rc != self.batch:
            raise ValueError(f"native silk batch failed at {-rc - 1}")
        return xq, rngs


def plan_slot_views(buf: np.ndarray, batch: int, arena_words_per_stream: int,
                    silk_words: int = 0) -> dict:
    """A plan slot over `buf`, an int32 array of plan_slot_words(batch,
    arena_words_per_stream, silk_words) words.

    `buf` holds the uploaded form: the packed fixed regions (header
    [B,2] — the device derives iy_rel from the counts word —, ble Q9
    [B,21], dmeta [B,5], bands w0 [B,16] + eff [B,8]), then a shared
    variable-fill arena of which only the used prefix ships
    (`used_words` after each decode).  The full-precision staging arrays
    (header/ble/meta/gains/bands) stay on the host for the serve loop's
    picks and the numpy oracle; they are not uploaded.

    silk_words > 0 makes a mixed-mode slot (the reference's
    alloc_plan_slots(..., silk_words)): the fixed regions gain an smap
    [B] word, the row of each stream's SILK PCM in the compacted block
    (compact_plan_silk); `silk` is a host staging array [B, 2*silk_words]
    int16 that plane A writes; and `buf` keeps B*silk_words words past
    the arena, where pack_plan_silk lands the compacted rows right after
    the used arena prefix."""
    B = batch
    fixed = B * (PLAN_FIXED_WORDS + (1 if silk_words else 0))
    words = plan_slot_words(B, arena_words_per_stream, silk_words)
    if buf.dtype != np.int32 or buf.shape != (words,):
        raise ValueError(f"plan slot buffer must be int32 [{words}]")
    o = 0
    views = {}
    for name, width in (("hdr_p", 2), ("ble_p", _NB), ("dmeta", 5), ("bw0_p", 16),
                        ("beff_p", 8)):
        views[name] = buf[o : o + B * width].reshape(B, width)
        o += B * width
    silk = smap = None
    if silk_words:
        smap = buf[o : o + B]
        o += B
        silk = np.zeros((B, 2 * silk_words), np.int16)
    return dict(
        buf=buf, mode="plan", fixed_words=fixed, silk_words=silk_words, smap=smap,
        silk=silk, arena=buf[o : o + B * arena_words_per_stream], **views,
        header=np.zeros((B, 4), np.int32),
        ble=np.zeros((B, 2, _NB), np.float32),
        meta=np.zeros((B, 16), np.int32),
        gains=np.zeros((B, 3), np.float32),
        bands=np.zeros((B, _NB, 2), np.int32),
        used_words=0,
    )


def plan_slot_words(batch: int, arena_words_per_stream: int = PLAN_ARENA_WORDS,
                    silk_words: int = 0) -> int:
    """int32 words of a plan slot's buffer: fixed regions (and the smap
    word of a mixed slot), the arena, and the landing room of the
    compacted SILK rows."""
    return batch * (PLAN_FIXED_WORDS + (1 if silk_words else 0) + arena_words_per_stream
                    + silk_words)


def alloc_plan_slots(batch: int, n_slots: int = 4,
                     arena_words_per_stream: int = PLAN_ARENA_WORDS,
                     silk_words: int = 0) -> list:
    """n_slots plan slots over fresh numpy buffers (see plan_slot_views)."""
    words = plan_slot_words(batch, arena_words_per_stream, silk_words)
    return [plan_slot_views(np.zeros(words, np.int32), batch, arena_words_per_stream,
                            silk_words)
            for _ in range(n_slots)]


def finish_plan_slot(slot: dict, used_arena_words: int) -> None:
    """After a successful native plan decode: check the capacities the
    executor needs, record the iy spans, pack the uploaded fixed regions
    and the used prefix length."""
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
    slot["used_words"] = slot["fixed_words"] + used_arena_words


def compact_plan_silk(slot: dict, n_pcm: int) -> int:
    """Build the SILK row map after a mixed plan decode: smap[b] = row of
    stream b's PCM in the compacted block (an out-of-range sentinel
    selects the zero row on the device).  All-zero rows — every CELT-only
    stream, and silent SILK frames, for which zero is exact — ship no
    bytes.  Returns the row count."""
    nz = slot["silk"][:, :n_pcm].any(axis=1)
    rows = np.flatnonzero(nz)
    slot["smap"][:] = 0x7FFFFF
    slot["smap"][rows] = np.arange(len(rows), dtype=np.int32)
    slot["silk_rows"] = rows
    return len(rows)


def pack_plan_silk(slot: dict) -> tuple[int, int]:
    """Copy the compacted SILK rows into the upload buffer right after the
    used arena prefix (at least one arena word, as the executor's clamped
    fetch needs).  Returns (the rows' word offset, the upload prefix
    length in words); the device step reads the arena up to the offset
    and the rows from it on."""
    sw = slot["silk_words"]
    at = max(slot["used_words"], slot["fixed_words"] + 1)
    rows = slot["silk_rows"]
    dst = slot["buf"][at : at + len(rows) * sw].view(np.int16).reshape(len(rows), 2 * sw)
    dst[:] = slot["silk"][rows]
    return at, at + len(rows) * sw


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
