"""ctypes bindings to the system libopus, the port's conformance oracle.

A copy of the reference package's `oracle.py` (the code below this
docstring; tests/test_torch_library.py holds the syntax trees equal), so
that the port's tests and its sanitizer lane can drive libopus without
importing the reference.  It needs ctypes and numpy only.  Encoder output
feeds the port's decoders and the other way round, and `final_range`
checksums prove the entropy coders agree bit for bit.  `available()` is
False where no libopus is found, as on a machine without it; nothing in
the decode or encode path imports this module.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

# --- public opus_defines.h constants ---------------------------------------
OPUS_OK = 0
APPLICATION_VOIP = 2048
APPLICATION_AUDIO = 2049
APPLICATION_RESTRICTED_LOWDELAY = 2051

SET_BITRATE = 4002
SET_MAX_BANDWIDTH = 4004
SET_VBR = 4006
SET_BANDWIDTH = 4008
GET_BANDWIDTH = 4009
SET_COMPLEXITY = 4010
SET_INBAND_FEC = 4012
SET_PACKET_LOSS_PERC = 4014
SET_DTX = 4016
SET_VBR_CONSTRAINT = 4020
SET_FORCE_CHANNELS = 4022
SET_SIGNAL = 4024
RESET_STATE = 4028
GET_FINAL_RANGE = 4031
GET_PITCH = 4033
SET_GAIN = 4034
SET_LSB_DEPTH = 4036
GET_LAST_PACKET_DURATION = 4039
SET_EXPERT_FRAME_DURATION = 4040
SET_PREDICTION_DISABLED = 4042
SET_PHASE_INVERSION_DISABLED = 4046

SIGNAL_VOICE = 3001
SIGNAL_MUSIC = 3002
BANDWIDTH_NARROWBAND = 1101
BANDWIDTH_MEDIUMBAND = 1102
BANDWIDTH_WIDEBAND = 1103
BANDWIDTH_SUPERWIDEBAND = 1104
BANDWIDTH_FULLBAND = 1105

FRAMESIZE_ARG = 5000
FRAMESIZE_2_5_MS = 5001
FRAMESIZE_5_MS = 5002
FRAMESIZE_10_MS = 5003
FRAMESIZE_20_MS = 5004
FRAMESIZE_40_MS = 5005
FRAMESIZE_60_MS = 5006

# opus_private.h — handled unconditionally by opus_encoder_ctl, used by the
# upstream test suite to pin the coding mode.
SET_FORCE_MODE = 11002
MODE_SILK_ONLY = 1000
MODE_HYBRID = 1001
MODE_CELT_ONLY = 1002

AUTO = -1000

_lib = None


def load():
    """Load libopus, or return None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libopus.so.0", "opus"):
        try:
            path = name if name.endswith(".so.0") else ctypes.util.find_library(name)
            if path is None:
                continue
            _lib = ctypes.CDLL(path)
            break
        except OSError:
            continue
    if _lib is None:
        return None
    _lib.opus_get_version_string.restype = ctypes.c_char_p
    for fn in (
        "opus_decoder_create",
        "opus_encoder_create",
        "opus_multistream_decoder_create",
        "opus_multistream_encoder_create",
        "opus_repacketizer_create",
    ):
        getattr(_lib, fn).restype = ctypes.c_void_p
    return _lib


def available() -> bool:
    return load() is not None


def version() -> str:
    return load().opus_get_version_string().decode()


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise RuntimeError(f"libopus {what} failed: {rc}")
    return rc


class Encoder:
    """Minimal opus_encoder wrapper producing packets + final_range."""

    def __init__(self, rate: int = 48000, channels: int = 2, application: int = APPLICATION_AUDIO):
        self.lib = load()
        err = ctypes.c_int()
        self.ptr = ctypes.c_void_p(
            self.lib.opus_encoder_create(rate, channels, application, ctypes.byref(err))
        )
        _check(err.value, "opus_encoder_create")
        self.rate = rate
        self.channels = channels

    def ctl(self, request: int, value: int | None = None) -> int:
        if value is None:
            out = ctypes.c_int()
            _check(self.lib.opus_encoder_ctl(self.ptr, request, ctypes.byref(out)), f"ctl {request}")
            return out.value
        return _check(self.lib.opus_encoder_ctl(self.ptr, request, ctypes.c_int(value)), f"ctl {request}")

    @property
    def final_range(self) -> int:
        out = ctypes.c_uint32()
        _check(self.lib.opus_encoder_ctl(self.ptr, GET_FINAL_RANGE, ctypes.byref(out)), "final_range")
        return out.value

    def encode_float(self, pcm: np.ndarray, frame_size: int, max_bytes: int = 4000) -> bytes:
        pcm = np.ascontiguousarray(pcm, dtype=np.float32)
        assert pcm.size == frame_size * self.channels
        buf = ctypes.create_string_buffer(max_bytes)
        n = _check(
            self.lib.opus_encode_float(
                self.ptr,
                pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frame_size,
                buf,
                max_bytes,
            ),
            "opus_encode_float",
        )
        return buf.raw[:n]

    def __del__(self):
        if getattr(self, "ptr", None) and self.lib:
            self.lib.opus_encoder_destroy(self.ptr)


class Decoder:
    """Minimal opus_decoder wrapper with final_range/pitch introspection."""

    def __init__(self, rate: int = 48000, channels: int = 2):
        self.lib = load()
        err = ctypes.c_int()
        self.ptr = ctypes.c_void_p(
            self.lib.opus_decoder_create(rate, channels, ctypes.byref(err))
        )
        _check(err.value, "opus_decoder_create")
        self.rate = rate
        self.channels = channels

    def ctl(self, request: int, value: int | None = None) -> int:
        if value is None:
            out = ctypes.c_int()
            _check(self.lib.opus_decoder_ctl(self.ptr, request, ctypes.byref(out)), f"ctl {request}")
            return out.value
        return _check(self.lib.opus_decoder_ctl(self.ptr, request, ctypes.c_int(value)), f"ctl {request}")

    @property
    def final_range(self) -> int:
        out = ctypes.c_uint32()
        _check(self.lib.opus_decoder_ctl(self.ptr, GET_FINAL_RANGE, ctypes.byref(out)), "final_range")
        return out.value

    def decode_float(self, packet: bytes | None, frame_size: int, fec: bool = False) -> np.ndarray:
        out = np.zeros(frame_size * self.channels, dtype=np.float32)
        data = packet if packet is not None else None
        n = _check(
            self.lib.opus_decode_float(
                self.ptr,
                data,
                0 if packet is None else len(packet),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frame_size,
                1 if fec else 0,
            ),
            "opus_decode_float",
        )
        return out[: n * self.channels].reshape(n, self.channels)

    def decode_int16(self, packet: bytes | None, frame_size: int, fec: bool = False) -> np.ndarray:
        out = np.zeros(frame_size * self.channels, dtype=np.int16)
        n = _check(
            self.lib.opus_decode(
                self.ptr,
                packet,
                0 if packet is None else len(packet),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                frame_size,
                1 if fec else 0,
            ),
            "opus_decode",
        )
        return out[: n * self.channels].reshape(n, self.channels)

    def __del__(self):
        if getattr(self, "ptr", None) and self.lib:
            self.lib.opus_decoder_destroy(self.ptr)


class MultistreamEncoder:
    """opus_multistream_encoder wrapper."""

    def __init__(self, rate, channels, streams, coupled, mapping, application=APPLICATION_AUDIO):
        self.lib = load()
        err = ctypes.c_int()
        m = (ctypes.c_ubyte * channels)(*mapping)
        self.ptr = ctypes.c_void_p(
            self.lib.opus_multistream_encoder_create(
                rate, channels, streams, coupled, m, application, ctypes.byref(err)
            )
        )
        _check(err.value, "ms_encoder_create")
        self.channels = channels

    def ctl(self, request: int, value: int) -> int:
        return _check(self.lib.opus_multistream_encoder_ctl(self.ptr, request, ctypes.c_int(value)), "ms ctl")

    def encode_float(self, pcm, frame_size, max_bytes=8000) -> bytes:
        import numpy as _np

        pcm = _np.ascontiguousarray(pcm, dtype=_np.float32)
        buf = ctypes.create_string_buffer(max_bytes)
        n = _check(
            self.lib.opus_multistream_encode_float(
                self.ptr, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frame_size, buf, max_bytes,
            ),
            "ms_encode",
        )
        return buf.raw[:n]

    @property
    def final_range(self) -> int:
        out = ctypes.c_uint32()
        _check(self.lib.opus_multistream_encoder_ctl(self.ptr, GET_FINAL_RANGE, ctypes.byref(out)), "fr")
        return out.value


class MultistreamDecoder:
    """opus_multistream_decoder wrapper."""

    def __init__(self, rate, channels, streams, coupled, mapping):
        self.lib = load()
        err = ctypes.c_int()
        m = (ctypes.c_ubyte * channels)(*mapping)
        self.ptr = ctypes.c_void_p(
            self.lib.opus_multistream_decoder_create(rate, channels, streams, coupled, m, ctypes.byref(err))
        )
        _check(err.value, "ms_decoder_create")
        self.channels = channels

    def decode_float(self, packet, frame_size):
        import numpy as _np

        out = _np.zeros(frame_size * self.channels, dtype=_np.float32)
        n = _check(
            self.lib.opus_multistream_decode_float(
                self.ptr, packet, 0 if packet is None else len(packet),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frame_size, 0,
            ),
            "ms_decode",
        )
        return out[: n * self.channels].reshape(n, self.channels)

    @property
    def final_range(self) -> int:
        out = ctypes.c_uint32()
        _check(self.lib.opus_multistream_decoder_ctl(self.ptr, GET_FINAL_RANGE, ctypes.byref(out)), "fr")
        return out.value
