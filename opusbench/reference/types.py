"""Public types of the codec library, a copy of opus_tpu.types.

Channel layouts, sampling rates, the bandwidth and codec-mode codes, the
ToC config's bandwidth table and the float/int16 sample conversion.  The
packet layer, Decoder, Encoder, the containers and the CLI use them.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import enum

import numpy as np


class Channels(enum.IntEnum):
    """Audio channel configuration (reference: lib.rs:109-116)."""

    MONO = 1
    STEREO = 2


class SamplingRate(enum.IntEnum):
    """Supported API sampling rates in Hz (reference: lib.rs:118-131)."""

    HZ_8000 = 8000
    HZ_12000 = 12000
    HZ_16000 = 16000
    HZ_24000 = 24000
    HZ_48000 = 48000

    @property
    def resampling_factor(self) -> int:
        """Integer decimation factor relative to the 48 kHz internal rate
        (reference: lib.rs:133-143)."""
        return 48000 // int(self)


class Bandwidth(enum.IntEnum):
    """Audio bandwidth of an Opus stream (reference: lib.rs:145-158).

    Values match libopus' OPUS_BANDWIDTH_* constants so that results are
    directly comparable with the libopus oracle in tests.
    """

    NARROWBAND = 1101  # 4 kHz passband
    MEDIUMBAND = 1102  # 6 kHz passband
    WIDEBAND = 1103  # 8 kHz passband
    SUPERWIDEBAND = 1104  # 12 kHz passband
    FULLBAND = 1105  # 20 kHz passband


class CodecMode(enum.Enum):
    """Coding layer in use for a packet (reference: lib.rs:201-210)."""

    SILK_ONLY = enum.auto()
    HYBRID = enum.auto()
    CELT_ONLY = enum.auto()


def _make_bandwidth_table() -> tuple[Bandwidth, ...]:
    """ToC-config (0..31) -> Bandwidth map (reference: lib.rs:160-193).

    Derived from the RFC 6716 sec. 3.1 configuration table instead of being
    written out literally: configs 0-11 are SILK NB/MB/WB, 12-13 hybrid SWB,
    14-15 hybrid FB, 16-19 CELT NB, 20-31 CELT WB/SWB/FB.
    """
    spans = [
        (4, Bandwidth.NARROWBAND),
        (4, Bandwidth.MEDIUMBAND),
        (4, Bandwidth.WIDEBAND),
        (2, Bandwidth.SUPERWIDEBAND),
        (2, Bandwidth.FULLBAND),
        (4, Bandwidth.NARROWBAND),
        (4, Bandwidth.WIDEBAND),
        (4, Bandwidth.SUPERWIDEBAND),
        (4, Bandwidth.FULLBAND),
    ]
    table: list[Bandwidth] = []
    for count, bw in spans:
        table.extend([bw] * count)
    assert len(table) == 32
    return tuple(table)


BANDWIDTH_TABLE: tuple[Bandwidth, ...] = _make_bandwidth_table()


# ---------------------------------------------------------------------------
# Sample-format conversion (reference: lib.rs:58-107).
#
# The decoder produces float32 PCM in [-1, 1]; these helpers convert it to a
# user-requested sample format with the exact scaling/clamping rules of the
# reference so integration tests can compare against it bit-for-bit.
# ---------------------------------------------------------------------------

_CONVERTERS = {}


def _converter(dtype):
    def register(fn):
        _CONVERTERS[np.dtype(dtype)] = fn
        return fn

    return register


@_converter(np.float32)
def _to_f32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32)


@_converter(np.float64)
def _to_f64(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float64)


@_converter(np.int16)
def _to_i16(x: np.ndarray) -> np.ndarray:
    y = x.astype(np.float32) * np.float32(32768.0)
    return np.clip(y, -32768.0, 32767.0).astype(np.int16)


@_converter(np.int32)
def _to_i32(x: np.ndarray) -> np.ndarray:
    y = x.astype(np.float64) * 2147483648.0
    return np.clip(y, -2147483648.0, 2147483647.0).astype(np.int64).astype(np.int32)


@_converter(np.uint16)
def _to_u16(x: np.ndarray) -> np.ndarray:
    y = x.astype(np.float32) * np.float32(32768.0) + np.float32(32768.0)
    return np.clip(y, 0.0, 32768.0).astype(np.uint16)


@_converter(np.uint32)
def _to_u32(x: np.ndarray) -> np.ndarray:
    y = x.astype(np.float64) * 2147483648.0 + 2147483648.0
    return np.clip(y, 0.0, 2147483648.0).astype(np.uint32)


def convert_samples(pcm_f32: np.ndarray, dtype) -> np.ndarray:
    """Convert float32 PCM to the requested sample format.

    Supported formats (matching the reference ``Sample`` impls): float32,
    float64, int16, int32, uint16, uint32.
    """
    dt = np.dtype(dtype)
    try:
        fn = _CONVERTERS[dt]
    except KeyError:
        raise TypeError(f"unsupported sample format: {dtype!r}") from None
    return fn(np.asarray(pcm_f32))
