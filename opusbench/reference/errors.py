"""Error types of the scalar decoders (a copy of opus_tpu.errors).

One Python exception class per failure of the Opus error surface.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from __future__ import annotations


class OpusError(Exception):
    """Base class for all Opus codec errors."""


class BadArguments(OpusError):
    """One or more invalid/out of range arguments."""


class InvalidPacket(OpusError):
    """The compressed data passed is corrupted or of an unsupported type."""


class FrameSizeTooSmall(OpusError):
    """The frame size is too small to hold the decoded data."""


class BufferTooSmall(OpusError):
    """The given buffer is too small."""


class InternalError(OpusError):
    """An internal error was detected."""


class UnsupportedMode(OpusError):
    """The packet requires a codec layer not yet built in this framework."""
