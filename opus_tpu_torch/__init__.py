"""opus_tpu_torch — the Opus codec in PyTorch, for CUDA.

A port of `opus_tpu` (JAX) to PyTorch on an NVIDIA H100, in two parts.

The codec library runs on the host, one stream at a time: the scalar
Decoder (decoder.py), Encoder (encoder.py), the packet layer, the
repacketizer, the multistream codec, Ogg Opus (ogg.py), the RFC 8251
metric (conformance.py) and the CLI (`python -m opus_tpu_torch`).  These
modules are copies of the reference's numpy code.

The serving decoders (batch/) run a whole batch of streams per step.
Plane A, the range-decoding front end, is the package's own copy of the
C++ engine (native/, built with g++ at first use); plane B, on the
device, rebuilds the band spectra from plane A's plan (dsp/plan_exec.py)
or unpacks them, then synthesises: denormalise, IMDCT, TDAC overlap-add,
pitch post-filter and de-emphasis.  The pitch post-filter and the
spreading rotation are CUDA kernels written by hand (csrc/); the rest is
plain torch.

The package imports torch and never jax, and nothing of `opus_tpu`, which
stays the reference that every function here is tested against.
"""

import torch

# The synthesis matmuls (IMDCT basis, band one-hot, de-emphasis Toeplitz)
# must run in full float32: the reference asks for Precision.HIGHEST, and
# TF32's 10-bit mantissa is audible in decoded PCM.
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .errors import (  # noqa: E402
    BadArguments,
    BufferTooSmall,
    FrameSizeTooSmall,
    InternalError,
    InvalidPacket,
    OpusError,
    UnsupportedMode,
)
from .packet import (  # noqa: E402
    MAX_FRAME_BYTES,
    MAX_FRAMES_PER_PACKET,
    ParsedPacket,
    parse_packet,
    query_packet_bandwidth,
    query_packet_channel_count,
    query_packet_codec_mode,
    query_packet_frame_count,
    query_packet_sample_count,
    query_packet_samples_per_frame,
)
from .decoder import Decoder, DecoderConfiguration  # noqa: E402
from .softclip import pcm_soft_clip  # noqa: E402
from .types import Bandwidth, Channels, CodecMode, SamplingRate, convert_samples  # noqa: E402

__all__ = [
    "BadArguments",
    "BufferTooSmall",
    "FrameSizeTooSmall",
    "InternalError",
    "InvalidPacket",
    "OpusError",
    "UnsupportedMode",
    "MAX_FRAME_BYTES",
    "MAX_FRAMES_PER_PACKET",
    "ParsedPacket",
    "parse_packet",
    "query_packet_bandwidth",
    "query_packet_channel_count",
    "query_packet_codec_mode",
    "query_packet_frame_count",
    "query_packet_sample_count",
    "query_packet_samples_per_frame",
    "Decoder",
    "DecoderConfiguration",
    "pcm_soft_clip",
    "Bandwidth",
    "Channels",
    "CodecMode",
    "SamplingRate",
    "convert_samples",
]

__version__ = "0.1.0"
