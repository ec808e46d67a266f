"""The Opus range coder (RFC 6716 sec. 4.1), a copy of opus_tpu.rc.

The scalar CELT decoder (celt/decoder.py) reads its symbols through
RangeDecoder; the reference's RangeEncoder is not copied (nothing here
encodes).

Below this docstring the code is the reference's, unchanged
(tests/test_torch_celt_decoder.py holds the two equal).
"""

from .common import BITRES, Tell, ilog
from .decoder import RangeDecoder

__all__ = ["BITRES", "Tell", "ilog", "RangeDecoder"]
