"""The SILK layer (RFC 6716 sec. 4.2), copied from opus_tpu.silk.

The SILK-only batch decoder runs its symbol decode and parameter
dequantisation on the host (tables, fixed_math, bitstream, nlsf, decoder,
and resampler, which the channel state builds).  The scalar codec library
adds the rest: the scalar SILK layer of the Decoder (api, with stereo and
plc) and the Python encoders that the Encoder builds (encoder,
stereo_encoder).

Below this docstring the code is the reference's, unchanged
(tests/test_torch_silk.py and tests/test_torch_library.py hold the two
equal).
"""
