"""The SILK layer (RFC 6716 sec. 4.2), copied from opus_tpu.silk.

Symbol decode and parameter dequantisation (tables, fixed_math,
bitstream, nlsf, decoder, and resampler, which the channel state builds)
and the scalar SILK layer of the Decoder (api, with stereo and plc); the
reference's Python encoders are not copied.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_silk.py and tests/test_torch_library.py hold the two
equal).
"""
