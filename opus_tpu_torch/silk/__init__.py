"""The SILK layer (RFC 6716 sec. 4.2) that the port's SILK-only batch
decoder runs on the host: the symbol decode and parameter dequantisation
of opus_tpu.silk, copied (tables, fixed_math, bitstream, nlsf, decoder,
and resampler, which the channel state builds).

Below this docstring the code is the reference's, unchanged
(tests/test_torch_silk.py holds the two equal).
"""
