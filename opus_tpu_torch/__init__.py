"""opus_tpu_torch — the batched CELT serving decode in PyTorch, for CUDA.

A port of the device plane of `opus_tpu` (JAX) to PyTorch on an NVIDIA
H100.  Plane A, the range-decoding front end, is the package's own copy of
the C++ engine (native/, built with g++ at first use); plane B, on the
device, rebuilds the band spectra from plane A's plan (dsp/plan_exec.py)
or unpacks them, then synthesises: denormalise, IMDCT, TDAC overlap-add,
pitch post-filter and de-emphasis over a whole batch of streams per step.
The pitch post-filter and the spreading rotation are CUDA kernels written
by hand (csrc/); the rest is plain torch.

The package imports torch and never jax, and nothing of `opus_tpu`, which
stays the reference that every function here is tested against.
"""

import torch

# The synthesis matmuls (IMDCT basis, band one-hot, de-emphasis Toeplitz)
# must run in full float32: the reference asks for Precision.HIGHEST, and
# TF32's 10-bit mantissa is audible in decoded PCM.
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
