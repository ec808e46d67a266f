"""The spreading-rotation pass: the CUDA kernel's wrapper and its plain version.

`rot_pass` runs one `exp_rotation1` pass over the contiguous chains of a
flat [B, N] band plane.  On a CUDA tensor it launches the hand-written
kernel (csrc/rotation.cu, the port of opus_tpu/dsp/pallas_rot.py
::_rot_kernel) and raises if the kernel does not build or launch.  On a
CPU tensor it runs `_rot_pass_ref`, the plain torch port of the XLA
ladder opus_tpu.dsp.plan_exec._rot_pass, which defines the semantics the
kernel is held to.

Chains are runs of positions with k_pos = 0, 1, ..., m-1 and m_pos = m
(the chain length, 1 = identity).  Per chain, with per-position
coefficients c = cc, s = ss:

* forward: v[0] = x[0], v[t] = s v[t-1] + c x[t];
  y[t] = v[t] at the tail, c v[t] - s x[t+1] elsewhere;
* chains of length >= 3 then run backward: z[t] = y[t] for the last two
  positions, z[t] = -s z[t+1] + c y[t] below them, and the output is
  z[0] at the head, y at the tail and c z[t] + s y[t-1] between.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Longest chain the ladder covers: 8 doubling levels reach 255 back, and
#: no chain exceeds the widest band (176 bins at any frame size).
MAX_CHAIN = 256


def _seg_scan(a, b):
    """Inclusive scan of v[t] = a[t]*v[t-1] + b[t] along the last axis,
    as Hillis-Steele over the linear-function monoid (8 doubling levels;
    a == 0 at every chain head resets the chain)."""
    A, Bv = a, b
    span = 1
    while span < MAX_CHAIN:
        Ash = F.pad(A, (span, 0), value=1.0)[:, :-span]
        Bsh = F.pad(Bv, (span, 0))[:, :-span]
        A, Bv = A * Ash, A * Bsh + Bv
        span *= 2
    return Bv


def _rot_pass_ref(x, cc, ss, k_pos, m_pos):
    """Plain torch rotation pass (the XLA `_rot_pass`, op for op)."""
    first = k_pos == 0
    last = k_pos == m_pos - 1
    a = torch.where(first, 0.0, ss)
    b = torch.where(first, x, cc * x)
    v = _seg_scan(a, b)
    x_next = torch.roll(x, -1, dims=-1)
    y = torch.where(last, v, cc * v - ss * x_next)
    # backward pass (only chains of length >= 3), on the reversed plane:
    # reversed chain position kr == 0 is the natural tail.
    yr = torch.flip(y, dims=(-1,))
    kr = torch.flip(m_pos - 1 - k_pos, dims=(-1,))
    ccr = torch.flip(cc, dims=(-1,))
    ssr = torch.flip(ss, dims=(-1,))
    tail2 = (kr == 0) | (kr == 1)
    ar = torch.where(tail2, 0.0, -ssr)
    br = torch.where(tail2, yr, ccr * yr)
    z = torch.flip(_seg_scan(ar, br), dims=(-1,))
    y_prev = torch.roll(y, 1, dims=-1)
    f = torch.where(first, z, torch.where(last, y, cc * z + ss * y_prev))
    return torch.where(m_pos < 3, y, f)


def _check(x, cc, ss, k_pos, m_pos):
    if x.dim() != 2:
        raise ValueError(f"x must be [B, N], got {tuple(x.shape)}")
    for name, t, dtype in (("x", x, torch.float32), ("cc", cc, torch.float32),
                           ("ss", ss, torch.float32), ("k_pos", k_pos, torch.int32),
                           ("m_pos", m_pos, torch.int32)):
        if t.shape != x.shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be {dtype} {tuple(x.shape)} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_args(x, cc, ss, k_pos, m_pos, out) -> tuple:
    """The C arguments of one launch into `out` on checked CUDA tensors,
    but the stream (which `_build.launch` adds)."""
    return (x.data_ptr(), cc.data_ptr(), ss.data_ptr(), k_pos.data_ptr(), m_pos.data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[1])


def rot_pass(x, cc, ss, k_pos, m_pos):
    """One exp_rotation1 pass over the chains of x [B, N]; returns a new
    [B, N] tensor.  x, cc, ss float32; k_pos, m_pos int32; all [B, N]
    contiguous on one device.  A CUDA tensor goes through the kernel (each
    launch adds one to `rot_pass.launches`); a CPU tensor through
    `_rot_pass_ref`."""
    _check(x, cc, ss, k_pos, m_pos)
    if x.device.type == "cpu":
        return _rot_pass_ref(x, cc, ss, k_pos, m_pos)
    if x.device.type != "cuda":
        raise ValueError(f"rot_pass runs on cpu or cuda, not {x.device}")
    from .. import _build

    out = torch.empty_like(x)
    _build.launch("opus_rot_pass", x.device, _kernel_args(x, cc, ss, k_pos, m_pos, out))
    rot_pass.launches += 1
    return out


rot_pass.launches = 0
