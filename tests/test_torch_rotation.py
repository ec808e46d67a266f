"""The port's rotation pass against the reference's.

`_rot_pass_ref` (plain torch, the XLA ladder op for op) is held to the
Pallas kernel in interpret mode (atol 1e-6, the reference's own gate in
tests/test_pallas_rot.py: same operations, 1-ulp reassociation noise on
the CPU) over random chain geometry, and to the scalar `_exp_rotation1`
replay in float64 (atol 2e-6, the reference's gate).  The CUDA kernel
has no CPU mode; its cases are marked `cuda` and skip here.
"""

import numpy as np
import pytest
import torch

from opus_tpu_torch.dsp.rotation import _rot_pass_ref, rot_pass

LENGTHS = [1, 1, 2, 3, 5, 8, 21, 44, 87, 176]


def _chain_geometry(rng, B, N):
    """Random per-row chain tiling (k_pos, m_pos, cc, ss); some chains
    keep identity coefficients."""
    k_pos = np.zeros((B, N), np.int32)
    m_pos = np.ones((B, N), np.int32)
    cc = np.ones((B, N), np.float32)
    ss = np.zeros((B, N), np.float32)
    for r in range(B):
        t = 0
        while t < N:
            m = min(int(rng.choice(LENGTHS)), N - t)
            g = rng.uniform(0.1, 1.0)
            th = 0.5 * g * g
            k_pos[r, t : t + m] = np.arange(m)
            m_pos[r, t : t + m] = m
            if rng.random() < 0.8:
                cc[r, t : t + m] = np.cos(0.5 * np.pi * th)
                ss[r, t : t + m] = np.cos(0.5 * np.pi * (1.0 - th))
            t += m
    return k_pos, m_pos, cc, ss


def _inputs(seed, B, N):
    rng = np.random.default_rng(seed)
    k_pos, m_pos, cc, ss = _chain_geometry(rng, B, N)
    x = rng.standard_normal((B, N)).astype(np.float32)
    return x, cc, ss, k_pos, m_pos


def _isolated_chains(N=512):
    """One chain per row from rotation_params at its head, identity after:
    rows of (x, cc, ss, k_pos, m_pos) and each row's (c, s, L)."""
    from opus_tpu_torch.dsp.plan_tables import rotation_params

    rng = np.random.default_rng(1)
    rows, geo = [], []
    for n, k, spread, bq in ((24, 3, 2, 1), (44, 2, 1, 1), (87, 5, 3, 1),
                             (176, 7, 2, 1), (16, 1, 2, 1)):
        c, s, _st2, L = rotation_params(n, k, spread, bq)
        x = rng.standard_normal(N).astype(np.float32)
        k_pos = np.zeros(N, np.int32)
        m_pos = np.ones(N, np.int32)
        cc = np.ones(N, np.float32)
        ss = np.zeros(N, np.float32)
        k_pos[:L] = np.arange(L)
        m_pos[:L] = L
        cc[:L] = c
        ss[:L] = s
        rows.append((x, cc, ss, k_pos, m_pos))
        geo.append((c, s, L))
    return [np.stack(a) for a in zip(*rows)], geo


def _scalar_replay(x_row, c, s, L):
    from opus_tpu.dsp.plan_exec import _exp_rotation1

    seg = x_row[:L].astype(np.float64).copy()
    _exp_rotation1(seg, L, 1, c, s)
    return seg


@pytest.mark.parametrize("seed,B,n", [(0, 8, 3840), (3, 6, 1920), (4, 6, 960)])
def test_plain_version_matches_pallas_interpret(seed, B, n):
    """Random chain geometry, at the reference test's plane and at the
    lm=3 and lm=2 planes of the executor."""
    import jax.numpy as jnp

    from opus_tpu.dsp.pallas_rot import pallas_rot_pass

    args = _inputs(seed, B, n)
    want = np.asarray(pallas_rot_pass(*map(jnp.asarray, args), interpret=True))
    got = _rot_pass_ref(*map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_plain_version_matches_scalar_replay():
    args, geo = _isolated_chains()
    got = _rot_pass_ref(*map(torch.tensor, args)).numpy()
    for r, (c, s, L) in enumerate(geo):
        np.testing.assert_allclose(got[r, :L], _scalar_replay(args[0][r], c, s, L),
                                   rtol=0, atol=2e-6)
        np.testing.assert_array_equal(got[r, L:], args[0][r, L:])


def test_wrapper_on_cpu_runs_plain_version():
    args = [torch.tensor(a) for a in _inputs(5, 4, 480)]
    before = rot_pass.launches
    got = rot_pass(*args)
    assert torch.equal(got, _rot_pass_ref(*args))
    assert rot_pass.launches == before  # only a kernel launch counts


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, cc, ss, k_pos, m_pos = (torch.tensor(a) for a in _inputs(6, 4, 240))
    good = dict(x=x, cc=cc, ss=ss, k_pos=k_pos, m_pos=m_pos)
    for kw in (dict(x=x.double()), dict(cc=cc[:2]), dict(k_pos=k_pos.long()),
               dict(m_pos=m_pos.float()), dict(ss=ss.t().contiguous().t()),
               dict(x=x[:, ::2].contiguous(), cc=cc[:, ::2], ss=ss[:, ::2].contiguous(),
                    k_pos=k_pos[:, ::2].contiguous(), m_pos=m_pos[:, ::2].contiguous()),
               dict(x=x[None])):
        with pytest.raises(ValueError):
            rot_pass(**dict(good, **kw))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rotation kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1920, 960])
def test_kernel_matches_plain_version_on_card(cuda_device, n):
    """Kernel vs `_rot_pass_ref` on the card, B=1024, atol 2e-6."""
    args = [torch.tensor(a, device=cuda_device) for a in _inputs(7, 1024, n)]
    want = _rot_pass_ref(*args)
    before = rot_pass.launches
    got = rot_pass(*args)
    torch.cuda.synchronize()
    assert rot_pass.launches == before + 1
    assert float((got - want).abs().max()) < 2e-6


@pytest.mark.cuda
def test_kernel_matches_scalar_replay_on_card(cuda_device):
    args, geo = _isolated_chains()
    got = rot_pass(*[torch.tensor(a, device=cuda_device) for a in args]).cpu().numpy()
    for r, (c, s, L) in enumerate(geo):
        np.testing.assert_allclose(got[r, :L], _scalar_replay(args[0][r], c, s, L),
                                   rtol=0, atol=2e-6)
        np.testing.assert_array_equal(got[r, L:], args[0][r, L:])
