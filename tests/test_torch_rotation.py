"""The port's rotation pass against the reference's.

`_rot_pass_ref` (plain torch, the XLA ladder op for op) is held to the
Pallas kernel in interpret mode (atol 1e-6, the reference's own gate in
tests/test_pallas_rot.py: same operations, 1-ulp reassociation noise on
the CPU) over random chain geometry, and to the scalar `_exp_rotation1`
replay in float64 (atol 2e-6, the reference's gate).  The CUDA kernel
has no CPU mode: a float64 numpy model of its decomposition (64 thread
segments in two warps, their maps scanned, the segments walked again,
forward and backward) is held to the Pallas kernel here at the scalar
gate, and the
kernel itself is held to `_rot_pass_ref` in the cases marked `cuda`,
which skip here.
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


#: Row geometries that stress the kernel's lane segments (see _chains).
KINDS = ("random", "across", "ones", "twos", "long", "full")


#: Threads per row in csrc/rotation.cu: two warps.
THREADS = 64


def _chains(rng, kind, N):
    """Chain lengths tiling a row of N for one geometry kind."""
    seg = -(-N // THREADS)
    if kind == "random":
        out = []
        while sum(out) < N:
            out.append(int(rng.choice(LENGTHS)))
    elif kind == "across":  # a chain straddles every segment boundary
        out = [max(1, seg // 2)] + [seg] * N
    elif kind == "ones":
        out = [1] * N
    elif kind == "twos":
        out = [2] * N
    elif kind == "long":  # the widest band, then identity
        out = [176] + [1] * N
    else:  # one chain per row where the ladder reaches (255 back), else 176s
        out = [N] if N <= 240 else [176] * N
    lengths, t = [], 0
    for m in out:
        if t == N:
            break
        lengths.append(min(m, N - t))
        t += lengths[-1]
    return lengths


def _adversarial_inputs(seed, B, N):
    """Rows cycling through KINDS, with random coefficients per chain
    (one chain in five identity)."""
    rng = np.random.default_rng(seed)
    k_pos = np.zeros((B, N), np.int32)
    m_pos = np.ones((B, N), np.int32)
    cc = np.ones((B, N), np.float32)
    ss = np.zeros((B, N), np.float32)
    for r in range(B):
        t = 0
        for m in _chains(rng, KINDS[r % len(KINDS)], N):
            th = 0.5 * rng.uniform(0.1, 1.0) ** 2
            k_pos[r, t : t + m] = np.arange(m)
            m_pos[r, t : t + m] = m
            if rng.random() < 0.8:
                cc[r, t : t + m] = np.cos(0.5 * np.pi * th)
                ss[r, t : t + m] = np.cos(0.5 * np.pi * (1.0 - th))
            t += m
        assert t == N
    x = rng.standard_normal((B, N)).astype(np.float32)
    return x, cc, ss, k_pos, m_pos


def _lane_segment_model(x, cc, ss, k_pos, m_pos, warps=2):
    """float64 numpy model of csrc/rotation.cu's decomposition of a row.

    Thread T of 32 * warps owns positions [T*seg, (T+1)*seg), seg =
    ceil(N / threads).  Forward: each thread composes its segment's map
    v -> A v + B of v[t] = a[t] v[t-1] + b[t]; a Hillis-Steele scan over
    each warp's 32 maps (the kernel's five shuffle levels) and the
    earlier warps' totals give each thread its carry-in; each thread
    walks its segment again and writes y as float32.  Backward: the same
    from the right over y, reset at every chain's last two positions (the
    kernel composes these maps during the forward walk; the product is
    the same)."""
    B, N = x.shape
    lanes = 32 * warps
    seg = -(-N // lanes)
    spans = [range(min(L * seg, N), min((L + 1) * seg, N)) for L in range(lanes)]
    c, s, x64 = cc.astype(np.float64), ss.astype(np.float64), x.astype(np.float64)
    head, tail = k_pos == 0, k_pos == m_pos - 1
    last_two = tail | (k_pos == m_pos - 2)

    def carries(a, b, forward):
        A, Bm = np.ones((B, lanes)), np.zeros((B, lanes))
        for L, span in enumerate(spans):
            for t in span if forward else reversed(span):
                Bm[:, L] = a[:, t] * Bm[:, L] + b[:, t]
                A[:, L] *= a[:, t]
        A, Bm = A.reshape(B, warps, 32), Bm.reshape(B, warps, 32)
        d = 1
        while d < 32:  # inclusive scan in each warp; `src` lanes come first
            dst, src = ((np.s_[..., d:], np.s_[..., :-d]) if forward
                        else (np.s_[..., :-d], np.s_[..., d:]))
            A_new, B_new = A.copy(), Bm.copy()
            B_new[dst] = A[dst] * Bm[src] + Bm[dst]
            A_new[dst] = A[dst] * A[src]
            A, Bm = A_new, B_new
            d *= 2
        one, zero = np.ones((B, warps, 1)), np.zeros((B, warps, 1))
        if forward:  # the warp's map before each lane; the warp's total
            A_ex = np.concatenate([one, A[..., :-1]], axis=2)
            B_ex = np.concatenate([zero, Bm[..., :-1]], axis=2)
            tot = [(A[:, w, -1], Bm[:, w, -1]) for w in range(warps)]
            order = range(warps)
        else:
            A_ex = np.concatenate([A[..., 1:], one], axis=2)
            B_ex = np.concatenate([Bm[..., 1:], zero], axis=2)
            tot = [(A[:, w, 0], Bm[:, w, 0]) for w in range(warps)]
            order = range(warps - 1, -1, -1)
        carry, out = np.zeros(B), np.zeros((B, warps, 32))
        for w in order:
            out[:, w] = A_ex[:, w] * carry[:, None] + B_ex[:, w]
            carry = tot[w][0] * carry + tot[w][1]
        return out.reshape(B, lanes)

    a = np.where(head, 0.0, s)
    b = np.where(head, x64, c * x64)
    v_in = carries(a, b, True)
    x_next = np.roll(x64, -1, axis=1)
    y = np.empty((B, N), np.float32)
    for L, span in enumerate(spans):
        v = v_in[:, L]
        for t in span:
            v = a[:, t] * v + b[:, t]
            y[:, t] = np.where(tail[:, t], v, c[:, t] * v - s[:, t] * x_next[:, t])

    y64 = y.astype(np.float64)
    ar = np.where(last_two, 0.0, -s)
    br = np.where(last_two, y64, c * y64)
    z_in = carries(ar, br, False)
    y_prev = np.roll(y64, 1, axis=1)
    out = np.empty((B, N), np.float32)
    for L, span in enumerate(spans):
        z = z_in[:, L]
        for t in reversed(span):
            z = ar[:, t] * z + br[:, t]
            f = np.where(head[:, t], z,
                         np.where(tail[:, t], y64[:, t], c[:, t] * z + s[:, t] * y_prev[:, t]))
            out[:, t] = np.where(m_pos[:, t] < 3, y[:, t], f)
    return out


@pytest.mark.parametrize("n", [240, 960, 1920])
def test_lane_segment_model_matches_pallas_interpret(n):
    """The kernel's decomposition, on every adversarial row kind (chains
    across every segment boundary, of 1, of 2, of 176, one chain a row,
    random; at n=240 the last four threads own nothing), against the
    Pallas kernel at the scalar gate; the plain version at its 1e-6
    gate."""
    import jax.numpy as jnp

    from opus_tpu.dsp.pallas_rot import pallas_rot_pass

    args = _adversarial_inputs(20 + n, 2 * len(KINDS), n)
    want = np.asarray(pallas_rot_pass(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(_lane_segment_model(*args), want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(_rot_pass_ref(*map(torch.tensor, args)).numpy(), want,
                               rtol=0, atol=1e-6)


def test_lane_segment_model_matches_scalar_replay():
    args, geo = _isolated_chains()
    got = _lane_segment_model(*args)
    for r, (c, s, L) in enumerate(geo):
        np.testing.assert_allclose(got[r, :L], _scalar_replay(args[0][r], c, s, L),
                                   rtol=0, atol=2e-6)
        np.testing.assert_array_equal(got[r, L:], args[0][r, L:])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1920, 960, 240])
def test_kernel_on_adversarial_geometry_on_card(cuda_device, n):
    """Kernel vs `_rot_pass_ref` on the card, B=1024 rows cycling KINDS."""
    args = [torch.tensor(a, device=cuda_device) for a in _adversarial_inputs(9, 1024, n)]
    want = _rot_pass_ref(*args)
    got = rot_pass(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < 2e-6


@pytest.mark.cuda
def test_kernel_scalar_path_on_card(cuda_device):
    """Rows the 16-byte path cannot take: a length that is not a multiple
    of 4, and planes that start 4 bytes off a 16-byte boundary."""
    for n, shift in ((250, 0), (1920, 1)):
        planes = []
        for a in _adversarial_inputs(10, 64, n):
            flat = torch.zeros(a.size + shift, dtype=torch.from_numpy(a).dtype,
                               device=cuda_device)
            planes.append(flat[shift:].view(a.shape).copy_(torch.from_numpy(a)))
        want = _rot_pass_ref(*planes)
        got = rot_pass(*planes)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) < 2e-6


@pytest.mark.cuda
def test_wrapper_issues_one_launch_on_card(cuda_device):
    """After the first call (build, load), a call is one device kernel."""
    args = [torch.tensor(a, device=cuda_device) for a in _inputs(12, 256, 1920)]
    rot_pass(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        rot_pass(*args)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in device) == 1 and "rot_pass_kernel" in device[0].key
