"""The port's device loss concealment against the reference's, on the CPU.

Inputs come from numpy seeds; the decode memories the conceal starts from
come from serving a few harmonic frames (three partials on a drifting
pitch, as tests/test_native.py's PLC test) through both plan serve loops.

Tolerances, with their reason.  The conceal is numerically touchy: in
the reference itself, scaling the decode memory by (1 + 1e-7 noise) left
the pitch indices of make_plc_conceal as they were but moved the
concealed frame by up to 3.9e-4 of its peak and the order-24 LPC by
5.4e-3 absolute (a scratch run of the JAX plan loop at B=4 on harmonic
frames).  The port sums in other orders than XLA, which is a change of
the same size, so it is held to: equal pitch indices, out_f and memory
within 2e-3 of the row's peak, the LPC within 2e-2 absolute, Levinson
within 1e-4 of the largest coefficient (well-conditioned rows), the
continued-loss LPC passed through exactly.  The two-best tracking and the
compact conceal are exact: equal indices, and compact equal to full bit
for bit on the CPU.

The kernels (`pitch_track`, `lpc_synth`) are CUDA only; they are held to
their plain versions in the cases marked `cuda`, which skip here.  On the
CPU, a numpy model of `lpc_synth`'s chunked recurrence (the kernel's chunk
geometry and precisions) is held to a float64 run, and the plain tracking
to the reference's on ties at the kernel's lane edges.  jax and the
reference are imported inside the tests that use them, so that the
`cuda` cases run where neither is installed.
"""

import numpy as np
import pytest
import torch

from opus_tpu_torch.dsp import plc_exec as P
from opus_tpu_torch.dsp.plc_scan import (
    _lpc_synth_ref,
    _pitch_track_ref,
    lpc_synth,
    pitch_track,
)

FRAME = 960
OUT_REL_TOL = 2e-3
LPC_ABS_TOL = 2e-2
LPC_PEAK_TOL = 1e-3  # lpc_synth vs a float64 run, of each row's peak
SYNTH_ELS = [1, 23, 24, 25, 33, 300, 1080, 1081]
#: (length, n_lags): lengths not a multiple of 32; 155 and 310 the
#: coarse and fine searches' lags
PITCH_GEOMETRY = [(45, 1), (77, 31), (332, 155), (664, 310)]


def _jax():
    """(jax, jax.numpy, the reference's plc_exec), imported on use."""
    import jax
    import jax.numpy as jnp

    from opus_tpu.dsp import plc_exec

    return jax, jnp, plc_exec


def _harmonic_payloads(B, NF, seed=5):
    """Three partials on a pitch drifting around 160 Hz (stream b shifted
    by 9 b Hz), 96 kbps stereo CELT from the native encoder."""
    from opus_tpu.native.frontend import NativeCeltEncoderBatch

    rng = np.random.default_rng(seed)
    t = np.arange(FRAME * NF) / 48000.0
    enc = NativeCeltEncoderBatch(B, 2)
    sig = []
    for b in range(B):
        ph = np.cumsum(2 * np.pi * (160 + 9 * b + 8 * np.sin(2 * np.pi * 1.5 * t)) / 48000.0)
        s = (0.5 * np.sin(ph) + 0.25 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)
             + 0.01 * rng.standard_normal(t.size))
        sig.append(np.stack([s, np.roll(s, 11) * 0.9], -1))
    pcm = np.asarray(sig, np.float32)
    return [[bytes(p) for p in enc.encode_batch(pcm[:, f * FRAME : (f + 1) * FRAME], 240)]
            for f in range(NF)]


@pytest.fixture(scope="module")
def memories():
    """[8, 2, W] decode memories after 4 harmonic frames, from the JAX plan
    serve loop (the port's, served alongside, agrees within 1e-5 of the
    peak)."""
    from opus_tpu.native.frontend import available

    if not available():
        pytest.skip("native engine not built")
    from opus_tpu.batch.pipeline import BatchedCeltDecoder as JaxDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    B = 8
    ref = JaxDecoder(B, 2, use_native=True, transfer="plan")
    port = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu")
    for packets in _harmonic_payloads(B, 4):
        ref.serve([packets], FRAME)
        port.serve([packets], FRAME)
    mem = np.asarray(ref._serve_state.mem)
    assert float(np.abs(port._serve_state.mem.numpy() - mem).max()) < 1e-5 * np.abs(mem).max()
    return mem


def _ac_rows(rng, order):
    """Autocorrelations: random signals, a zero row (ac[0] == 0) and that
    of a constant 4096 samples long (its error falls below 0.001 ac[0]
    after the first order: the early stop)."""
    x = rng.standard_normal((6, 512))
    x[4] = 0.0
    ac = np.stack([np.sum(x[:, k:] * x[:, : 512 - k], axis=1) for k in range(order + 1)], 1)
    ac[5] = 4096.0 - np.arange(order + 1)
    return ac.astype(np.float32)


@pytest.mark.parametrize("order", [4, 24])
def test_levinson_matches_jax(order):
    jax, jnp, J = _jax()
    ac = _ac_rows(np.random.default_rng(order), order)
    want = np.asarray(J._levinson(jnp.asarray(ac), order))
    got = P._levinson(torch.tensor(ac), order).numpy()
    assert not np.isnan(got).any()
    assert np.all(got[4] == 0.0)  # ac[0] == 0: never starts
    # the constant stops early: its last coefficients stay zero on both sides
    assert np.array_equal(got[5] == 0.0, want[5] == 0.0) and (got[5] == 0.0).any()
    scale = np.abs(want).max(axis=1, keepdims=True) + 1e-30
    assert float((np.abs(got - want) / scale).max()) < 1e-4


def _pitch_cases():
    """(xcorr [R, L], y [R, length + L], length): random rows with negative
    correlations, and tie rows (y = 0 keeps syy at 1; repeated maxima,
    the best at lag 0 or at the last lag)."""
    rng = np.random.default_rng(3)
    length, L = 64, 40
    y = rng.standard_normal((8, length + L)).astype(np.float32) * 1e6
    xc = (rng.standard_normal((8, L)) * 1e12).astype(np.float32)
    yt = np.zeros((6, length + L), np.float32)
    xt = np.full((6, L), -5.0, np.float32)
    xt[0, [3, 9, 20]] = 7e12  # three equal maxima
    xt[1, [0, 5]] = 2e12  # best at lag 0, tied
    xt[2, [L - 1]] = 9e12  # best at the last lag
    xt[2, [0, 1]] = 9e12
    xt[3] = 4e12  # every lag ties
    xt[4] = 0.0  # nothing positive: (0, 1)
    xt[5, ::2] = 3e12
    return [(xc, y, length), (xt, yt, length)]


def test_pitch_track_ref_matches_find_best_pitch():
    jax, jnp, J = _jax()
    for xc, y, length in _pitch_cases():
        L = xc.shape[1]
        want = [np.asarray(a) for a in J._find_best_pitch(jnp.asarray(xc), jnp.asarray(y),
                                                             length, L)]
        got = [a.numpy() for a in _pitch_track_ref(torch.tensor(xc), torch.tensor(y), length, L)]
        got_w = [a.numpy() for a in pitch_track(torch.tensor(xc), torch.tensor(y), length, L)]
        for a, b, c in zip(want, got, got_w):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)


def test_pitch_search_matches_jax(memories):
    jax, jnp, J = _jax()
    B = memories.shape[0]
    want = np.asarray(jax.jit(J.make_pitch_search(B))(jnp.asarray(memories)))
    got = P.make_pitch_search(device="cpu")(torch.tensor(memories)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 100).all() and (want <= 720).all()


def _conceal_args(mem, seed=0):
    """mem, lpc, pitch, first, period, gain, tapset: rows 0-3 first losses,
    4-7 continued ones; tapsets 0-2 and a zero gain."""
    B = mem.shape[0]
    rng = np.random.default_rng(seed)
    lpc = (rng.standard_normal((B, 2, 24)) * 0.05).astype(np.float32)
    pitch = rng.integers(100, 720, B).astype(np.int32)
    first = np.arange(B) < B // 2
    period = rng.integers(15, 1024, B).astype(np.int32)
    gain = (rng.integers(1, 8, B) * 0.09375).astype(np.float32)
    gain[1] = gain[6] = 0.0
    tapset = (np.arange(B) % 3).astype(np.int32)
    return mem, lpc, pitch, first, period, gain, tapset


def _assert_close_to_jax(want, got, mask):
    mem_j, lpc_j, pitch_j, out_j = (np.asarray(a) for a in want)
    mem_t, lpc_t, pitch_t, out_t = (a.numpy() for a in got)
    np.testing.assert_array_equal(pitch_t[mask], pitch_j[mask])
    for a, b in ((mem_t, mem_j), (out_t, out_j)):
        a, b = a[mask], b[mask]
        assert not np.isnan(a).any()
        peak = np.abs(b).reshape(len(b), -1).max(axis=1)
        err = np.abs(a - b).reshape(len(b), -1).max(axis=1)
        assert (err <= OUT_REL_TOL * peak).all(), err / peak
    assert float(np.abs(lpc_t[mask] - lpc_j[mask]).max()) < LPC_ABS_TOL
    return lpc_t


def test_conceal_matches_jax(memories):
    jax, jnp, J = _jax()
    args = _conceal_args(memories)
    B = memories.shape[0]
    want = jax.jit(J.make_plc_conceal(3, B, 2))(*map(jnp.asarray, args))
    got = P.make_plc_conceal(3, B, 2, device="cpu")(*map(torch.tensor, args))
    first = args[3]
    lpc_t = _assert_close_to_jax(want, got, np.ones(B, bool))
    # continued losses keep their LPC exactly
    np.testing.assert_array_equal(lpc_t[~first], args[1][~first])


def _compact_args(mem):
    """The reference's compact case (tests/test_dsp.py): 16 streams, 5
    flagged (3 first losses, 2 continued)."""
    B = 16
    mem = np.concatenate([mem, mem[:, ::-1] * 0.5])[:B].astype(np.float32)
    rng = np.random.default_rng(0)
    lpc = (rng.standard_normal((B, 2, 24)) * 0.01).astype(np.float32)
    pitch = rng.integers(100, 720, B).astype(np.int32)
    mask = np.isin(np.arange(B), [3, 7, 8, 12, 15])
    first = mask & np.isin(np.arange(B), [3, 8, 15])
    period = rng.integers(15, 1024, B).astype(np.int32)
    gain = (rng.integers(0, 4, B) * 0.09375).astype(np.float32)
    tapset = rng.integers(0, 3, B).astype(np.int32)
    return mem, lpc, pitch, mask, first, period, gain, tapset


def test_compact_matches_full(memories):
    """Capacity 8 above the 5 losses: flagged rows bit-equal to the full
    conceal's, every other row zero, no NaN."""
    mem, lpc, pitch, mask, first, period, gain, tapset = map(torch.tensor, _compact_args(memories))
    B = mem.shape[0]
    full = P.make_plc_conceal(3, B, 2, device="cpu")(mem, lpc, pitch, first, period, gain, tapset)
    comp = P.make_plc_conceal_compact(3, B, 8, 2, device="cpu")(
        mem, lpc, pitch, mask, first, period, gain, tapset)
    m = mask.numpy()
    for a, b in zip(full, comp):
        a, b = a.numpy(), b.numpy()
        assert not np.isnan(b).any()
        np.testing.assert_array_equal(a[m], b[m])
        assert not b[~m].any()


def test_compact_matches_jax(memories):
    jax, jnp, J = _jax()
    args = _compact_args(memories)
    B = args[0].shape[0]
    want = jax.jit(J.make_plc_conceal_compact(3, B, 8, 2))(*map(jnp.asarray, args))
    got = P.make_plc_conceal_compact(3, B, 8, 2, device="cpu")(*map(torch.tensor, args))
    _assert_close_to_jax(want, got, args[3])


def test_lpc_synth_ref_matches_reference_scan(memories):
    """The plain synthesis against the recurrence of the reference's scan
    body (iir_step, plc_exec.py:293) written in numpy float64: within
    1e-6 of the peak."""
    rng = np.random.default_rng(4)
    R, el = 6, 300
    ext = rng.standard_normal((R, el)).astype(np.float32)
    lpc = (rng.standard_normal((R, 24)) * 0.05).astype(np.float32)
    hist0 = rng.standard_normal((R, 24)).astype(np.float32)
    h = hist0.astype(np.float64)
    want = np.zeros((R, el))
    for t in range(el):
        acc = ext[:, t] - np.sum(lpc * h, axis=-1)
        h = np.concatenate([acc[:, None], h[:, :-1]], axis=-1)
        want[:, t] = acc
    got = lpc_synth(*(torch.tensor(a) for a in (ext, lpc, hist0))).numpy()
    assert float(np.abs(got - want).max()) < 1e-6 * np.abs(want).max()


def _synth_rows(rows: int, el: int, seed: int):
    """lpc_synth inputs: ext ~ N(0, 1), a small random LPC and history,
    with the special rows first (as many as fit): a pole pair at radius
    0.999, a zero LPC (out must equal ext), a history of 1e3 with zero
    ext, a pole pair at radius 0.995."""
    rng = np.random.default_rng(seed)
    lpc = (rng.standard_normal((rows, 24)) * 0.03).astype(np.float32)
    ext = rng.standard_normal((rows, el)).astype(np.float32)
    hist0 = rng.standard_normal((rows, 24)).astype(np.float32)
    special = [("pole", 0.999), ("zero lpc", None), ("history", None), ("pole", 0.995)]
    for r, (kind, radius) in enumerate(special[:rows]):
        if kind == "pole":
            lpc[r] = 0.0
            lpc[r, :2] = [-2 * radius * np.cos(0.2), radius * radius]
        elif kind == "zero lpc":
            lpc[r] = 0.0
        else:
            ext[r] = 0.0
            hist0[r] *= 1e3
    return ext, lpc, hist0


def _synth_f64(ext, lpc, hist0):
    """The recurrence in float64 numpy (the yardstick)."""
    h = hist0.astype(np.float64)
    a = lpc.astype(np.float64)
    out = np.zeros(ext.shape)
    for t in range(ext.shape[1]):
        out[:, t] = ext[:, t] - np.sum(a * h, axis=1)
        h = np.concatenate([out[:, t : t + 1], h[:, :-1]], axis=1)
    return out


def _synth_chunked_model(ext, lpc, hist0):
    """numpy model of csrc/plc.cu's lpc_synth: one chunk a lane (at most
    32, none but the last below 24 samples), z in float32 from a zero
    history (chunk 0 from hist0), H (the responses to a unit history in
    each tap) by the kernel's row recursion H[0][j] = -a[j], H[t][j] =
    H[t-1][j+1] - a[j] H[t-1][0] in float64 stored as float32, then the
    carry s_{c+1} = tail24(z_c) + M s_c and the fix-up out = z + H s_c in
    float32."""
    R, el = ext.shape
    want = min(32, max(1, el // 24))
    L = -(-el // want)
    count = -(-el // L)
    assert count <= want and (count == 1 or L >= 24) and (el >= 48 or count == 1)

    def run(x, h):  # float32, from the history h (h[:, j]: the output 1 + j back)
        out = np.zeros(x.shape, np.float32)
        for t in range(x.shape[1]):
            out[:, t] = x[:, t] - np.sum(lpc * h, axis=1)
            h = np.concatenate([out[:, t : t + 1], h[:, :-1]], axis=1)
        return out

    zero = np.zeros((R, 24), np.float32)
    z = [run(ext[:, c * L : (c + 1) * L], hist0 if c == 0 else zero) for c in range(count)]
    if count == 1:
        return z[0]
    a = lpc.astype(np.float64)
    H = np.zeros((R, L, 24))
    H[:, 0] = -a
    for t in range(1, L):
        H[:, t, :23] = H[:, t - 1, 1:] - a[:, :23] * H[:, t - 1, :1]
        H[:, t, 23] = -a[:, 23] * H[:, t - 1, 0]
    H = H.astype(np.float32)
    M = H[:, ::-1][:, :24]  # M[r, j] = H[r, L - 1 - j]
    s = z[0][:, ::-1][:, :24]
    out = [z[0]]
    for c in range(1, count):
        out.append(z[c] + np.einsum("rtk,rk->rt", H[:, : z[c].shape[1]], s))
        if c + 1 < count:  # the last chunk may be shorter than 24
            s = z[c][:, ::-1][:, :24] + np.einsum("rjk,rk->rj", M, s)
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("el", SYNTH_ELS + [47, 48, 73])
def test_chunked_synthesis_model_matches_float64(el):
    """The kernel's chunked form, modelled in numpy, within 1e-3 of each
    row's peak of a float64 run, the 0.999 pole pair included; a zero LPC
    passes ext through exactly."""
    ext, lpc, hist0 = _synth_rows(8, el, el)
    want = _synth_f64(ext, lpc, hist0)
    got = _synth_chunked_model(ext, lpc, hist0)
    peak = np.abs(want).max(axis=1)
    assert (np.abs(got - want).max(axis=1) <= LPC_PEAK_TOL * peak).all()
    np.testing.assert_array_equal(got[1], ext[1])


def _edge_pitch_rows(length: int, n_lags: int, rows: int, seed: int):
    """pitch_track inputs with ties at the kernel's lane edges: rows 0-4
    have y = 0 (syy stays 1, so equal correlations tie exactly): ties at
    lags 31/32, at 63/64, at all four, every lag equal, and lags 31/32 a
    float apart; row 5's energy falls to the clamp at 1 (y zero beyond
    `length`); row 6 has its best at lag 32; the rest are random."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, length + n_lags)) * 3e4).astype(np.float32)
    xc = (rng.standard_normal((rows, n_lags)) * 1e12).astype(np.float32)
    y[:5] = 0.0
    xc[:5] = -1.0

    def put(r, lags, v):
        lags = [i for i in lags if i < n_lags]
        xc[r, lags] = v

    put(0, [31, 32], 5e12)
    put(1, [63, 64], 5e12)
    put(2, [31, 32, 63, 64], 7e12)
    xc[3] = 4e12
    put(4, [31], 6e12)
    put(4, [32], np.nextafter(np.float32(6e12), np.float32(np.inf)))
    y[5, length:] = 0.0
    xc[5] = np.abs(xc[5])
    put(6, [32], 9e13)
    return xc, y


@pytest.mark.parametrize("length,n_lags", PITCH_GEOMETRY)
def test_pitch_track_ref_lane_edge_ties_match_find_best_pitch(length, n_lags):
    """The plain tracking (the kernel's sum order) against the reference's
    _find_best_pitch on the lane-edge tie rows: equal indices."""
    jax, jnp, J = _jax()
    xc, y = _edge_pitch_rows(length, n_lags, 12, n_lags)
    want = J._find_best_pitch(jnp.asarray(xc), jnp.asarray(y), length, n_lags)
    got = _pitch_track_ref(torch.tensor(xc), torch.tensor(y), length, n_lags)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(4, 40)
    y = torch.zeros(4, 100)
    with pytest.raises(ValueError):
        pitch_track(x, y, 64, 40)  # length + n_lags > y's width
    with pytest.raises(ValueError):
        pitch_track(x.double(), y, 60, 40)
    with pytest.raises(ValueError):
        lpc_synth(torch.zeros(4, 50), torch.zeros(4, 23), torch.zeros(4, 24))
    with pytest.raises(ValueError):
        lpc_synth(torch.zeros(4, 50).t(), torch.zeros(50, 24), torch.zeros(50, 24))


# ---- the CUDA kernels, on the card ------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the PLC scan kernels have no CPU mode")
    return torch.device("cuda")


def _card_pitch_inputs(dev):
    """The tie rows and random rows of _pitch_cases at the serving widths,
    plus the coarse search's stride-2 view of y."""
    cases = []
    for xc, y, length in _pitch_cases():
        cases.append((torch.tensor(xc, device=dev), torch.tensor(y, device=dev), length))
    rng = np.random.default_rng(9)
    y = torch.tensor(rng.standard_normal((300, 1024)).astype(np.float32) * 3e5, device=dev)
    xc = torch.tensor(rng.standard_normal((300, 155)).astype(np.float32) * 1e12, device=dev)
    cases.append((xc, y[:, :974:2], 332))
    return cases


@pytest.mark.cuda
def test_pitch_track_kernel_matches_plain_on_card(cuda_device):
    for xc, y, length in _card_pitch_inputs(cuda_device):
        L = xc.shape[1]
        got = pitch_track(xc, y, length, L)
        want = _pitch_track_ref(xc, y, length, L)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_lpc_synth_kernel_matches_plain_on_card(cuda_device):
    """Random LPCs and one near instability (a pole pair at radius 0.995):
    kernel and plain f32 each within 1e-3 of the peak of a float64 run."""
    rng = np.random.default_rng(6)
    R, el = 512, 1080
    lpc = (rng.standard_normal((R, 24)) * 0.03).astype(np.float32)
    r, th = 0.995, 0.2
    lpc[0] = 0.0
    lpc[0, :2] = [-2 * r * np.cos(th), r * r]
    ext = rng.standard_normal((R, el)).astype(np.float32)
    hist0 = rng.standard_normal((R, 24)).astype(np.float32)
    t = [torch.tensor(a, device=cuda_device) for a in (ext, lpc, hist0)]
    want = _lpc_synth_ref(*(a.double() for a in t))
    got = lpc_synth(*t)
    plain = _lpc_synth_ref(*t)
    torch.cuda.synchronize()
    peak = want.abs().amax(dim=1)
    assert bool(((got.double() - want).abs().amax(dim=1) < 1e-3 * peak).all())
    assert bool(((plain.double() - want).abs().amax(dim=1) < 1e-3 * peak).all())


@pytest.mark.cuda
def test_plc_wrappers_issue_one_launch_on_card(cuda_device):
    xc, y, length = _card_pitch_inputs(cuda_device)[-1]
    ext = torch.zeros(256, 1080, device=cuda_device)
    lpc = torch.zeros(256, 24, device=cuda_device)
    pitch_track(xc, y, length, xc.shape[1])
    lpc_synth(ext, lpc, lpc)
    torch.cuda.synchronize()
    for call, sym in ((lambda: pitch_track(xc, y, length, xc.shape[1]), "pitch_track_kernel"),
                      (lambda: lpc_synth(ext, lpc, lpc), "lpc_synth_kernel")):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(e.count for e in device) == 1 and sym in device[0].key


@pytest.mark.cuda
@pytest.mark.parametrize("length,n_lags", PITCH_GEOMETRY)
def test_pitch_track_kernel_lane_edges_on_card(length, n_lags, cuda_device):
    """Ties at lane edges, the clamp and random rows (300 rows), y
    contiguous and as a stride-2 view: equal to the plain version index
    for index."""
    xc, y = (torch.tensor(a, device=cuda_device)
             for a in _edge_pitch_rows(length, n_lags, 300, n_lags))
    y2 = torch.zeros(y.shape[0], 2 * y.shape[1], device=cuda_device)
    y2[:, ::2] = y
    for yy in (y, y2[:, ::2]):
        got = pitch_track(xc, yy, length, n_lags)
        want = _pitch_track_ref(xc, yy, length, n_lags)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (yy.stride(), (a != b).nonzero()[:5])


@pytest.mark.cuda
@pytest.mark.parametrize("el", SYNTH_ELS)
def test_lpc_synth_kernel_geometry_on_card(el, cuda_device):
    """Every chunk geometry (one chunk below 48 samples, a short last
    chunk, 32 chunks) at 1, 31, 256 and 2,048 rows: kernel and plain f32
    within 1e-3 of each row's peak of a float64 run, the 0.999 pole pair
    included; a zero LPC passes ext through exactly."""
    for rows in (1, 31, 256, 2048):
        t = [torch.tensor(a, device=cuda_device) for a in _synth_rows(rows, el, rows + el)]
        want = _lpc_synth_ref(*(a.double() for a in t))
        got = lpc_synth(*t)
        plain = _lpc_synth_ref(*t)
        torch.cuda.synchronize()
        peak = want.abs().amax(dim=1)
        for name, out in (("kernel", got), ("plain", plain)):
            err = (out.double() - want).abs().amax(dim=1)
            assert bool((err <= LPC_PEAK_TOL * peak).all()), (name, rows, float((err / peak).max()))
        if rows > 1:
            assert torch.equal(got[1], t[0][1])
