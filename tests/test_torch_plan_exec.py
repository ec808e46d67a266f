"""The port's plan executor against the reference's, on the CPU.

Plane A (the port's copy of the native engine) decodes libopus CELT
payloads into plan slots; the port's executor must agree with the jitted
JAX `make_plan_executor` on the same inputs within 1e-5 (float
reassociation between XLA and torch, against an observed ~4e-7), and
with the numpy oracle `execute_plan_numpy` and the engine's own f32
spectra within 1e-3 (the reference's gate, tests/test_native.py: leaf
gains travel as f16).  One jitted JAX executor is shared by the module.
"""

import numpy as np
import pytest
import torch

from opus_tpu import oracle, parse_packet
from opus_tpu_torch.native.frontend import NativeBatchFrontEnd, alloc_plan_slots

pytestmark = pytest.mark.skipif(not oracle.available(), reason="libopus not present")

B, F = 3, 960
JAX_TOL = 1e-5
REF_TOL = 1e-3


def _encode(pcm, kbps, nframes):
    enc = oracle.Encoder(48000, 2)
    enc.ctl(oracle.SET_BITRATE, kbps * 1000)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    pk = [enc.encode_float(pcm[i * F : (i + 1) * F].ravel(), F) for i in range(nframes)]
    return [p[parse_packet(p).payload_offset :] for p in pk]


def _tonal_streams(nframes):
    """48/96/160 kbps stereo of a two-tone signal with a transient."""
    rng = np.random.default_rng(11)
    t = np.arange(F * nframes) / 48000.0
    sig = np.sin(2 * np.pi * 220 * t) * 0.4 + np.sin(2 * np.pi * 3000 * t) * 0.2
    sig[F * 2 : F * 2 + 500] += rng.standard_normal(500) * 0.8  # transient
    sig[: F // 2] = 0
    pcm = np.stack([sig, np.roll(sig, 13)], -1).astype(np.float32)
    return [_encode(pcm, kbps, nframes) for kbps in (48, 96, 160)]


def _decorrelated_streams(nframes):
    """Decorrelated stereo at 32/48/64 kbps: dual stereo and intensity."""
    rng = np.random.default_rng(13)
    t = np.arange(F * nframes) / 48000.0
    L = 0.4 * np.sin(2 * np.pi * 317 * t) + 0.2 * rng.standard_normal(t.size)
    R = 0.4 * np.sin(2 * np.pi * 523 * t) + 0.2 * rng.standard_normal(t.size)
    pcm = np.stack([L, R], -1).astype(np.float32)
    return [_encode(pcm, kbps, nframes) for kbps in (32, 48, 64)]


def _args(slot):
    from opus_tpu.dsp.plan_exec import plan_executor_args

    return plan_executor_args(slot)


@pytest.fixture(scope="module")
def jax_executor():
    import jax

    from opus_tpu.dsp.plan_exec import make_plan_executor

    return jax.jit(make_plan_executor(3, B))


@pytest.fixture(scope="module")
def port_executor():
    from opus_tpu_torch.dsp.plan_exec import make_plan_executor

    return make_plan_executor(3, B, device="cpu")


def _run_port(ex, slot):
    return ex(*[torch.as_tensor(np.ascontiguousarray(a)) for a in _args(slot)]).numpy()


def _check_frame(slot, got, jax_executor):
    import jax.numpy as jnp

    from opus_tpu.dsp.plan_exec import execute_plan_numpy

    want = np.asarray(jax_executor(*map(jnp.asarray, _args(slot))))
    assert got.shape == want.shape == (B, 2, F)
    assert float(np.abs(got - want).max()) < JAX_TOL
    xn = execute_plan_numpy(slot, 3)
    for b in range(B):
        c_ = int(slot["meta"][b, 3])
        assert float(np.abs(got[b, :c_] - xn[b, :c_]).max()) < REF_TOL
        ref = slot["xdbg"][b, : c_ * F].reshape(c_, F)
        assert float(np.abs(got[b, :c_] - ref).max()) < REF_TOL


def test_executor_matches_jax_and_oracle(jax_executor, port_executor):
    """PVQ leaves, spreading rotation, folds, transients (haar/interleave
    undo and anti-collapse) and stereo merge at three rates, with a loss
    run on stream 1: its first loss is pitch-regime (an empty plan), the
    next one, after a good frame, noise-regime (noise leaves)."""
    NF = 7
    streams = _tonal_streams(NF)
    fe = NativeBatchFrontEnd(B, 2)
    slot = alloc_plan_slots(B, 1)[0]
    saw_noise = 0
    for fr in range(NF):
        pkts = [streams[b][fr] for b in range(B)]
        if fr in (3, 5):
            pkts[1] = None
        fe.decode_batch_plan_into(pkts, F, slot, want_xdbg=True)
        counts = slot["header"][:, 1]
        fills = [slot["arena"][int(slot["header"][b, 0]) + int(counts[b] & 0x1FF):][
            : 3 * int((counts[b] >> 9) & 0x1FF)] for b in range(B)]
        saw_noise += sum(int((((f[0::3].astype(np.int64) >> 20) & 1)).sum()) for f in fills)
        _check_frame(slot, _run_port(port_executor, slot), jax_executor)
    assert saw_noise > 0  # the content must actually drive the noise leaves


def test_executor_dual_stereo_and_intensity(jax_executor, port_executor):
    NF = 5
    streams = _decorrelated_streams(NF)
    fe = NativeBatchFrontEnd(B, 2)
    slot = alloc_plan_slots(B, 1)[0]
    saw_dual = saw_isw = 0
    for fr in range(NF):
        fe.decode_batch_plan_into([streams[b][fr] for b in range(B)], F, slot,
                                  want_xdbg=True)
        w0 = slot["bands"][:, :, 0].astype(np.uint32)
        saw_dual += int(((w0 >> 5) & 1).sum())
        saw_isw += int(((w0 >> 6) & 1).sum())
        _check_frame(slot, _run_port(port_executor, slot), jax_executor)
    assert saw_dual > 0 and saw_isw > 0


def test_size_classes_match_full_capacity():
    """A class executor is a pure narrowing of the leaf-table and pulse
    windows: when a step's maxima fit the class, its output equals the
    full-capacity executor's bit for bit."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.plan_exec import make_plan_executor

    NF = 4
    streams = _tonal_streams(NF)
    fe = NativeBatchFrontEnd(B, 2)
    slot = alloc_plan_slots(B, 1)[0]
    full = make_plan_executor(3, B, device="cpu")
    by_cls = {cls: make_plan_executor(3, B, p_max=cls[0], f_max=cls[1], iyw=cls[2],
                                      device="cpu")
              for cls in BatchedCeltDecoder.PLAN_CLASSES[:-1]}
    picker = BatchedCeltDecoder.__new__(BatchedCeltDecoder)
    fitted = 0
    for fr in range(NF):
        fe.decode_batch_plan_into([streams[1][fr]] * B, F, slot)
        want = _run_port(full, slot)
        c = slot["header"][:, 1]
        for cls, ex in by_cls.items():
            if (int((c & 0x1FF).max()) <= cls[0] and int(((c >> 9) & 0x1FF).max()) <= cls[1]
                    and int(slot["iy_spans"].max()) + 1 <= cls[2]):
                assert np.array_equal(_run_port(ex, slot), want), cls
                fitted += 1
        assert picker._plan_size_class(slot) in BatchedCeltDecoder.PLAN_CLASSES
    assert fitted > 0  # 96 kbps stereo must fit a sub-capacity class


def test_f16_decode_on_every_code():
    """Every f16 code decodes to its exact IEEE value; exponent 31 to the
    reference's finite (1 + m/1024) * 2^16.  Against the reference's
    `_f16_to_f32_j`: equal, except where XLA:CPU's exp2 misses the exact
    power of two (exponents 2, 28 and 30 there), by under 1e-6 relative."""
    import jax.numpy as jnp

    from opus_tpu.dsp.plan_exec import _f16_to_f32_j
    from opus_tpu_torch.dsp.plan_exec import _f16_to_f32

    h = np.arange(65536, dtype=np.int64)
    got = _f16_to_f32(torch.tensor(h)).numpy()
    e = (h >> 10) & 0x1F
    want = h.astype(np.uint16).view(np.float16).astype(np.float32)
    big = ((1.0 + (h & 0x3FF) / 1024.0) * 65536.0 * np.where(h >> 15, -1, 1)).astype(np.float32)
    want = np.where(e == 31, big, want)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    ref = np.asarray(_f16_to_f32_j(jnp.asarray(h.astype(np.uint32))))
    same = got.view(np.uint32) == ref.view(np.uint32)
    assert np.isin(e[~same], [2, 28, 30]).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_lcg_jump_table_matches_double_and_add():
    """Every (A_t, C_t) of the port's table equals the reference's
    double-and-add jump, and replays t single LCG steps."""
    import jax.numpy as jnp

    from opus_tpu.dsp.plan_exec import _lcg_jump_j, lcg
    from opus_tpu_torch.dsp.plan_tables import _LCG_MAX, _lcg_jump_table

    tbl = _lcg_jump_table()
    A, C = (np.asarray(a).astype(np.int64) for a in _lcg_jump_j(jnp.arange(_LCG_MAX)))
    assert np.array_equal(tbl[0], A) and np.array_equal(tbl[1], C)
    seed = 0x9E3779B9
    s = seed
    for t in range(40):
        assert (int(tbl[0, t]) * seed + int(tbl[1, t])) & 0xFFFFFFFF == s
        s = lcg(s)


def _mixed_streams(nframes):
    """Hybrid SWB at 32 and 64 kbps (start band 17; 32 kbps folds heavily
    in the high bands: the e[17]-relative fold offsets and the band-18
    fold duplication, reference bands.py:605) and narrowband CELT at 48
    kbps (end band 13), as whole Opus packets."""
    rng = np.random.default_rng(17)
    t = np.arange(F * nframes) / 48000.0
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = 0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)
    music = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1763 * t)
    out = []
    for sig, mode, kbps, bw in ((voice, oracle.MODE_HYBRID, 32, None),
                                (voice, oracle.MODE_HYBRID, 64, None),
                                (music, oracle.MODE_CELT_ONLY, 48, 1101)):
        pcm = np.stack([sig, 0.7 * np.roll(sig, 13)], -1).astype(np.float32)
        enc = oracle.Encoder(48000, 2)
        enc.ctl(oracle.SET_FORCE_MODE, mode)
        enc.ctl(oracle.SET_BITRATE, kbps * 1000)
        if bw:
            enc.ctl(oracle.SET_MAX_BANDWIDTH, bw)
        out.append([enc.encode_float(pcm[i * F : (i + 1) * F].ravel(), F) for i in range(nframes)])
    return out


def test_executor_hybrid_and_narrowband_plans(jax_executor, port_executor):
    """Plans of the mixed decode (native/frontend.py NativeOpusFrontEnd,
    a mixed slot with the smap word) for hybrid streams (start band 17)
    and narrowband CELT (end band 13), with a loss on each hybrid stream: the
    port's executor equals the JAX executor within 1e-5 and the numpy
    oracle within 1e-3."""
    from opus_tpu.dsp.plan_exec import execute_plan_numpy
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    import jax.numpy as jnp

    NF = 6
    streams = _mixed_streams(NF)
    dec = BatchedOpusDecoder(B, 2, transfer="plan", device="cpu")
    slot = dec._alloc_plan_slots(F, 1)[0][0]
    starts, ends = set(), set()
    for fr in range(NF):
        pkts = [streams[b][fr] for b in range(B)]
        if fr in (2, 4):
            pkts[fr // 2 - 1] = None
        dec._plane_a_plan(pkts, slot)
        starts |= set(slot["meta"][:, 4].tolist())
        ends |= set(slot["meta"][:, 5].tolist())
        got = _run_port(port_executor, slot)
        want = np.asarray(jax_executor(*map(jnp.asarray, _args(slot))))
        assert float(np.abs(got - want).max()) < JAX_TOL
        xn = execute_plan_numpy(slot, 3)
        for b in range(B):
            c_ = int(slot["meta"][b, 3])
            assert float(np.abs(got[b, :c_] - xn[b, :c_]).max()) < REF_TOL
    assert 17 in starts and 0 in starts and 13 in ends
