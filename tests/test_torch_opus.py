"""The port's mixed-mode serving decode (BatchedOpusDecoder) against the
JAX package and the scalar decoder, on the CPU.

Traffic: B=6 stereo 48 kHz streams, one in three of each kind (CELT 96
kbps stereo, SILK WB 24 kbps mono, hybrid SWB 64 kbps stereo), 20 ms
frames from libopus, with losses on every kind: SILK and hybrid losses
are concealed in plane A (shared by both packages, so exact), a CELT
stream's first losses on the device.  Both packages run the same native
plane A, so final ranges must be equal; PCM differs by float
reassociation between XLA and torch (gate 1e-5 in +-1) and, from a CELT
stream's first device-concealed loss on, by the conceal's sensitivity
(gate 1e-3, as tests/test_torch_serve.py).  One JAX decoder per transfer
runs the traffic once (module fixture); the step tests reuse its
compiled steps.

The `cuda` case serves traffic from the port's own native encoders on the
card; jax, libopus and the reference are imported inside the CPU tests,
so that it runs where none of them is installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

F, B, NF = 960, 6, 8
KINDS = ["celt", "silk", "hybrid"] * 2
PCM_TOL = 1e-5
PLC_PCM_TOL = 1e-3
#: Losses on every kind: CELT streams 0 and 3 (first losses, the second a
#: two-frame run: device conceal), SILK 1 and 4, hybrid 2 and 5.
LOST = {(3, 0), (5, 3), (6, 3), (2, 1), (3, 1), (5, 4), (4, 2), (6, 5)}
CASES = [("plan", "internal"), ("plan", "pcm48"), ("p10", "internal"), ("p10", "pcm48")]


def _signals(nf: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    t = np.arange(F * nf) / 48000.0
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    music = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1763 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    v2 = np.stack([voice, np.roll(voice, 13) * 0.7], -1).astype(np.float32)
    m2 = np.stack([music, np.roll(music, 7) * 0.8], -1).astype(np.float32)
    return voice, v2, m2


def _libopus():
    from opus_tpu import oracle

    if not oracle.available():
        pytest.skip("libopus not present")
    return oracle


def _encoder(kind: str, fec: bool = False):
    oracle = _libopus()
    ch, mode, kbps = {"celt": (2, oracle.MODE_CELT_ONLY, 96),
                      "silk": (1, oracle.MODE_SILK_ONLY, 24),
                      "silk2": (2, oracle.MODE_SILK_ONLY, 40),
                      "hybrid": (2, oracle.MODE_HYBRID, 64)}[kind]
    e = oracle.Encoder(48000, ch)
    e.ctl(oracle.SET_FORCE_MODE, mode)
    e.ctl(oracle.SET_BITRATE, kbps * 1000)
    if mode == oracle.MODE_SILK_ONLY:
        e.ctl(oracle.SET_MAX_BANDWIDTH, 1103)
    if fec:
        e.ctl(oracle.SET_INBAND_FEC, 1)
        e.ctl(oracle.SET_PACKET_LOSS_PERC, 20)
    return e


def _encode(kinds, nf: int, fec: bool = False) -> dict:
    voice, v2, m2 = _signals(nf)
    out = {}
    for k in kinds:
        e = _encoder(k, fec)
        src = {"celt": m2, "silk": voice}.get(k, v2)
        out[k] = [e.encode_float(np.ascontiguousarray(src[f * F : (f + 1) * F]).ravel(), F)
                  for f in range(nf)]
    return out


@pytest.fixture(scope="module")
def packets() -> dict:
    return _encode(("celt", "silk", "hybrid"), NF)


def _steps(packets: dict, lost=LOST) -> list:
    return [[None if (f, b) in lost else packets[KINDS[b]][f] for b in range(B)]
            for f in range(NF)]


def _first_device_loss(lost=LOST) -> dict:
    """Each stream's first device-concealed frame (CELT streams only)."""
    return {b: min([f for f, bb in lost if bb == b and KINDS[b] == "celt"], default=NF)
            for b in range(B)}


@pytest.fixture(scope="module")
def jax_serve(packets):
    """(transfer, silk_transfer) -> the JAX serve loop's run of the
    traffic, one step per call: its decoder, per-step rings, final ranges
    and carried pitch."""
    runs = {}

    def run(transfer: str, silk: str) -> dict:
        if (transfer, silk) not in runs:
            from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder

            dec = BatchedOpusDecoder(B, 2, transfer=transfer, silk_transfer=silk)
            rings = []
            for row in _steps(packets):
                dec.serve([row])
                rings.append(np.asarray(dec._serve_ring).copy())
            runs[transfer, silk] = dict(dec=dec, rings=rings, ranges=dec.final_ranges(),
                                        pitch=np.asarray(dec._serve_plc_pitch))
        return runs[transfer, silk]

    return run


def _port(transfer: str, silk: str = "pcm48"):
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    return BatchedOpusDecoder(B, 2, transfer=transfer, silk_transfer=silk, device="cpu")


def _check_ring(got, want, f: int, first: dict) -> None:
    assert got.shape == want.shape == (B, F, 2)
    assert np.isfinite(got).all()
    for b in range(B):
        err = float(np.abs(got[b] - want[b]).max())
        assert err < (PCM_TOL if f < first[b] else PLC_PCM_TOL), (f, b, KINDS[b], err)


@pytest.mark.parametrize("transfer,silk", CASES)
def test_serve_matches_jax(transfer, silk, packets, jax_serve):
    """serve() one step per call for five steps, then three steps in one
    call over two slots (slot reuse), against the JAX loop: equal final
    ranges and carried pitch, PCM within 1e-5 (1e-3 from a CELT stream's
    first device-concealed loss)."""
    ref = jax_serve(transfer, silk)
    port = _port(transfer, silk)
    steps = _steps(packets)
    first = _first_device_loss()
    for calls in ([0], [1], [2], [3], [4], [5, 6, 7]):
        digest = port.serve([steps[f] for f in calls], n_slots=2)
        got = port._serve_ring.numpy()
        _check_ring(got, ref["rings"][calls[-1]], calls[-1], first)
        assert np.array_equal(digest, [got[0, 0, 0], got[-1, -1, -1]])
    assert port.final_ranges() == ref["ranges"]
    assert port.plan_fallbacks == 0
    np.testing.assert_array_equal(port._serve_plc_pitch.numpy(), ref["pitch"])


def _jax_plc_state():
    import jax.numpy as jnp

    from opus_tpu.dsp.synthesis import init_state

    return (init_state(B, 2, silk_hist=True), jnp.zeros((B, F, 2), jnp.float32),
            jnp.zeros((B, 2, 24), jnp.float32), jnp.full((B,), 15, jnp.int32))


@pytest.mark.parametrize("transfer", ["plan", "p10"])
def test_steps_match_jax_on_recorded_slots(transfer, packets, jax_serve):
    """The mixed serving steps themselves (internal SILK transfer), on
    slots recorded step by step from both packages' plane A: the JAX step
    (compiled by the fixture's run) and the port's step from one state.
    At step 3 the port's state is replaced by the JAX state through
    state.py (silk_hist included).  The packed path runs with a compact
    capacity of 2 on both sides, so its lossy steps take the compact
    concealing variant.  Every step: PCM as test_serve_matches_jax, the
    resampler history exactly, the decode memory of streams not yet
    device-concealed within 1e-5 of its scale."""
    import jax.numpy as jnp

    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder as JaxDecoder
    from opus_tpu.dsp.synthesis import pf_chunk_for
    from opus_tpu.native.frontend import alloc_plan_slots, pack_plan_silk as ref_pack
    from opus_tpu_torch.dsp.synthesis import init_state
    from opus_tpu_torch.native.frontend import pack_plan_silk
    from opus_tpu_torch.state import synth_state_from_numpy, synth_state_to_numpy

    ref = JaxDecoder(B, 2, transfer=transfer, silk_transfer="internal")
    ref._steps = jax_serve(transfer, "internal")["dec"]._steps  # compiled already
    port = _port(transfer, "internal")
    if transfer == "p10":
        ref.PLC_COMPACT_K = port.PLC_COMPACT_K = 2
    jstate, jring, jlpc, jpitch = _jax_plc_state()
    state = init_state(B, 2, device="cpu", silk_hist=True)
    ring = torch.zeros(B, F, 2)
    plc = port._serve_plc_state(2)
    first = _first_device_loss()
    sw = port._silk_shape(F)[1]
    jslot = (alloc_plan_slots(B, 1, 512, silk_words=sw)[0] if transfer == "plan"
             else ref._alloc_mixed_slots(F, 1)[0])
    jslot["frame48"] = F
    if transfer == "plan":
        pslots, pbuf = port._alloc_plan_slots(F, 1)
    else:
        pslots, pbuf = port._alloc_packed_slots(F, 1)
    pslot = pslots[0]
    variants = []
    for f, row in enumerate(_steps(packets)):
        if f == 3:
            mem, pre, hist = (np.asarray(a) for a in jstate)
            state = synth_state_from_numpy(mem, pre, "cpu", silk_hist=hist)
        meta = jslot["meta"]
        if transfer == "plan":
            ref._plane_a_plan(row, jslot)
            jslot.pop("corrs")
            port._plane_a_plan(row, pslot)
            lm = 3
            chunk, active = pf_chunk_for(meta[:, 6:9], jslot["gains"])
            n_lost = int((meta[:, 14] & 1).sum())
            used = jslot["used_words"] - jslot["fixed_words"]
            bucket = next(bw for bw in ref.PLAN_BUCKETS if bw >= -(-used // B))
            rb = next(r for r in ref._silk_row_buckets() if r >= len(jslot["silk_rows"]))
            jstep = ref._mixed_plan_serving_step(lm, chunk, active, bucket, rb,
                                                 with_plc=n_lost > 0,
                                                 size_class=ref._plan_size_class(jslot))
            jbuf = jnp.asarray(jslot["buf"][: ref_pack(jslot, bucket, rb)])
            _, chunk2, active2, with_plc = port._step_picks(pslot)
            silk_at, words = pack_plan_silk(pslot)
            step = port._mixed_plan_serving_step(lm, chunk2, active2,
                                                 port._plan_size_class(pslot), with_plc)
            kw = dict(silk_at=silk_at)
            buf = torch.as_tensor(pslot["buf"][:words].copy())
        else:
            ref._plane_a_packed(row, jslot)
            port._plane_a_packed(row, pslot)
            chunk, active = pf_chunk_for(meta[:, 6:9], jslot["gains"])
            n_lost = int((meta[:, 14] & 1).sum())
            has = ref.PLC_COMPACT_K if 0 < n_lost <= ref.PLC_COMPACT_K < B else n_lost > 0
            jstep = ref._mixed_serving_step(3, chunk, active, with_plc=has)
            jbuf = jnp.asarray(jslot["buf"])
            lm, chunk2, active2, with_plc = port._step_picks(pslot)
            step = port._mixed_serving_step(lm, chunk2, active2, with_plc)
            kw = {}
            buf = torch.as_tensor(pslot["buf"].copy())
        assert (chunk2, active2) == (chunk, active)
        variants.append(with_plc)
        if with_plc:
            jstate, jring, _, jlpc, jpitch = jstep(jstate, jring, jbuf, jlpc, jpitch)
            step(state, ring, buf, *plc, **kw)
        else:
            jstate, jring, _ = jstep(jstate, jring, jbuf)
            step(state, ring, buf, **kw)
        _check_ring(ring.numpy(), np.asarray(jring), f, first)
        mem, pre, hist = synth_state_to_numpy(state)
        assert np.array_equal(hist, np.asarray(jstate.silk_hist)), f
        clean = [b for b in range(B) if f < first[b]]
        want = np.asarray(jstate.mem)[clean]
        assert float(np.abs(mem[clean] - want).max()) < 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_array_equal(plc[1].numpy(), np.asarray(jpitch))
    assert any(v is not False for v in variants)
    if transfer == "p10":
        assert 2 in variants


@pytest.mark.parametrize("frame48", [960, 480])
def test_resample_banks_bit_identical(frame48):
    from opus_tpu.dsp.resample import resample_matrices as ref
    from opus_tpu_torch.dsp.resample import resample_matrices

    (m, o), (mr, orr) = resample_matrices(frame48), ref(frame48)
    assert m.dtype == mr.dtype and np.array_equal(m, mr) and np.array_equal(o, orr)


@pytest.mark.parametrize("lm", [3, 2])
def test_silk_resample_matches_jax(lm):
    """_silk_resample against the JAX one on every descriptor case: each
    rate with one and two internal rows, with and without reset, and
    streams without SILK (desc 0).  PCM within 1e-5 of full scale; the new
    history exactly."""
    import jax.numpy as jnp

    from opus_tpu.dsp.synthesis import _silk_resample as jax_resample
    from opus_tpu_torch.dsp.resample import TAIL
    from opus_tpu_torch.dsp.synthesis import _silk_resample

    descs = [khz | (rows - 1) << 5 | reset << 6 for khz in (8, 12, 16) for rows in (1, 2)
             for reset in (0, 1)] + [0, 0, 16, 8]
    desc = np.array(descs, np.int32)
    n = len(desc)
    lmax = (120 << lm) // 3
    rng = np.random.default_rng(lm)
    y16 = rng.integers(-20000, 20000, (n, 2 * lmax)).astype(np.float32)
    hist = rng.integers(-20000, 20000, (n, 2, TAIL)).astype(np.float32)
    want, want_h = jax_resample(jnp.asarray(y16), jnp.asarray(desc), jnp.asarray(hist), lm, 2)
    got, got_h = _silk_resample(torch.tensor(y16), torch.tensor(desc), torch.tensor(hist), lm,
                                2)
    assert got.shape == want.shape == (n, 120 << lm, 2)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-5 * 32768
    assert np.array_equal(got_h.numpy(), np.asarray(want_h))
    assert np.abs(np.asarray(want)).max() > 1000  # the banks did act


def test_apply_corrections_matches_jax():
    """Head (kind 0) and tail (kind 1) crossfades on the ring: equal to
    the JAX fade bit for bit."""
    import jax.numpy as jnp

    from opus_tpu.dsp.transitions import apply_corrections as jax_apply
    from opus_tpu_torch.dsp.transitions import apply_corrections

    rng = np.random.default_rng(1)
    ring = rng.standard_normal((5, F, 2)).astype(np.float32)
    corrs = [(i, kind, rng.standard_normal((240, 2)).astype(np.float32))
             for i, kind in ((0, 0), (2, 1), (3, 0), (4, 1))]
    want = np.asarray(jax_apply(jnp.asarray(ring), corrs, F, 5, 2))
    got = apply_corrections(torch.tensor(ring), corrs, F).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[1], ring[1]) and not np.array_equal(got[0], ring[0])


def test_packet_layer_matches_reference(packets):
    """The port's ToC layer on real packets, every ToC byte, and fuzzed
    packets (every framing code, padding, VBR sizes): the same answers or
    the same refusal."""
    from opus_tpu import packet as ref
    from opus_tpu_torch import packet as port

    def same(pkt):
        try:
            want = ref.parse_packet(pkt)
        except Exception:  # noqa: BLE001  (the reference's refusal)
            with pytest.raises(port.InvalidPacket):
                port.parse_packet(pkt)
            return
        got = port.parse_packet(pkt)
        assert (got.frame_sizes, got.frame_offsets, got.payload_offset, got.packet_offset) == (
            want.frame_sizes, want.frame_offsets, want.payload_offset, want.packet_offset)
        assert port.query_packet_samples_per_frame(pkt, 48000) == \
            ref.query_packet_samples_per_frame(pkt, 48000)
        assert port.query_packet_codec_mode(pkt).name == ref.query_packet_codec_mode(pkt).name
        assert int(port.query_packet_bandwidth(pkt)) == int(ref.query_packet_bandwidth(pkt))

    for pk in packets.values():
        for p in pk:
            same(p)
    for toc in range(256):
        same(bytes([toc]) + bytes(8))
    rng = np.random.default_rng(9)
    for _ in range(3000):
        n = int(rng.integers(1, 40))
        pkt = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        if n > 1 and rng.random() < 0.5:
            pkt[1] = int(rng.integers(1, 8)) | int(rng.integers(0, 4)) << 6
        same(bytes(pkt))


def test_state_carries_silk_hist():
    """A JAX SynthState with a SILK history -> the port's state -> numpy:
    every leaf equal, in the reference's leaf order."""
    import jax
    import jax.numpy as jnp

    from opus_tpu.dsp.synthesis import SynthState
    from opus_tpu_torch.state import synth_state_from_numpy, synth_state_to_numpy

    rng = np.random.default_rng(2)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 2, 1200), (3, 2), (3, 2, 48))]
    jstate = SynthState(*(jnp.asarray(a) for a in leaves))
    mem, pre, hist = (np.asarray(a) for a in jax.tree_util.tree_leaves(jstate))
    state = synth_state_from_numpy(mem, pre, "cpu", silk_hist=hist)
    back = synth_state_to_numpy(state)
    assert len(back) == 3 and all(np.array_equal(a, b) for a, b in zip(back, leaves))
    assert len(synth_state_to_numpy(synth_state_from_numpy(*leaves[:2], device="cpu"))) == 2


def test_compacted_silk_rows_round_trip(packets):
    """A mixed plan slot's SILK staging -> compacted rows after the used
    arena -> the device expansion: every stream's PCM comes back exactly
    (CELT-only rows as zeros), for both SILK transfers."""
    from opus_tpu_torch.dsp.synthesis import expand_silk_rows
    from opus_tpu_torch.native.frontend import pack_plan_silk

    for silk in ("internal", "pcm48"):
        port = _port("plan", silk)
        slots, _ = port._alloc_plan_slots(F, 1)
        slot = slots[0]
        samps, sw = port._silk_shape(F)
        for row in _steps(packets)[:3]:
            port._plane_a_plan(row, slot)
            at, words = pack_plan_silk(slot)
            assert at == max(slot["used_words"], slot["fixed_words"] + 1)
            assert words == at + len(slot["silk_rows"]) * sw
            assert len(slot["silk_rows"]) == 4  # the SILK and hybrid streams
            buf = torch.as_tensor(slot["buf"][:words].copy())
            smap = buf[slot["fixed_words"] - B : slot["fixed_words"]]
            got = expand_silk_rows(buf, at, words, smap, sw, samps).numpy()
            assert np.array_equal(got, slot["silk"][:, :samps].astype(np.float32))
            assert not got[0].any() and got[1].any()


def test_serve_matches_scalar_decoder(packets):
    """The port of tests/test_mixed_plan.py:90: the plan serve loop
    against the scalar opus_tpu.Decoder per stream, SILK and hybrid
    losses (plane A's concealment is the scalar one), every frame within
    1e-3."""
    from opus_tpu import Decoder

    lost = {(2, 1), (3, 1), (5, 4), (6, 2)}
    steps = _steps(packets, lost)
    refs = []
    for b in range(B):
        d = Decoder()
        refs.append([np.asarray(d.decode_float(steps[f][b], F)).reshape(F, 2)
                     for f in range(NF)])
    port = _port("plan")
    for f in range(NF):
        port.serve([steps[f]])
        got = port._serve_ring.numpy()
        for b in range(B):
            err = float(np.abs(got[b] - refs[b][f]).max())
            assert err < 1e-3, (f, b, KINDS[b], err)


def test_serve_fec_recovery():
    """The port of tests/test_mixed_plan.py:269: ("fec", next_packet)
    recovers a lost frame from the next packet's SILK LBRR, sample-exact
    against the scalar decoder's decode_fec for SILK streams (1e-4);
    hybrid recovers the SILK layer with the CELT band concealed as noise
    on both sides (0.1)."""
    from opus_tpu import Decoder

    nf, lost = 10, 4
    kinds = ["silk", "silk2", "hybrid"]
    pks = _encode(kinds, nf, fec=True)
    refs = {k: [] for k in kinds}
    for k in kinds:
        d = Decoder()
        for f in range(nf):
            fec = f == lost
            refs[k].append(np.asarray(d.decode_float(pks[k][f + fec], F, decode_fec=fec))
                           .reshape(F, 2))
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    port = BatchedOpusDecoder(3, 2, transfer="plan", device="cpu")
    for f in range(nf):
        port.serve([[("fec", pks[k][f + 1]) if f == lost else pks[k][f] for k in kinds]])
        got = port._serve_ring.numpy()
        for b, k in enumerate(kinds):
            err = float(np.abs(got[b] - refs[k][f]).max())
            tol = 0.1 if (k == "hybrid" and f == lost) else (2e-3 if k == "hybrid" else 1e-4)
            assert err < tol, (k, f, err)


def test_plan_overflow_falls_back_per_step(packets):
    """The port of tests/test_mixed_plan.py:145: a step whose plan
    overflows is decoded again on the packed path for just that step;
    every step first tries the plan, and every frame stays within the
    reference's 2e-3 of the run without the overflow."""
    steps = _steps(packets, set())
    ref = _port("plan", "internal")
    want = []
    for row in steps:
        ref.serve([row])
        want.append(ref._serve_ring.numpy().copy())
    port = _port("plan", "internal")
    orig = port._plane_a_plan
    calls = {"n": 0}

    def patched(packets, slot):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OverflowError("synthetic plan overflow")
        return orig(packets, slot)

    port._plane_a_plan = patched
    for f, row in enumerate(steps):
        port.serve([row])
        assert float(np.abs(port._serve_ring.numpy() - want[f]).max()) < 2e-3, f
    assert calls["n"] == NF and port.plan_fallbacks == 1
    assert port.final_ranges() == ref.final_ranges()


def test_redundancy_frame_raises():
    """A SILK bandwidth switch (NB -> WB) ships redundant CELT blocks
    beside a CELT music stream: the step no longer raises; the shadow
    decode crossfades them, so through the switch the voice stream is
    within the reference's 1e-6 of the scalar decoder and the music stream
    within the reference's 2e-3 of transfer precision
    (tests/test_mixed_plan.py:264; p10 quantises its spectra), on both
    transfers."""
    from opus_tpu import Decoder
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    oracle = _libopus()
    voice = _signals(8)[0]
    enc = oracle.Encoder(48000, 1)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
    enc.ctl(oracle.SET_BITRATE, 24000)
    voice_pk = []
    for f in range(8):
        enc.ctl(oracle.SET_MAX_BANDWIDTH, 1101 if f < 4 else 1103)
        voice_pk.append(enc.encode_float(voice[f * F : (f + 1) * F], F))
    music = _encode(("celt",), 8)["celt"]
    refs = []
    for pk in (music, voice_pk):
        d = Decoder()
        refs.append([np.asarray(d.decode_float(p, F)).reshape(F, 2) for p in pk])
    for transfer in ("plan", "p10"):
        port = BatchedOpusDecoder(2, 2, transfer=transfer, device="cpu")
        for f in range(8):
            port.serve([[music[f], voice_pk[f]]])
            got = port._serve_ring.numpy()
            assert float(np.abs(got[0] - refs[0][f]).max()) < 2e-3, (transfer, f)
            assert float(np.abs(got[1] - refs[1][f]).max()) < 1e-6, (transfer, f)
        assert port._shadow_warm[1] and not port._shadow_warm[0]


def test_decode_frames_matches_jax(packets):
    """decode_frames (48 kHz SILK, f32 spectra, one functional step per
    call with its short/long variants) against the JAX decode_frames:
    equal final ranges, PCM within 1e-5 (plane A conceals every loss
    here, CELT ones in the noise regime)."""
    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder as JaxDecoder

    ref = JaxDecoder(B, 2)
    port = _port("p10")
    for row in _steps(packets):
        want = np.asarray(ref.decode_frames(row))
        got = port.decode_frames(row)
        assert got.shape == want.shape == (B, F, 2)
        assert float(np.abs(got - want).max()) < PCM_TOL
    assert port.final_ranges() == ref.final_ranges()
    with pytest.raises(ValueError, match="pcm48"):
        _port("p10", "internal").decode_frames(_steps(packets)[0])


def _native_steps(nf: int, lost=LOST) -> list:
    """The traffic's shape from the port's own native encoders (as
    chip_smoke.py makes it): CELT 96 kbps stereo, SILK WB 60 B mono,
    hybrid SWB 160 B mono, whole Opus packets, with the LOST losses."""
    from opus_tpu_torch.native.frontend import (
        NativeCeltEncoderBatch, NativeHybridEncoderBatch, NativeSilkEncoderBatch)

    voice, v2, m2 = _signals(nf)
    celt, silk, hyb = (NativeCeltEncoderBatch(2, 2), NativeSilkEncoderBatch(2, 16),
                       NativeHybridEncoderBatch(2))
    steps = []
    for f in range(nf):
        fr = slice(f * F, (f + 1) * F)
        c = celt.encode_batch(np.stack([m2[fr], np.roll(m2[fr], 5, axis=0)]), 240)
        v = np.stack([voice[fr], 0.8 * np.roll(voice[fr], 9)])
        sp, sl = silk.encode_batch(np.round(v[:, ::3] * 32767).astype(np.int16), 60)
        hp, hl = hyb.encode_batch(v, 160)
        by_kind = {"celt": [bytes([31 << 3 | 4]) + bytes(c[j]) for j in range(2)],
                   "silk": [bytes([9 << 3]) + bytes(sp[j, : sl[j]]) for j in range(2)],
                   "hybrid": [bytes([13 << 3]) + bytes(hp[j, : hl[j]]) for j in range(2)]}
        steps.append([None if (f, b) in lost else by_kind[KINDS[b]][b // 3] for b in range(B)])
    return steps


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transfer", ["plan", "p10"])
def test_mixed_serve_on_card_matches_cpu(transfer, cuda_device):
    """Mixed traffic with losses on every kind served on the card
    (internal SILK transfer) against the port's CPU run: equal final
    ranges and carried pitch, PCM within 1e-4 (1e-3 from a CELT stream's
    first device-concealed loss)."""
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    first = _first_device_loss()
    cpu = _port(transfer, "internal")
    gpu = BatchedOpusDecoder(B, 2, transfer=transfer, silk_transfer="internal",
                             device=cuda_device)
    for f, row in enumerate(_native_steps(NF)):
        cpu.serve([row])
        gpu.serve([row])
        got, want = gpu._serve_ring.cpu().numpy(), cpu._serve_ring.numpy()
        for b in range(B):
            err = float(np.abs(got[b] - want[b]).max())
            assert err < (1e-4 if f < first[b] else PLC_PCM_TOL), (f, b, err)
    assert gpu.final_ranges() == cpu.final_ranges()
    assert gpu.plan_fallbacks == 0
    assert np.array_equal(gpu._serve_plc_pitch.cpu().numpy(), cpu._serve_plc_pitch.numpy())


def test_native_traffic_serves_like_jax(jax_serve):
    """The `cuda` case's traffic (the port's native encoders) through the
    port's and the JAX plan loop on the CPU, as test_serve_matches_jax."""
    pytest.importorskip("jax")
    from opus_tpu.batch.opus_pipeline import BatchedOpusDecoder as JaxDecoder

    first = _first_device_loss()
    port = _port("plan", "internal")
    ref = JaxDecoder(B, 2, transfer="plan", silk_transfer="internal")
    ref._steps = jax_serve("plan", "internal")["dec"]._steps  # mostly compiled already
    for f, row in enumerate(_native_steps(NF)):
        port.serve([row])
        ref.serve([row])
        _check_ring(port._serve_ring.numpy(), np.asarray(ref._serve_ring), f, first)
    assert port.final_ranges() == ref.final_ranges()
