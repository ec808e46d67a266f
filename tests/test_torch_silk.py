"""The port's SILK-only batch decoder against the reference, on the CPU.

* The SILK layer copies (opus_tpu_torch/silk/) equal the reference's
  modules: their syntax trees, the docstring dropped, are the same.
* `silk_synthesis_step`'s plain version equals the JAX
  `silk_synthesis_step` on seeded inputs at 8, 12 and 16 kHz, voiced and
  unvoiced rows (tolerance 1e-3 of an int16 LSB; both round every
  operation in the same order, so they agree bit for bit at the suite's
  XLA optimisation level), and stays within 1e-3 of each row's peak of a
  float64 run of itself with lags at chunk + 2 and at 18 fs_khz and LPC
  poles at radius 0.995.
* `BatchedSilkDecoder` equals the JAX one at B=4 over 8 frames of libopus
  SILK (started from the JAX decoder's state every frame: the rounded
  output fed back is equal), and meets the reference's gate
  tests/test_dsp_silk.py:13, SNR > 35 dB against the scalar decoder.
* On the card (`cuda`, skipped here) the kernel equals the plain version
  on the same cases, and one call is one launch.
"""

from __future__ import annotations

import ast
import math
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["__init__.py", "tables.py", "fixed_math.py", "bitstream.py", "nlsf.py", "decoder.py",
          "resampler.py"]
RATES = [(8, 10, 10), (12, 20, 10), (16, 20, 16)]  # fs_khz, chunk, LPC order
LSB_TOL = 1e-3  # plain vs JAX, in int16 LSBs
PEAK_TOL = 1e-3  # f32 vs float64, of each row's peak (the gate lpc_synth uses)
SNR_DB = 35.0  # tests/test_dsp_silk.py


def _tree_without_docstring(path: pathlib.Path) -> ast.Module:
    tree = ast.parse(path.read_text())
    assert isinstance(tree.body[0], ast.Expr) and isinstance(tree.body[0].value, ast.Constant)
    tree.body = tree.body[1:]
    return tree


@pytest.mark.parametrize("name", COPIES)
def test_copy_equals_reference_module(name):
    port = _tree_without_docstring(ROOT / "opus_tpu_torch" / "silk" / name)
    ref = _tree_without_docstring(ROOT / "opus_tpu" / "silk" / name)
    assert ast.dump(port) == ast.dump(ref), name
    imported = {a.name.split(".")[0] for n in ast.walk(port) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(port)
                 if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
    assert not imported & {"torch", "jax", "opus_tpu"}, (name, imported)
    doc = ast.get_docstring(ast.parse((ROOT / "opus_tpu_torch" / "silk" / name).read_text()))
    assert "reference/src" not in doc


def synth_inputs(fs_khz: int, chunk: int, order: int, rows: int = 8, seed: int = 0):
    """Seeded inputs of one frame: rows 0-1 voiced at lags chunk + 2 and
    18 fs_khz (the clamp's edge and the longest lag, whose taps reach the
    history's first sample), rows 2-3 with an LPC pole pair at radius
    0.995, odd rows from 3 on unvoiced; LTP taps summing below 1."""
    rng = np.random.default_rng(seed + fs_khz)
    S = 5 * fs_khz
    L, H = 4 * S, 18 * fs_khz + 2
    gexc = (rng.standard_normal((rows, L)) * 300).astype(np.float32)
    a1 = (rng.standard_normal((rows, order)) * 0.05).astype(np.float32)
    a2 = (rng.standard_normal((rows, order)) * 0.05).astype(np.float32)
    for r, th in ((2, 0.2), (3, 0.05)):
        for a in (a1, a2):
            a[r] = 0.0
            a[r, :2] = [2 * 0.995 * np.cos(th), -0.995 ** 2]
    voiced = np.array([r < 3 or r % 2 == 0 for r in range(rows)])
    lags = rng.integers(chunk + 2, 18 * fs_khz + 1, (rows, 4)).astype(np.int32)
    lags[0], lags[1] = chunk + 2, 18 * fs_khz
    b = (rng.uniform(0.0, 0.35, (rows, 4, 5)) * np.array([0.3, 0.6, 1.0, 0.6, 0.3])
         ).astype(np.float32)
    head = (rng.standard_normal((rows, H)) * 1000).astype(np.float32)
    hist = (rng.standard_normal((rows, order)) * 1000).astype(np.float32)
    return (gexc, a1, a2, voiced, lags, b, head, hist), dict(subfr_len=S, nb_subfr=4, chunk=chunk)


@pytest.mark.parametrize("fs_khz,chunk,order", RATES)
def test_plain_synthesis_matches_jax(fs_khz, chunk, order):
    import jax.numpy as jnp

    from opus_tpu.dsp.silk_synthesis import silk_synthesis_step as jax_step
    from opus_tpu_torch.dsp.silk_synthesis import silk_synthesis_step

    args, kw = synth_inputs(fs_khz, chunk, order)
    xq_j, hist_j = jax_step(*map(jnp.asarray, args), **kw)
    before = silk_synthesis_step.launches
    xq, hist = silk_synthesis_step(*map(torch.tensor, args), **kw)
    assert xq.shape == (8, 20 * fs_khz) and hist.shape == (8, order)
    assert float(np.abs(xq.numpy() - np.asarray(xq_j)).max()) < LSB_TOL
    assert float(np.abs(hist.numpy() - np.asarray(hist_j)).max()) < LSB_TOL
    assert silk_synthesis_step.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("fs_khz,chunk,order", RATES)
def test_plain_synthesis_vs_float64(fs_khz, chunk, order):
    from opus_tpu_torch.dsp.silk_synthesis import _silk_synth_ref

    args, kw = synth_inputs(fs_khz, chunk, order, seed=1)
    t = [torch.tensor(a) for a in args]
    got, _ = _silk_synth_ref(*t, **kw)
    want, _ = _silk_synth_ref(*[a.double() if a.is_floating_point() else a for a in t], **kw)
    peak = want.abs().amax(dim=1)
    err = ((got.double() - want).abs().amax(dim=1) / peak).max()
    assert float(err) < PEAK_TOL
    assert bool(torch.isfinite(got).all())


def _silk_payloads(fs: int, nf: int, batch: int = 4) -> list:
    """steps[f][b]: libopus SILK-only payloads (ToC stripped) at 16-40
    kbps of a pulse-train voice (the reference gate's content)."""
    from opus_tpu import oracle, parse_packet

    if not oracle.available():
        pytest.skip("libopus not present")
    frame = fs // 50
    t = np.arange(frame * nf) / fs
    steps = [[] for _ in range(nf)]
    for b in range(batch):
        enc = oracle.Encoder(fs, 1)
        enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
        enc.ctl(oracle.SET_BITRATE, [16, 24, 32, 40][b] * 1000)
        rng = np.random.default_rng(b)
        phase = np.cumsum(2 * np.pi * (100 + 20 * b + 30 * np.sin(2 * np.pi * 3 * t)) / fs)
        s = (0.35 * np.sign(np.sin(phase)) * np.exp(-3 * (t % 0.01) * 100)
             + 0.02 * rng.standard_normal(frame * nf)).astype(np.float32)
        for f in range(nf):
            pkt = enc.encode_float(s[f * frame : (f + 1) * frame], frame)
            steps[f].append(pkt[parse_packet(pkt).payload_offset :])
    return steps


@pytest.mark.parametrize("fs_khz", [8, 16])
def test_batched_decoder_matches_jax(fs_khz):
    """Each frame starts the port from the JAX decoder's state (lpc_hist
    and every front end's out_buf, through state.py): the output is equal
    within 1e-3 of an LSB and the rounded output fed back is equal."""
    from opus_tpu.batch.silk_pipeline import BatchedSilkDecoder as JaxDecoder
    from opus_tpu_torch.batch.silk_pipeline import BatchedSilkDecoder
    from opus_tpu_torch.silk.bitstream import TYPE_VOICED
    from opus_tpu_torch.state import load_silk_state, silk_state_to_numpy

    steps = _silk_payloads(1000 * fs_khz, 8)
    ref = JaxDecoder(4, fs_khz)
    port = BatchedSilkDecoder(4, fs_khz, device="cpu")
    voiced = 0  # voiced stream-frames
    for f, payloads in enumerate(steps):
        load_silk_state(port, np.asarray(ref.lpc_hist), [fr.st.out_buf for fr in ref.fronts])
        want = ref.decode_frames(payloads)
        got = port.decode_frames(payloads)
        assert got.shape == want.shape == (4, 20 * fs_khz)
        assert float(np.abs(got - want).max()) < LSB_TOL, f
        hist, out_buf = silk_state_to_numpy(port)
        np.testing.assert_array_equal(out_buf, [fr.st.out_buf for fr in ref.fronts])
        assert float(np.abs(hist - np.asarray(ref.lpc_hist)).max()) < LSB_TOL
        voiced += sum(fr.st.prev_signal_type == TYPE_VOICED for fr in port.fronts)
    # the reference returns no ranges (a fault the port inherits: ROADMAP.md)
    assert port.final_ranges() == ref.final_ranges() == [None] * 4
    assert voiced > 0


def test_silk_device_plane_parity():
    """tests/test_dsp_silk.py:13 through the port: SNR > 35 dB against the
    normative scalar decoder (which has a 13-sample API delay)."""
    from opus_tpu import oracle, parse_packet
    from opus_tpu.decoder import Decoder, DecoderConfiguration
    from opus_tpu.types import Channels, SamplingRate
    from opus_tpu_torch.batch.silk_pipeline import BatchedSilkDecoder

    if not oracle.available():
        pytest.skip("libopus not present")
    B, fs, frame, nf = 4, 16000, 320, 8
    encs = []
    for b in range(B):
        e = oracle.Encoder(fs, 1)
        e.ctl(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
        e.ctl(oracle.SET_BITRATE, [16, 24, 32, 40][b] * 1000)
        encs.append(e)
    t = np.arange(frame * nf) / fs
    streams = []
    for b in range(B):
        rng = np.random.default_rng(b)
        phase = np.cumsum(2 * np.pi * (100 + 20 * b + 30 * np.sin(2 * np.pi * 3 * t)) / fs)
        s = (0.35 * np.sign(np.sin(phase)) * np.exp(-3 * (t % 0.01) * 100)
             + 0.02 * rng.standard_normal(frame * nf))
        streams.append(s.astype(np.float32))
    bd = BatchedSilkDecoder(B, 16, device="cpu")
    hosts = [Decoder(DecoderConfiguration(SamplingRate.HZ_16000, Channels.MONO))
             for _ in range(B)]
    checked = 0
    for f in range(nf):
        payloads, host_out = [], []
        for b in range(B):
            pkt = encs[b].encode_float(streams[b][f * frame : (f + 1) * frame], frame)
            payloads.append(pkt[parse_packet(pkt).payload_offset :])
            host_out.append(hosts[b].decode_float(pkt, frame)[:, 0] * 32768.0)
        xq = bd.decode_frames(payloads)
        for b in range(B):
            a = host_out[b][13:]
            c = xq[b][: len(a)]
            num = float(np.dot(a, a))
            den = float(np.dot(a - c, a - c)) + 1e-9
            if num > 1e3:
                snr = 10 * math.log10(num / den)
                assert snr > SNR_DB, f"frame {f} stream {b}: device/host SNR {snr:.1f}"
                checked += 1
    assert checked >= nf * B // 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the silk_synth kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fs_khz,chunk,order", RATES)
def test_kernel_matches_plain_on_card(cuda_device, fs_khz, chunk, order):
    """The kernel equals the plain version on the card (both round every
    operation alike) and is within 1e-3 of each row's peak of the float64
    run, at 1,024 rows; one call is one launch."""
    from opus_tpu_torch.dsp.silk_synthesis import _silk_synth_ref, silk_synthesis_step

    args, kw = synth_inputs(fs_khz, chunk, order, rows=1024, seed=2)
    t = [torch.tensor(a, device=cuda_device) for a in args]
    before = silk_synthesis_step.launches
    xq, hist = silk_synthesis_step(*t, **kw)
    want, want_hist = _silk_synth_ref(*t, **kw)
    f64, _ = _silk_synth_ref(*[a.double() if a.is_floating_point() else a for a in t], **kw)
    torch.cuda.synchronize()
    assert silk_synthesis_step.launches == before + 1
    assert float((xq - want).abs().max()) < LSB_TOL
    assert float((hist - want_hist).abs().max()) < LSB_TOL
    peak = f64.abs().amax(dim=1)
    assert float(((xq.double() - f64).abs().amax(dim=1) / peak).max()) < PEAK_TOL
