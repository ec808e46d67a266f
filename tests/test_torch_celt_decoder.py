"""The port's copies of the scalar CELT decoder stack against the
reference's modules.

Each copy keeps the reference's code below a module docstring of its own:
its syntax tree, the docstring dropped, must equal the reference
module's, and it imports neither torch nor jax.  celt/modes.py is the
reference's mode plus three constants of other modules, each equal to
its origin.  The port's CeltDecoder then decodes libopus CELT packets
(5, 10 and 20 ms, mono and stereo, end bands 13, 17 and 21, a reset
between frames and a lost frame) exactly as opus_tpu.celt.decoder's:
equal final ranges, PCM within 1e-7.  The modules run numpy on the host.
"""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["errors.py", "mathops.py", "rc/__init__.py", "rc/common.py", "rc/decoder.py",
          "rc/encoder.py", "rc/laplace.py", "celt/cwrs.py", "celt/rate.py", "celt/vq.py",
          "celt/energy.py", "celt/bands.py", "celt/comb_filter.py", "celt/mdct.py",
          "celt/plc.py", "celt/decoder.py"]
PCM_TOL = 1e-7


def _tree_without_docstring(path: pathlib.Path) -> ast.Module:
    tree = ast.parse(path.read_text())
    assert isinstance(tree.body[0], ast.Expr) and isinstance(tree.body[0].value, ast.Constant)
    tree.body = tree.body[1:]
    return tree


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference_module(rel):
    port = _tree_without_docstring(ROOT / "opus_tpu_torch" / rel)
    ref = _tree_without_docstring(ROOT / "opus_tpu" / rel)
    assert ast.dump(port) == ast.dump(ref), rel
    imported = {a.name.split(".")[0] for n in ast.walk(port) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(port)
                 if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
    assert not imported & {"torch", "jax", "opus_tpu"}, (rel, imported)
    doc = ast.get_docstring(ast.parse((ROOT / "opus_tpu_torch" / rel).read_text()))
    assert "reference/src" not in doc  # the reference cites its source tree by path


def test_modes_defines_every_reference_name():
    from opus_tpu.celt import comb_filter, decoder, energy
    from opus_tpu.celt import modes as ref
    from opus_tpu_torch.celt import modes as port

    names = [n for n in vars(ref) if not n.startswith("__") and n not in ("annotations", "np")]
    assert len(names) >= 19
    for name in names:
        want, got = getattr(ref, name), getattr(port, name)
        if callable(want):
            assert ast.dump(ast.parse(_source(got))) == ast.dump(ast.parse(_source(want))), name
            continue
        assert type(got) is type(want), name
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        else:
            assert got == want, name
    for lm in range(4):
        assert np.array_equal(port.band_bins(lm), ref.band_bins(lm))
    assert port.DECODE_BUFFER_SIZE == decoder.DECODE_BUFFER_SIZE
    assert port.GAINS == comb_filter.GAINS
    assert port.E_MEANS.dtype == energy.E_MEANS.dtype
    assert np.array_equal(port.E_MEANS, energy.E_MEANS)


def _source(fn) -> str:
    import inspect
    import textwrap

    return textwrap.dedent(inspect.getsource(fn))


def _celt_packets(frame: int, channels: int, max_bw: int, nf: int) -> list:
    """nf CELT-only libopus packets (ToC stripped) of a tone, noise and a
    click, at 64 kbps a channel and the given maximum bandwidth."""
    from opus_tpu import oracle, parse_packet

    if not oracle.available():
        pytest.skip("libopus not present")
    rng = np.random.default_rng(frame + channels)
    t = np.arange(frame * nf) / 48000.0
    sig = 0.4 * np.sin(2 * np.pi * 523.0 * t) + 0.05 * rng.standard_normal(t.size)
    sig[frame * 2 + 17] += 0.9
    pcm = np.stack([sig, 0.7 * np.roll(sig, 5)][:channels], -1).astype(np.float32)
    enc = oracle.Encoder(48000, channels)
    enc.ctl(oracle.SET_FORCE_MODE, oracle.MODE_CELT_ONLY)
    enc.ctl(oracle.SET_BITRATE, 64000 * channels)
    enc.ctl(oracle.SET_MAX_BANDWIDTH, max_bw)
    out = []
    for f in range(nf):
        pkt = enc.encode_float(np.ascontiguousarray(pcm[f * frame : (f + 1) * frame]).ravel(),
                               frame)
        out.append(pkt[parse_packet(pkt).payload_offset :])
    return out


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("frame", [240, 480, 960])
def test_celt_decoder_matches_reference(frame, channels):
    """Both CeltDecoders, stereo output, on the same packets with the end
    band of each bandwidth (NB 13, WB 17, FB 21) and the stream's coded
    channels; a reset before frame 3 and frame 5 lost: equal final ranges
    and PCM within 1e-7 on every frame."""
    from opus_tpu.celt.decoder import CeltDecoder as RefDecoder
    from opus_tpu_torch.celt.decoder import CeltDecoder

    nf = 7
    for max_bw, end in ((1101, 13), (1103, 17), (1105, 21)):
        pkts = _celt_packets(frame, channels, max_bw, nf)
        ref, port = RefDecoder(2, 1), CeltDecoder(2, 1)
        for d in (ref, port):
            d.end_band = end
            d.stream_channels = channels
        for f, data in enumerate(pkts):
            if f == 3:
                ref.reset()
                port.reset()
            if f == 5:
                data = None
            want = np.asarray(ref.decode(data, frame))
            got = np.asarray(port.decode(data, frame))
            assert got.shape == want.shape == (frame, 2)
            assert got.dtype == want.dtype
            assert float(np.abs(got - want).max(initial=0.0)) < PCM_TOL, (max_bw, f)
            assert port.final_range == ref.final_range, (max_bw, f)
            if data is None:
                assert np.abs(got).max() > 0  # the concealed frame is not silence
