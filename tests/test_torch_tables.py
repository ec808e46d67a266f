"""The port's constant tables are bit-identical to the reference's.

opus_tpu_torch.dsp.tables copies the jax-free numpy builders out of
opus_tpu.dsp.synthesis and opus_tpu.dsp.pallas_pf (which import jax);
every copy must equal its original exactly (np.array_equal, same dtype).
"""

import numpy as np
import pytest

from opus_tpu.dsp import pallas_pf as P
from opus_tpu.dsp import synthesis as S
from opus_tpu_torch.dsp import tables as T


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("n2", [120, 240, 480, 960])
def test_synthesis_basis(n2):
    assert _same(T._synthesis_basis(n2), S._synthesis_basis(n2))


@pytest.mark.parametrize("lm", [0, 1, 2, 3])
def test_band_tables(lm):
    assert _same(T._band_of_bin(lm), S._band_of_bin(lm))
    assert _same(T._band_onehot(lm), S._band_onehot(lm))


def test_deemphasis_tables():
    assert T._DEEMPH_BLK == S._DEEMPH_BLK
    assert _same(T._deemph_toeplitz(), S._deemph_toeplitz())
    assert _same(T._deemph_powers(), S._deemph_powers())


@pytest.mark.parametrize("lm", [0, 1, 2, 3])
def test_envelopes(lm):
    """The post-filter kernel weighs each filter with WINDOW^2 as
    csrc/postfilter.cu lays it out: the reference kernel's per-filter
    envelopes, bit for bit."""
    n = 120 << lm
    w2 = T._window_sq()
    for hist, w in ((2048 - n, 2048), (2048 - n - 8, 2040)):
        wf = np.zeros((4, w), np.float32)
        wf[0, hist : hist + 120] = 1.0 - w2
        wf[1, hist : hist + 120] = w2
        if lm:
            wf[1, hist + 120 : hist + 240] = 1.0 - w2
            wf[2, hist + 120 : hist + 240] = w2
            wf[2, hist + 240 : hist + n] = 1.0
        assert _same(wf, P._envelopes(n, lm, hist, w))


def test_postfilter_kernel_gains_table():
    """The GAINS literals in csrc/postfilter.cu round to the port's
    float32 tap-gain table."""
    import pathlib
    import re

    src = (pathlib.Path(T.__file__).parent.parent / "csrc" / "postfilter.cu").read_text()
    body = re.search(r"kGains\[3\]\[3\] = \{(.*?)\};", src, re.S).group(1)
    lits = [float(v) for v in re.findall(r"([0-9.]+)f", body)]
    assert _same(np.array(lits, np.float32).reshape(3, 3), T._tap_gains())


def test_pf_chunk_for():
    assert T.PF_CHUNKS == S.PF_CHUNKS
    rng = np.random.default_rng(5)
    for case in range(200):
        periods = rng.integers(-3, 1100, (6, 3)).astype(np.int32)
        gains = (rng.integers(0, 3, (6, 3)) * 0.125).astype(np.float32)
        if case % 10 == 0:
            gains[:] = 0.0
        assert T.pf_chunk_for(periods, gains) == S.pf_chunk_for(periods, gains)


@pytest.mark.parametrize("mode", ["q14", "p12", "p10", "p8"])
def test_packed_layout(mode):
    assert T.PACK_BITS == S.PACK_BITS and T.XQ_WORDS == S.XQ_WORDS
    for batch in (1, 4, 1024):
        for silk_words in (0, 481):
            assert T.packed_words(batch, mode, silk_words) == S.packed_words(batch, mode, silk_words)
            assert T.packed_offsets(batch, mode, silk_words) == S.packed_offsets(batch, mode, silk_words)


def test_mode_constants_match_their_origins():
    """opus_tpu_torch.celt.modes copies the constants the port reads from
    four reference modules; each must be bit-identical."""
    from opus_tpu.celt import comb_filter, decoder, energy
    from opus_tpu.celt import modes as ref
    from opus_tpu_torch.celt import modes as port

    for name in ("OVERLAP", "MAX_LM", "SHORT_MDCT_SIZE", "NB_E_BANDS"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.PREEMPH.dtype == ref.PREEMPH.dtype and port.PREEMPH == ref.PREEMPH
    assert _same(port.E_BANDS, ref.E_BANDS)
    assert _same(port.WINDOW, ref.WINDOW)
    for overlap in (60, 120, 240):
        assert _same(port._make_window(overlap), ref._make_window(overlap))
    assert port.DECODE_BUFFER_SIZE == decoder.DECODE_BUFFER_SIZE
    assert port.GAINS == comb_filter.GAINS
    assert _same(port.E_MEANS, energy.E_MEANS)


@pytest.mark.parametrize("lm", [0, 1, 2, 3])
def test_plan_band_transforms(lm):
    """Every reachable band config's (forward, undo) pair, and the
    reachability tables, bit-identical to opus_tpu.dsp.plan_exec."""
    from opus_tpu.dsp import plan_exec as R
    from opus_tpu_torch.dsp import plan_tables as PT

    assert PT._TF_CFGS == R._TF_CFGS and PT._ORDERY == R._ORDERY
    assert _same(PT._plan_band_of_bin(lm), R._plan_band_of_bin(lm))
    m = 1 << lm
    e = R.modes.E_BANDS.astype(np.int64) * m
    for bi in range(21):
        nb = int(e[bi + 1] - e[bi])
        for lb in (True, False):
            for rec, td in R._TF_CFGS[lm][lb] + [(1, 1), (3, 3)]:
                bf = 1 if lb else m
                assert PT._valid_cfg(nb, bf, rec, td) == R._valid_cfg(nb, bf, rec, td)
                if R._valid_cfg(nb, bf, rec, td):
                    for a, b in zip(PT.band_transforms(nb, bf, rec, td, lb),
                                    R.band_transforms(nb, bf, rec, td, lb)):
                        assert _same(a, b)


def test_plan_scalar_builders():
    from opus_tpu.dsp import plan_exec as R
    from opus_tpu_torch.dsp import plan_tables as PT

    assert PT.EPSILON == R.EPSILON and PT._SPREAD_FACTOR == R._SPREAD_FACTOR
    assert PT._LCG_MAX == R._LCG_MAX and PT._lcg_pow2() == R._lcg_pow2()
    for n in (2, 3, 8, 16, 44, 96, 176):
        for k in (0, 1, 2, 5, 20, 90):
            for spread in (0, 1, 2, 3):
                for bq in (1, 2, 4, 8):
                    assert PT.rotation_params(n, k, spread, bq) == R.rotation_params(n, k, spread, bq)
    for seed in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF, 123456789):
        assert PT.lcg(seed) == R.lcg(seed)
    h = np.arange(65536, dtype=np.uint16)
    assert _same(PT.f16_bits_to_f32(h), R.f16_bits_to_f32(h))
