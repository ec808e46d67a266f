"""The port's batched CELT music encoder against the JAX package's.

* The host copies (celt/energy_encode.py, celt/encoder.py,
  celt/plan_encoder.py) keep the reference's syntax trees below their
  own docstrings; the numpy tables (`forward_mdct_basis`, `cell_table`)
  are the reference's arrays.
* The device plane: the analyze step equals the reference's within 1e-5
  of each output's peak (the MDCT and the band sums are matmuls that sum
  in another order than XLA's); the plain PVQ search, fed the JAX
  analyze's spectra and the host's leaves, equals the JAX search on at
  least 99.9% of the leaves, and a leaf that differs (a near tie broken
  the other way by the reduction order of sum |x| or xy) carries the same
  pulse count and a greedy score within 1e-6 relative.  The plan and emit
  passes on the JAX device outputs give the JAX encoder's packets byte for
  byte.
* The reference's gates (tests/test_encode_plan.py:33, :57, :96) on the
  port's BatchedPlanEncoder(device="cpu"): the three-way final range
  (encoder, libopus, the port's own decoders), quality within 3 dB of
  libopus, silence.  The port's SNR lies within 0.25 dB of the JAX
  encoder's; the overflow fallback and a state handed over from a JAX
  encoder give the JAX encoder's packets.
* Two faults of the reference that the port keeps (ROADMAP Queue 3):
  t_max < NMAX, and the silence sentinel `plan_frame` never returns.
* The packed layout (dsp/pvq_search.py): `pack` / `unpack` round trip the
  plain search's padded pulses at every width-class edge; `leaf_order`
  lists every used row once, grouped by class, with the exclusive
  cumulative sum of the widths as starts; `PackedRows` gives the emit pass
  the padded row's [:n] for every n and stops at the leaf count.
* On the card (`cuda`, skipped here) the kernel equals the plain version
  exactly, the packed iy and left, on chip_smoke.py's synthetic leaves
  and on a batch of each width class alone.
"""

from __future__ import annotations

import ast
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

COPIES = ["celt/energy_encode.py", "celt/encoder.py", "celt/plan_encoder.py"]
F = 960
ANALYZE_PEAK_TOL = 1e-5  # of each analyze output's peak: matmul sum order
SEARCH_EQUAL_SHARE = 0.999  # leaves whose pulses equal the JAX search's
SCORE_REL_TOL = 1e-6  # greedy score of a leaf that differs
SNR_TOL_DB = 0.25  # port vs JAX encoder, same signal


def _sig(nf, seed=3):
    """tests/test_encode_plan.py's signal: two tones and noise, the right
    channel 0.8x and 5 samples late."""
    rng = np.random.default_rng(seed)
    t = np.arange(F * nf) / 48000
    s = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.15 * np.sin(2 * np.pi * 1870 * t)
         + 0.05 * rng.standard_normal(F * nf))
    return np.stack([s, 0.8 * np.roll(s, 5)], -1).astype(np.float32)


def _frames(nf, batch, channels, seed=3):
    """[nf, batch, F, channels]: _sig, stream b scaled by 0.5 + 0.5 b / batch
    (as the reference's gate makes its streams differ)."""
    pcm = _sig(nf, seed)[:, :channels]
    scale = (0.5 + 0.5 * np.arange(batch) / batch)[:, None, None]
    return [(np.stack([pcm[f * F : (f + 1) * F]] * batch) * scale).astype(np.float32)
            for f in range(nf)]


def _jnp():
    """jax.numpy, imported inside the CPU tests: the machine with the card
    has no jax, and the `cuda` cases must still run there."""
    return pytest.importorskip("jax.numpy")


def _oracle():
    """The reference's libopus wrapper (it imports jax)."""
    pytest.importorskip("jax")
    from opus_tpu import oracle

    if not oracle.available():
        pytest.skip("libopus not present")
    return oracle


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
    assert "reference/src" not in (ROOT / "opus_tpu_torch" / rel).read_text()


def test_numpy_tables_equal_reference():
    from opus_tpu.dsp import encode_exec as ref
    from opus_tpu_torch.dsp import encode_exec as port

    for n2 in (120, 240, 480, 960):
        want, got = ref.forward_mdct_basis(n2), port.forward_mdct_basis(n2)
        assert got.dtype == want.dtype and np.array_equal(got, want), n2
    for lm in range(4):
        for got, want in zip(port.cell_table(lm), ref.cell_table(lm), strict=True):
            assert got.dtype == want.dtype and np.array_equal(got, want), lm
    assert len(port.cell_table(3)[0]) == 208


def test_kernel_band_table_is_modes():
    """csrc/pvq.cu's band edges are modes.E_BANDS (the kernel builds its
    table of the band of each position from them at compile time)."""
    from opus_tpu_torch.celt import modes

    src = (ROOT / "opus_tpu_torch" / "csrc" / "pvq.cu").read_text()
    body = src.split("kEBands[kBands + 1] = {", 1)[1].split("}", 1)[0]
    assert [int(v) for v in body.split(",")] == modes.E_BANDS.tolist()


def test_kernel_class_tiles_are_the_wrappers():
    """csrc/pvq.cu's lanes a leaf of each width class are pvq_search's
    CLASS_TILES, in the row list's order; the classes' n ranges tile
    1..n_max."""
    from opus_tpu_torch.dsp.pvq_search import CLASS_TILES, class_ranges

    src = (ROOT / "opus_tpu_torch" / "csrc" / "pvq.cu").read_text()
    body = src.split("kTiles[kClasses] = {", 1)[1].split("}", 1)[0]
    tiles = [32 if v.strip() == "kWarp" else int(v) for v in body.split(",")]
    assert tuple(tiles) == CLASS_TILES
    ranges = class_ranges(176)
    assert [n for lo, hi in ranges[::-1] for n in range(lo, hi + 1)] == list(range(1, 177))
    assert all(hi <= t for (_lo, hi), t in zip(ranges[1:], CLASS_TILES[1:]))


@pytest.mark.parametrize("channels", [1, 2])
def test_analyze_matches_jax(channels):
    from opus_tpu.dsp.encode_exec import make_encode_analyze as jax_analyze
    from opus_tpu_torch.dsp.encode_exec import make_encode_analyze

    B = 4
    rng = np.random.default_rng(11 + channels)
    pcm = _frames(1, B, channels)[0] + (0.01 * rng.standard_normal((B, F, channels))
                                        ).astype(np.float32)
    pcm[1] *= 0.0  # a silent stream
    in_mem = (rng.standard_normal((B, channels, 120)) * 300).astype(np.float32)
    pm = (rng.standard_normal((B, channels)) * 300).astype(np.float32)
    jnp = _jnp()
    want = jax_analyze(3, B, channels)(jnp.asarray(pcm), jnp.asarray(in_mem), jnp.asarray(pm))
    got = make_encode_analyze(3, B, channels, device="cpu")(
        torch.from_numpy(pcm), torch.from_numpy(in_mem), torch.from_numpy(pm))
    names = ["x", "band_e", "cells", "dots", "in_mem", "preemph_mem"]
    for name, g, w in zip(names, got, want, strict=True):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= ANALYZE_PEAK_TOL * float(np.abs(w).max()), (name, err)


def _greedy_score(ax, iy):
    """(sum |x| |iy|)^2 / sum iy^2 in float64: what the greedy search
    raises pulse by pulse."""
    a = np.abs(iy).astype(np.float64)
    return (ax.astype(np.float64) * a).sum(-1) ** 2 / np.maximum((a * a).sum(-1), 1e-300)


def _hold_search_to_jax(x, band_ops, leaves, channels, label):
    """The plain search vs the JAX search on the same inputs: iy equal on
    SEARCH_EQUAL_SHARE of the leaves, left equal, a differing leaf with
    the same pulse count and a greedy score within SCORE_REL_TOL."""
    from opus_tpu.dsp.encode_exec import make_encode_search as jax_search
    from opus_tpu_torch.dsp.pvq_search import _prefill, leaf_order, pvq_search, unpack

    jnp = _jnp()
    B, P = leaves.shape[:2]
    want_iy, want_left = (np.asarray(a) for a in jax_search(3, B, channels, p_max=P)(
        jnp.asarray(x), jnp.asarray(band_ops), jnp.asarray(leaves)))
    tx, tb, tl = (torch.from_numpy(np.array(a)) for a in (x, band_ops, leaves))
    order = leaf_order(np.asarray(leaves))
    iy, left = pvq_search(tx, tb, tl, order)
    assert iy.dtype == torch.int16 and tuple(iy.shape) == (order.total,)
    got_iy, got_left = unpack(iy, tl).numpy(), left.numpy()
    valid = leaves[..., 2] > 0
    differs = (got_iy != want_iy).any(-1)
    assert not (differs & ~valid).any()
    n_diff = int(differs.sum())
    print(f"{label}: {n_diff} of {int(valid.sum())} leaves differ from the JAX search")
    assert n_diff <= (1 - SEARCH_EQUAL_SHARE) * valid.sum(), (label, n_diff)
    assert np.array_equal(got_left, want_left), label
    ax = _prefill(tx, tb, tl, 3, 176)[0].numpy()
    assert np.array_equal(np.abs(got_iy).sum(-1), np.abs(want_iy).sum(-1))
    sg, sw = _greedy_score(ax[differs], got_iy[differs]), _greedy_score(ax[differs],
                                                                        want_iy[differs])
    assert np.all(np.abs(sg - sw) <= SCORE_REL_TOL * np.maximum(np.abs(sw), 1e-30)), label
    return n_diff


class _Recorder:
    """Wraps a JAX BatchedPlanEncoder's two device steps and keeps what
    each step of encode_step passed and returned, as numpy."""

    def __init__(self, enc):
        self.steps = []
        ana, srch = enc._ana, enc._srch

        def analyze(*args):
            out = ana(*args)
            self.steps.append({"analyze": [np.asarray(a) for a in out]})
            return out

        def search(x, band_ops, leaves):
            out = srch(x, band_ops, leaves)
            self.steps[-1]["search_in"] = [np.asarray(a) for a in (x, band_ops, leaves)]
            self.steps[-1]["iy"] = np.asarray(out[0])
            return out

        enc._ana, enc._srch = analyze, search


@pytest.mark.parametrize("channels,kbps", [(2, 96), (1, 64)])
def test_plain_search_and_host_passes_match_jax(channels, kbps):
    """On the JAX encoder's own steps: the port's plan pass gives the leaf
    table and band ops the JAX search got; the plain search on those
    inputs holds to the JAX search; the port's emit pass on the JAX
    search's pulses gives the JAX encoder's packets, byte for byte."""
    from opus_tpu.batch.encode_pipeline import BatchedPlanEncoder as JaxEncoder
    from opus_tpu_torch.celt.plan_encoder import PlanCeltEncoder

    B, NF = 8, 3
    ref = JaxEncoder(B, channels, kbps * 1000)
    rec = _Recorder(ref)
    hosts = [PlanCeltEncoder(channels) for _ in range(B)]
    nb = ref.frame_bytes()
    n_diff = 0
    for f, pcm in enumerate(_frames(NF, B, channels)):
        want = ref.encode_step(pcm)
        step = rec.steps[f]
        _x, band_e, cells, dots = step["analyze"][:4]
        x, band_ops, leaves = step["search_in"]
        for b in range(B):
            lv, bops = hosts[b].plan_frame(band_e[b], cells[b], dots[b], nb, 3)
            assert np.array_equal(lv, leaves[b, : len(lv)]) and not leaves[b, len(lv):].any()
            assert np.array_equal(bops, band_ops[b])
            got = hosts[b].emit_frame(band_e[b], cells[b], dots[b], nb, 3, step["iy"][b])
            assert bytes([ref.toc]) + got == want[b], (f, b)
            assert hosts[b].rng == ref.final_ranges()[b]
        n_diff += _hold_search_to_jax(x, band_ops, leaves, channels, f"frame {f}")
    print(f"{n_diff} leaves differ over {NF} frames")


@pytest.mark.parametrize("channels", [2, 1])
def test_plain_search_matches_jax_on_synthetic_leaves(channels):
    """chip_smoke.py's synthetic leaves (edge cases: n 1-3 and 176, K
    about n / 2, zero, tiny and large sums, ties, K = 200, mid/side and
    intensity bands, clamped planes and offsets), on the CPU."""
    import chip_smoke

    x, band_ops, leaves = (t.numpy() for t in chip_smoke.pvq_inputs(60, 8, channels, "cpu"))
    _hold_search_to_jax(x, band_ops, leaves, channels, f"synthetic C={channels}")




@pytest.mark.parametrize("channels", [2, 1])
def test_pack_round_trip(channels):
    """pack then unpack gives the plain search's padded pulses, on
    chip_smoke.py's synthetic leaves (every width-class edge in stream 0,
    unused rows 140-159); the packed iy is int16, one value per used
    position."""
    import chip_smoke
    from opus_tpu_torch.dsp.pvq_search import _pvq_search_ref, leaf_order, pack, unpack

    x, band_ops, leaves = chip_smoke.pvq_inputs(60, 8, channels, "cpu")
    assert set(chip_smoke.pvq_edges()) <= set(leaves[0, :, 2].tolist())
    assert not leaves[:, 140:, 2].any()
    iy, _left = _pvq_search_ref(x, band_ops, leaves)
    packed = pack(iy, leaves)
    assert packed.dtype == torch.int16
    assert packed.numel() == leaf_order(leaves.numpy()).total
    assert torch.equal(unpack(packed, leaves), iy)


@pytest.mark.parametrize("cls", [None, 0, 1, 2, 3])
def test_leaf_order(cls):
    """The host's row list and starts: every used row once and no unused
    row; grouped by class (>32, 17-32, 9-16, 1-8), row order within one;
    starts the exclusive cumulative sum of min(n, 176) in plan order.  A
    batch of one class leaves the others empty."""
    import chip_smoke
    from opus_tpu_torch.dsp.pvq_search import class_ranges, leaf_order

    leaves = (chip_smoke.pvq_inputs(60, 8, 2, "cpu") if cls is None
              else chip_smoke.pvq_one_class(62, 8, 2, cls, "cpu"))[2].numpy()
    n = leaves[..., 2].reshape(-1)
    width = np.where(n > 0, np.minimum(n, 176), 0)
    order = leaf_order(leaves)
    rows, starts = order.rows[:, 0], order.rows[:, 1]
    assert order.rows.dtype == np.int32
    assert sorted(rows.tolist()) == np.flatnonzero(n > 0).tolist()
    want_cls = np.select([(width >= lo) & (width <= hi) for lo, hi in class_ranges(176)],
                         [0, 1, 2, 3], -1)[rows]
    assert np.array_equal(want_cls, np.repeat(np.arange(4), order.counts))
    for c in range(4):
        assert np.all(np.diff(rows[want_cls == c]) > 0)
    excl = np.concatenate([[0], np.cumsum(width)[:-1]])
    assert np.array_equal(starts, excl[rows]) and order.total == width.sum()
    assert np.array_equal(order.starts.reshape(-1), excl)
    assert np.array_equal(order.widths.reshape(-1), width)
    if cls is not None:
        assert [bool(c) for c in order.counts] == [c == cls for c in range(4)]


def test_packed_rows_read_as_padded():
    """What emit_frame reads: for every row below the leaf count and every
    n in 0..176, rows[r][:n] is the padded row's [:n]; its iterator over
    range(len(rows)) stops at the leaf count (emit then codes zeros), where
    the padded rows are zero.  A stream with no leaf has none."""
    import chip_smoke
    from opus_tpu_torch.dsp.pvq_search import PackedRows, _pvq_search_ref, leaf_order, pack

    x, band_ops, leaves = chip_smoke.pvq_inputs(60, 8, 2, "cpu")
    leaves[3] = 0  # a stream with no leaf (silence or the host fallback)
    leaves[5, 30:] = 0  # and one with 30
    padded, _left = _pvq_search_ref(x, band_ops, leaves)
    padded = padded.numpy()
    order = leaf_order(leaves.numpy())
    flat = pack(torch.from_numpy(padded), leaves).numpy()
    for b in range(leaves.shape[0]):
        rows = PackedRows(flat, order, b, 176)
        count = int((leaves[b, :, 2] > 0).sum())
        assert len(rows) == count
        assert not padded[b, count:].any()
        for r in range(count):
            row = rows[r]
            assert row.dtype == np.int16
            for n in range(177):
                assert np.array_equal(row[:n], padded[b, r, :n]), (b, r, n)
        it = iter(range(len(rows)))
        assert [next(it) for _ in range(count)] == list(range(count))
        with pytest.raises(StopIteration):
            next(it)
        with pytest.raises(IndexError):
            rows[count]


def test_pvq_search_rejects_a_bad_row_list():
    """The wrapper checks the leaf order against itself (the row list, the
    class counts and the total against its widths), against the table's
    shape and n_max, on the CPU against the table's n, and the uploaded
    row list's shape and dtype."""
    import chip_smoke
    from opus_tpu_torch.dsp.pvq_search import leaf_order, pvq_search

    x, band_ops, leaves = chip_smoke.pvq_inputs(60, 8, 2, "cpu")
    order = leaf_order(leaves.numpy())
    rows = torch.from_numpy(order.rows)
    iy, left = pvq_search(x, band_ops, leaves, order.on(rows))
    assert iy.numel() == order.total
    with pytest.raises(ValueError, match="rows"):
        pvq_search(x, band_ops, leaves, order.on(rows[1:]))
    with pytest.raises(ValueError, match="rows"):
        pvq_search(x, band_ops, leaves, order.on(rows.to(torch.int64)))
    with pytest.raises(ValueError, match="rows"):
        pvq_search(x, band_ops, leaves, order._replace(rows=order.rows[1:]))
    with pytest.raises(ValueError, match="counts"):
        pvq_search(x, band_ops, leaves, order._replace(counts=order.counts[:3]))
    moved = (order.counts[0] - 1, order.counts[1] + 1, *order.counts[2:])
    with pytest.raises(ValueError, match="counts"):
        pvq_search(x, band_ops, leaves, order._replace(counts=moved))
    with pytest.raises(ValueError, match="total"):
        pvq_search(x, band_ops, leaves, order._replace(total=order.total + 1))
    with pytest.raises(ValueError, match="n_max"):
        pvq_search(x, band_ops, leaves, leaf_order(leaves.numpy(), 64))
    with pytest.raises(ValueError, match="n_max"):
        pvq_search(x, band_ops, leaves[:, :100].contiguous(), order)
    other = leaves.clone()
    other[0, 0, 2] = 33 if int(other[0, 0, 2]) != 33 else 34
    with pytest.raises(ValueError, match="not that of these leaves"):
        pvq_search(x, band_ops, leaves, leaf_order(other.numpy()))


def _libopus_decoder(channels):
    return _oracle().Decoder(48000, channels)


@pytest.mark.parametrize("channels,kbps", [(2, 96), (1, 64), (2, 64)])
def test_plan_encode_three_way_final_range(channels, kbps):
    """tests/test_encode_plan.py:33 on the port: every packet's final range
    is the encoder's in libopus's decoder and in the port's scalar
    CeltDecoder; stereo streams also through the port's batched plan
    decoder."""
    from opus_tpu_torch.batch.encode_pipeline import BatchedPlanEncoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.celt.decoder import CeltDecoder

    B, NF = 8, 4
    enc = BatchedPlanEncoder(B, channels, kbps * 1000, device="cpu")
    dec_lib = [_libopus_decoder(channels) for _ in range(B)]
    dec_port = [CeltDecoder(channels) for _ in range(B)]
    dec_batch = BatchedCeltDecoder(B, 2, transfer="plan", device="cpu") if channels == 2 else None
    for f, pcm in enumerate(_frames(NF, B, channels)):
        pkts = enc.encode_step(pcm)
        rngs = enc.final_ranges()
        assert {len(p) for p in pkts} == {enc.frame_bytes() + 1}
        for b in range(B):
            out = dec_lib[b].decode_float(pkts[b], F)
            assert np.asarray(out).size == F * channels
            assert dec_lib[b].final_range == rngs[b], (f, b)
            dec_port[b].decode(pkts[b][1:], F)
            assert dec_port[b].final_range == rngs[b], (f, b)
        if dec_batch is not None:
            dec_batch.serve([[p[1:] for p in pkts]], F)
            assert dec_batch.final_ranges() == rngs, f


def _best_snr(got, ref):
    """tests/test_encode_plan.py's delay-compensated SNR of the channel
    means, from 4800 samples on."""
    best = -1e9
    for lag in range(400):
        g = got[lag:]
        nn = min(len(ref), len(g))
        r, g2 = ref[4800:nn], g[4800:nn]
        e = r - g2[: len(r)]
        best = max(best, 10 * np.log10((r ** 2).sum() / max((e ** 2).sum(), 1e-12)))
    return best


def _decoded_mean(enc, pcm, nf):
    """Encode pcm [nf F, 2] one frame a step through enc (B = 1); decode
    with libopus; the channel mean."""
    dl = _libopus_decoder(2)
    return np.concatenate([
        np.asarray(dl.decode_float(enc.encode_step(pcm[None, f * F : (f + 1) * F])[0],
                                   F)).reshape(F, 2)
        for f in range(nf)]).mean(-1)


def test_plan_encode_quality_vs_libopus_and_jax():
    """tests/test_encode_plan.py:57 on the port (SNR within 3 dB of libopus
    CBR at 96 kbps), and within SNR_TOL_DB of the JAX encoder's."""
    from opus_tpu.batch.encode_pipeline import BatchedPlanEncoder as JaxEncoder
    from opus_tpu_torch.batch.encode_pipeline import BatchedPlanEncoder

    NF = 8
    pcm = _sig(NF)
    ref = pcm.astype(np.float64).mean(-1)
    ours = _best_snr(_decoded_mean(BatchedPlanEncoder(1, 2, 96000, device="cpu"), pcm, NF), ref)
    theirs = _best_snr(_decoded_mean(JaxEncoder(1, 2, 96000), pcm, NF), ref)
    oracle = _oracle()
    el = oracle.Encoder(48000, 2)
    el.ctl(oracle.SET_BITRATE, 96000)
    el.ctl(oracle.SET_VBR, 0)
    d2 = _libopus_decoder(2)
    lib = np.concatenate([
        np.asarray(d2.decode_float(el.encode_float(pcm[f * F : (f + 1) * F].ravel(), F),
                                   F)).reshape(F, 2)
        for f in range(NF)]).mean(-1)
    print(f"SNR port {ours} dB, JAX {theirs} dB, libopus {_best_snr(lib, ref)} dB")
    assert ours > _best_snr(lib, ref) - 3.0
    assert abs(ours - theirs) <= SNR_TOL_DB


def test_plan_encode_silence():
    """tests/test_encode_plan.py:96 on the port: digitally silent frames
    decode to silence in libopus."""
    from opus_tpu_torch.batch.encode_pipeline import BatchedPlanEncoder

    enc = BatchedPlanEncoder(2, 2, 64000, device="cpu")
    pkts = enc.encode_step(np.zeros((2, F, 2), np.float32))
    dl = _libopus_decoder(2)
    for p in pkts:
        assert float(np.abs(np.asarray(dl.decode_float(p, F))).max()) < 1e-4


def test_overflow_fallback_matches_jax():
    """With P_MAX = 40 on both sides every stream overflows the leaf table
    and is encoded by the host fallback: the JAX encoder's packets."""
    from opus_tpu.batch.encode_pipeline import BatchedPlanEncoder as JaxEncoder
    from opus_tpu_torch.batch.encode_pipeline import BatchedPlanEncoder

    class Port(BatchedPlanEncoder):
        P_MAX = 40

    class Ref(JaxEncoder):
        P_MAX = 40

    B = 4
    port, ref = Port(B, 2, 96000, device="cpu"), Ref(B, 2, 96000)
    for pcm in _frames(3, B, 2):
        assert port.encode_step(pcm) == ref.encode_step(pcm)
        assert port.step_ms["fallback_streams"] == B
        assert port.final_ranges() == ref.final_ranges()


def test_load_encode_state_from_jax():
    """A JAX encoder encodes 2 frames; its state goes to a new port
    encoder; both encode 2 more frames: the same packets."""
    from opus_tpu.batch.encode_pipeline import BatchedPlanEncoder as JaxEncoder
    from opus_tpu_torch.batch.encode_pipeline import BatchedPlanEncoder
    from opus_tpu_torch.state import (ENCODE_HOST_FIELDS, encode_state_to_numpy,
                                      load_encode_state)

    B = 4
    frames = _frames(4, B, 2, seed=5)
    ref = JaxEncoder(B, 2, 96000)
    for pcm in frames[:2]:
        ref.encode_step(pcm)
    hosts = [{"rng": h.rng, "host": {k: getattr(h.host, k) for k in ENCODE_HOST_FIELDS}}
             for h in ref.hosts]
    port = BatchedPlanEncoder(B, 2, 96000, device="cpu")
    load_encode_state(port, np.asarray(ref._in_mem), np.asarray(ref._pm), hosts)
    in_mem, pm, back = encode_state_to_numpy(port)
    assert np.array_equal(in_mem, np.asarray(ref._in_mem)) and np.array_equal(pm, np.asarray(ref._pm))
    for got, want in zip(back, hosts, strict=True):
        assert got["rng"] == want["rng"] and got["host"].keys() == want["host"].keys()
        for k, v in want["host"].items():
            assert np.array_equal(np.asarray(got["host"][k]), np.asarray(v)), k
    for f, pcm in enumerate(frames[2:], start=2):
        assert port.encode_step(pcm) == ref.encode_step(pcm), f
        assert port.final_ranges() == ref.final_ranges(), f


def test_reference_faults_kept():
    """ROADMAP Queue 3: the search's t_max (128) is below the widest leaf
    (NMAX 176), and plan_frame never returns the silence sentinel None
    (encode_pipeline.py's `plans[b] = "silence"` is dead): a silent frame
    plans an empty leaf table."""
    from opus_tpu_torch.batch.encode_pipeline import BatchedPlanEncoder
    from opus_tpu_torch.celt.plan_encoder import PlanCeltEncoder
    from opus_tpu_torch.dsp.encode_exec import cell_table

    assert BatchedPlanEncoder.T_MAX < BatchedPlanEncoder.N_MAX
    host = PlanCeltEncoder(2)
    leaves, band_ops = host.plan_frame(np.zeros((2, 21), np.float32),
                                       np.zeros((len(cell_table(3)[0]), 3), np.float32),
                                       np.zeros(3, np.float32), 239, 3)
    assert leaves is not None and leaves.shape == (0, 4) and not band_ops.any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("channels", [2, 1])
def test_kernel_matches_plain_on_card(cuda_device, channels, cls):
    """pvq_search equals its plain version exactly (the packed iy and left)
    on the synthetic leaves (every width-class edge) and on a batch of one
    width class, one launch a call."""
    import chip_smoke
    from opus_tpu_torch.dsp.pvq_search import _pvq_search_ref, leaf_order, pack, pvq_search

    if cls is None:
        x, band_ops, leaves = chip_smoke.pvq_inputs(60 + channels, 64, channels, cuda_device)
    else:
        x, band_ops, leaves = chip_smoke.pvq_one_class(62 + cls, 64, channels, cls, cuda_device)
    order = leaf_order(leaves.cpu().numpy())
    before = pvq_search.launches
    iy, left = pvq_search(x, band_ops, leaves, order)
    want_iy, want_left = _pvq_search_ref(x, band_ops, leaves)
    torch.cuda.synchronize()
    assert pvq_search.launches == before + 1
    assert torch.equal(iy, pack(want_iy, leaves)) and torch.equal(left, want_left)
    if cls is None:
        assert int(left.sum()) > 0  # the K = 200 leaf leaves pulses unplaced
