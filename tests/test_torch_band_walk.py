"""The plan executor's band walk, stereo merge and anti-collapse
(dsp/band_walk.py) against the executor's recorded output.

`tests/data/band_walk_cases.npz` (tools/make_band_walk_cases.py) holds
plan slots that plane A decoded from libopus streams at lm 1-3 (lm 0
frames never reach the executor: plane A plans no band of one bin) and
what the executor returned on them while this region ran inline: stereo
and mono rows, dual stereo and intensity, anti-collapse records, transform
slots, a lost stream's empty plan, hybrid streams at start band 17 and
narrowband rows at end band 13.  On the CPU the executor, which now calls
`band_walk` and so `_band_walk_ref`, must return those outputs bit for
bit.  The CUDA kernel has no CPU mode: the cases marked `cuda` hold it to
`_band_walk_ref` on the card within 1e-5 (the executor's port-vs-JAX
tolerance in test_torch_plan_exec.py: the kernel's dot products and band
sums add in another order than torch's matmuls), on the recorded inputs
and on synthetic ones at every frame size, and check that a captured
replay equals its eager run bit for bit and that a served step launches
the kernel once.
"""

import pathlib

import numpy as np
import pytest
import torch

from opus_tpu_torch.dsp import plan_exec
from opus_tpu_torch.dsp.band_walk import _band_walk_ref, band_walk
from opus_tpu_torch.native.frontend import PLAN_A_MAX

CASES_FILE = pathlib.Path(__file__).parent / "data" / "band_walk_cases.npz"
CASES = ["celt1", "celt2", "celt3", "mixed2", "mixed3"]
KERNEL_TOL = 1e-5
E_BANDS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100]


def _case(name: str) -> tuple[int, list, np.ndarray]:
    """(lm, each step's executor inputs as numpy, the recorded outputs)."""
    with np.load(CASES_FILE, allow_pickle=False) as d:
        steps = list(zip(*[d[f"{name}_{k}"] for k in ("header", "bands", "meta", "arena")]))
        return int(name[-1]), steps, d[f"{name}_out"]


def _walk_inputs(name: str, device) -> list:
    """band_walk's arguments on each step of a recorded case, as the
    executor on `device` calls it."""
    lm, steps, _ = _case(name)
    ex = plan_exec.make_plan_executor(lm, steps[0][0].shape[0], device=device)
    calls = []

    def record(*args):
        calls.append(args)
        return _band_walk_ref(*args)

    real, plan_exec.band_walk = plan_exec.band_walk, record
    try:
        for s in steps:
            ex(*[torch.as_tensor(a, device=device) for a in s])
    finally:
        plan_exec.band_walk = real
    return calls


def _synthetic(seed: int, B: int, lm: int, device="cpu") -> tuple:
    """Valid band_walk arguments at frame size lm: a plane of about unit
    norm a band, random band configs (every transform slot, dual,
    intensity, stereo, inversion bits; invalid configs take the zero slot),
    mono and stereo rows, start band 0 or 17, fold leaves as runs of 1-8
    bins with their run ends, source indices within the band, and up to
    PLAN_A_MAX anti-collapse records (random masks, seeds and f16 gains)."""
    rng = np.random.default_rng(seed)
    m, n = 1 << lm, 120 << lm
    e = np.array(E_BANDS) * m
    x = np.zeros((B, 2, n), np.float32)
    fold = np.zeros((B, 2, n), bool)
    srcw = np.zeros((B, 2, n), np.int64)
    run_lo = np.zeros((B, 2, n), np.int64)
    run_hi = np.zeros((B, 2, n), np.int64)
    for i in range(21):
        lo, hi = e[i], e[i + 1]
        nb = hi - lo
        x[:, :, lo:hi] = rng.standard_normal((B, 2, nb)) / np.sqrt(nb)
        srcw[:, :, lo:hi] = rng.integers(0, 2 * nb, (B, 2, nb))
        for b in range(B):
            for c in range(2):
                q = 0
                while q < nb:
                    r = min(int(rng.integers(1, 9)), nb - q)
                    f = rng.random() < 0.4
                    fold[b, c, lo + q : lo + q + r] = f
                    k = np.arange(q, q + r)
                    run_lo[b, c, lo + q : lo + q + r] = c * nb + (q if f else k)
                    run_hi[b, c, lo + q : lo + q + r] = c * nb + (q + r if f else k + 1)
                    q += r
    x[:, :, e[21]:] = 0.0
    bands = rng.integers(0, 1 << 32, (B, 24), dtype=np.uint64).astype(np.uint32).view(np.int32)
    meta = np.zeros((B, 16), np.int32)
    meta[:, 3] = rng.choice([1, 2], B, p=[0.25, 0.75])
    meta[:, 4] = rng.choice([0, 17], B, p=[0.7, 0.3])
    n_ac = rng.integers(0, PLAN_A_MAX + 1, B)
    n_ac[::4] = 0
    header = np.stack([np.zeros(B, np.int64), n_ac << 18], 1).astype(np.int32)
    ac = np.zeros((B, 2 * PLAN_A_MAX), np.int64)
    for b in range(B):
        slots = rng.permutation(2 * 21)[: n_ac[b]]
        gain = np.float16(rng.uniform(0.01, 0.5, n_ac[b])).view(np.uint16).astype(np.int64)
        mask = rng.integers(0, 1 << m, n_ac[b])
        ac[b, 0::2][: n_ac[b]] = (slots >> 1) | ((slots & 1) << 5) | (mask << 8) | (gain << 16)
        ac[b, 1::2][: n_ac[b]] = rng.integers(0, 1 << 32, n_ac[b])
    fgain = rng.uniform(0.3, 1.0, (B, 2, n)).astype(np.float32)
    dither = np.where(rng.random((B, 2, n)) < 0.5, 1 / 256, -1 / 256).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (
        x.reshape(B, 2 * n), bands, meta, header, ac, fold, srcw, run_lo, run_hi, fgain, dither))


@pytest.mark.parametrize("name", CASES)
def test_plain_version_reproduces_the_executor(name):
    """The executor on the CPU (band_walk -> `_band_walk_ref`) returns the
    recorded outputs bit for bit, and the case reaches what it was
    recorded for."""
    lm, steps, want = _case(name)
    ex = plan_exec.make_plan_executor(lm, steps[0][0].shape[0], device="cpu")
    before = band_walk.launches
    for t, s in enumerate(steps):
        got = ex(*[torch.as_tensor(a) for a in s]).numpy()
        assert np.array_equal(got.view(np.uint32), want[t].view(np.uint32)), t
    assert band_walk.launches == before  # only a kernel launch counts
    header = np.stack([s[0] for s in steps])
    meta = np.stack([s[2] for s in steps])
    assert (meta[..., 3] == 1).any() == (name != "mixed2" and name != "mixed3")
    assert ((header[..., 1] >> 18) > 0).any() == (lm >= 2)
    assert (meta[..., 5] == 13).any()
    assert (meta[..., 4] == 17).any() == name.startswith("mixed")
    assert ((header[..., 1] & 0x3FFFF) == 0).any() == name.startswith("celt")


@pytest.mark.parametrize("lm", [0, 1, 2, 3])
def test_plain_version_on_synthetic_inputs(lm):
    """The synthetic inputs the kernel is held to on the card run through
    the plain version to a finite spectrum, zero above the last band."""
    args = _synthetic(40 + lm, 8, lm)
    out = _band_walk_ref(*args)
    n = 120 << lm
    assert out.shape == (8, 2, n) and bool(torch.isfinite(out).all())
    assert not out[:, :, 100 << lm :].any()


@pytest.mark.parametrize("lm", [0, 1, 2, 3])
def test_transform_terms_rebuild_every_slot(lm):
    """The kernel's packed transform terms (`transform_terms`: each row's
    nonzeros in ascending column order, padded with zero coefficients)
    rebuild every band's forward and undo slot exactly."""
    from opus_tpu_torch.dsp.band_walk import TERMS, _band_stacks, transform_terms

    stacks, _ = _band_stacks(lm)
    w, c, off = transform_terms(stacks)
    for i, pair in enumerate(stacks):
        nb = pair[0].shape[0]
        for d, stack in enumerate(pair):
            for s in range(stack.shape[1] // nb):
                at = off[i, d] + s * TERMS * nb
                ws, cs = (a[at : at + TERMS * nb].reshape(TERMS, nb) for a in (w, c))
                assert ((ws >= 0) & (ws < nb)).all()
                assert ((cs[1:] == 0) | (ws[1:] > ws[:-1])).all()  # ascending nonzeros
                t = np.zeros((nb, nb), np.float32)
                np.add.at(t, (np.broadcast_to(np.arange(nb), ws.shape), ws), cs)
                assert np.array_equal(t.T, stack[:, s * nb : (s + 1) * nb]), (i, d, s)


def test_plain_version_leaves_its_inputs():
    args = _walk_inputs("celt3", "cpu")[1]
    copies = [a.clone() for a in args]
    _band_walk_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(args, copies))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, bands, meta, header, ac, fold, srcw, run_lo, run_hi, fgain, dither = _synthetic(5, 4, 2)
    names = ("x", "bands", "meta", "header", "ac", "fold", "srcw", "run_lo", "run_hi", "fgain",
             "dither")
    good = dict(zip(names, (x, bands, meta, header, ac, fold, srcw, run_lo, run_hi, fgain,
                            dither)))
    meta_dev = torch.empty_like(meta, device="meta")
    for kw in (dict(x=x.double()), dict(x=x[:, :-2].contiguous()), dict(x=x[:2]),
               dict(x=torch.zeros(4, 2 * 100)), dict(bands=bands.long()),
               dict(meta=meta[:, :8].contiguous()), dict(header=header.float()),
               dict(ac=ac.int()), dict(ac=ac.t().contiguous().t()),
               dict(fold=fold.to(torch.uint8)), dict(srcw=srcw.int()),
               dict(run_lo=run_lo.transpose(1, 2).contiguous().transpose(1, 2)),
               dict(run_hi=run_hi[:, :1]), dict(fgain=fgain.half()),
               dict(dither=dither[:2]), dict(meta=meta_dev),
               {k: torch.empty_like(v, device="meta") for k, v in good.items()}):
        with pytest.raises(ValueError):
            band_walk(**dict(good, **kw))


def test_wrapper_takes_strided_anti_collapse_rows():
    """The executor passes its merged window's anti-collapse columns as a
    view: rows at a stride, each row contiguous."""
    args = list(_synthetic(6, 4, 3))
    wide = torch.zeros(4, 100, dtype=torch.int64)
    wide[:, 10 : 10 + 2 * PLAN_A_MAX] = args[4]
    want = band_walk(*args)
    args[4] = wide[:, 10 : 10 + 2 * PLAN_A_MAX]
    assert torch.equal(band_walk(*args), want)


# --- on the card ---------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the band-walk kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(args) -> float:
    want = _band_walk_ref(*args)
    before = band_walk.launches
    got = band_walk(*args)
    torch.cuda.synchronize()
    assert band_walk.launches == before + 1
    assert bool(torch.isfinite(got).all())
    return float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_version_on_recorded_plans(cuda_device, name):
    """On every recorded step, as the executor on the card calls it."""
    errs = [_kernel_vs_plain(args) for args in _walk_inputs(name, cuda_device)]
    assert max(errs) < KERNEL_TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("lm", [0, 1, 2, 3])
def test_kernel_matches_plain_version_on_synthetic_inputs(cuda_device, lm):
    """At every frame size, B=64 rows of random configs and records."""
    assert _kernel_vs_plain(_synthetic(50 + lm, 64, lm, cuda_device)) < KERNEL_TOL


@pytest.mark.cuda
def test_captured_replay_equals_eager_run(cuda_device):
    """The kernel captured in a CUDA graph and replayed gives its eager
    output bit for bit (no atomics, fixed sum orders)."""
    args = _synthetic(60, 64, 3, cuda_device)
    eager = band_walk(*args)
    again = band_walk(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = band_walk(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, again) and torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True])
def test_served_step_launches_the_kernel_once(cuda_device, mixed):
    """Serving chip_smoke.py's traffic at B=64 (CELT plan, or the mixed
    plan path with hybrid rows): `launches.band_walk` in the tracer's
    counters grows by one a step, though most steps are replays, and every
    captured graph holds one launch."""
    import chip_smoke as cs
    from opus_tpu_torch import trace
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.dsp.graphs import CapturedStep

    old, cs.B = cs.B, 64
    try:
        steps = cs.make_payloads()
        if mixed:
            steps = cs.make_mixed_payloads(steps)
            dec = BatchedOpusDecoder(64, 2, transfer="plan", silk_transfer="internal",
                                     device=cuda_device)
        else:
            dec = BatchedCeltDecoder(64, 2, transfer="plan", device=cuda_device)
        before = trace.counters()["launches.band_walk"]
        (cs.serve_mixed_steps if mixed else cs.serve_steps)(dec, steps)
    finally:
        cs.B = old
    graphs = [s for s in dec._steps.values() if isinstance(s, CapturedStep) and s.graph]
    assert dec.plan_fallbacks == 0 and 0 < len(graphs) < len(steps)
    assert trace.counters()["launches.band_walk"] - before == len(steps)
    assert all(g.launches.get(band_walk) == 1 for g in graphs)
