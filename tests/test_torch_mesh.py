"""The port's multi-rank serving (opus_tpu_torch.mesh, batch/sharded.py,
dryrun.py) against its unsharded decoders, the JAX package's mesh and
scalar decoder, and libopus, on the CPU under gloo.

Each world (2 and 4 ranks) is spawned once for the module: the
`sharded` fixture runs every scenario on its ranks and returns rank 0's
gathered arrays, which the tests hold to the references:

* raw step (tests/test_mesh_serve.py:27): B=16, 4 frames of 96 kbps CELT,
  q14 plane A and the raw synthesis step;
* mixed plan serve (:87): B=8, CELT / SILK / hybrid / a mode switch, one
  loss, state seeded per rank from the rows of a JAX SynthState;
* multistream regroup: 8 sessions of the 8-channel layout of
  tests/data/multistream_traffic.npz, whole sessions a rank;
* plan overflow (tests/test_mixed_plan.py:206): rank 0 carries 320 kbps
  CELT members, whose plan overflows every step, the other ranks 96 kbps.

Sharded vs unsharded is held to 1e-5, the reference's own allowance
(tests/test_mesh_serve.py:81,190): a matmul at another row count may sum
in another order.  The rank bodies live here; this module imports jax,
libopus and the reference only inside functions, so that a rank, which
imports it to find its body, stays free of them.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import pytest
import torch

from opus_tpu_torch.mesh import GridSpec, ShardSpec, card_backend, init_ranks, run_ranks

F = 960
PCM_TOL = 1e-5  # sharded vs unsharded, and the port vs the JAX mesh step
SCALAR_TOL = 2e-3  # vs libopus or the scalar decoder (transfer precision)
OVERFLOW_TOL = 3e-3  # tests/test_mixed_plan.py:206: q14/p10 on dense content
CLEAN_TOL = 1e-3  # tests/test_mixed_plan.py:56, 96 kbps members
RAW_B, RAW_NF = 16, 4
MIXED_KINDS = ["celt", "silk", "hybrid", "celt", "silk", "hybrid", "celt", "switch"]
MIXED_NF, MIXED_LOST = 4, {(2, 1)}
MS_SESSIONS = 8
OVERFLOW_KINDS, OVERFLOW_NF = ["celt", "silk", "hybrid", "celt"], 6
WORLDS = [2, 4]
FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "multistream_traffic.npz"


# --- the ranks' body (jax-free) ---------------------------------------------


def _rank_scenarios(rank: int, world: int, dev, inputs: dict) -> dict | None:
    """Every scenario on this rank's rows; rank 0 returns the gathered
    outputs."""
    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.batch.sharded import (
        gather_fallbacks,
        gather_final_ranges,
        gather_ring,
        gather_sessions,
    )
    from opus_tpu_torch.mesh import all_gather_rows
    from opus_tpu_torch.state import synth_state_from_numpy

    out = {}
    raw = inputs["raw"]
    spec = ShardSpec(RAW_B, world, rank)
    dec = BatchedCeltDecoder(spec.local, 2, transfer="q14", device=dev)
    dec.state = synth_state_from_numpy(spec.rows(raw["mem"]), spec.rows(raw["preemph"]), dev)
    out["raw"] = np.concatenate(
        [all_gather_rows(dec.decode_frames_on_device(spec.rows([p] * RAW_B), F)).numpy()
         for p in raw["payloads"]], axis=1)

    mixed = inputs["mixed"]
    spec = ShardSpec(len(mixed["steps"][0]), world, rank)
    dec = BatchedOpusDecoder(spec.local, 2, transfer="plan", device=dev)
    dec._serve_state = synth_state_from_numpy(spec.rows(mixed["mem"]),
                                              spec.rows(mixed["preemph"]), dev)
    dec._serve_plc_lpc = torch.tensor(spec.rows(mixed["plc_lpc"]), device=dev)
    dec._serve_plc_pitch = torch.tensor(spec.rows(mixed["plc_pitch"]), device=dev)
    rings = []
    for packets in mixed["steps"]:
        dec.serve([spec.rows(packets)])
        rings.append(gather_ring(dec).numpy())
    out["mixed"] = {"rings": np.stack(rings), "ranges": gather_final_ranges(dec),
                    "fallbacks": gather_fallbacks(dec)}

    (ch, streams, coupled, *mapping), steps = inputs["ms"]
    spec = ShardSpec(len(steps[0]), world, rank)
    dec = BatchedMultistreamDecoder(spec.local, ch, streams, coupled, mapping, mode="celt",
                                    device=dev)
    dec.core.transfer = "plan"
    frames, ranges = [], []
    for packets in steps:
        local = dec.serve([spec.rows(packets)], F)
        got = gather_sessions(dec)
        if not np.array_equal(got[spec.start : spec.stop].numpy(), local):
            raise AssertionError("gather_sessions does not hold the rank's own un-mapped frames")
        frames.append(got.numpy())
        ranges.append(gather_final_ranges(dec))
    out["ms"] = {"frames": np.stack(frames), "ranges": ranges,
                 "fallbacks": gather_fallbacks(dec.core)}

    steps = inputs["overflow"][world]
    spec = ShardSpec(len(steps[0]), world, rank)
    dec = BatchedOpusDecoder(spec.local, 2, transfer="plan", device=dev)
    rings = []
    for packets in steps:
        dec.serve([spec.rows(packets)])
        rings.append(gather_ring(dec).numpy())
    out["overflow"] = {"rings": np.stack(rings), "ranges": gather_final_ranges(dec),
                       "fallbacks": gather_fallbacks(dec)}
    return out if rank == 0 else None


def _rank_fails(rank: int, world: int, dev) -> None:
    if rank == world - 1:
        raise ValueError(f"rank {rank} gives up")
    torch.distributed.barrier()  # the others wait for it in a collective


def _rank_hangs(rank: int, world: int, dev) -> None:
    import time

    time.sleep(600)


def _rank_report(rank: int, world: int, dev) -> tuple:
    from opus_tpu_torch.mesh import all_gather_rows, gather_ints

    rows = all_gather_rows(torch.full((2, 3), float(rank)))
    return rank, str(dev), torch.get_num_threads(), rows.numpy(), gather_ints([rank] * rank)


def _rank_grid(rank: int, world: int, dev) -> tuple:
    """A 2 x 2 grid's gathers of a [2, 3, 1] block filled with the rank."""
    from opus_tpu_torch.mesh import (all_gather_channels, all_gather_rows, gather_ints,
                                     grid_groups, replicas_equal)

    dp_group, tp_group = grid_groups(2, 2)
    t = torch.full((2, 3, 1), float(rank))
    return (all_gather_channels(t, tp_group).numpy(), all_gather_rows(t, dp_group).numpy(),
            gather_ints([rank], dp_group), replicas_equal(t, tp_group),
            replicas_equal(torch.zeros(2), tp_group))


# --- traffic and references (the parent: libopus and the reference) --------


def _oracle():
    from opus_tpu import oracle

    if not oracle.available():
        pytest.skip("libopus not present")
    return oracle


def _encoder(kind: str, kbps: int | None = None):
    oracle = _oracle()
    ch, mode, rate = {"celt": (2, oracle.MODE_CELT_ONLY, 96),
                      "silk": (1, oracle.MODE_SILK_ONLY, 24),
                      "hybrid": (2, oracle.MODE_HYBRID, 64)}[kind]
    e = oracle.Encoder(48000, ch)
    e.ctl(oracle.SET_FORCE_MODE, mode)
    e.ctl(oracle.SET_BITRATE, (kbps or rate) * 1000)
    if kind == "silk":
        e.ctl(oracle.SET_MAX_BANDWIDTH, 1103)
    return e


def _signals(nf: int, seed: int):
    """voice (mono), its stereo v2 and music m2, as the reference's tests."""
    rng = np.random.default_rng(seed)
    t = np.arange(F * nf) / 48000.0
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    music = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1763 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    v2 = np.stack([voice, np.roll(voice, 13) * 0.7], -1).astype(np.float32)
    m2 = np.stack([music, np.roll(music, 7) * 0.8], -1).astype(np.float32)
    return voice, v2, m2


def _encode(enc, src, nf: int) -> list[bytes]:
    return [enc.encode_float(np.ascontiguousarray(src[f * F : (f + 1) * F]).ravel(), F)
            for f in range(nf)]


def _raw_traffic():
    """tests/test_mesh_serve.py:27's packets: CELT-only 96 kbps, a tone
    and noise, 4 frames; (packets, payloads)."""
    from opus_tpu import parse_packet

    enc = _encoder("celt")
    rng = np.random.default_rng(5)
    t = np.arange(F * RAW_NF) / 48000.0
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(t.size)
    pcm = np.stack([sig, 0.8 * np.roll(sig, 7)], -1).astype(np.float32)
    pkts = _encode(enc, pcm, RAW_NF)
    return pkts, [p[parse_packet(p).payload_offset :] for p in pkts]


def _mixed_traffic() -> list[list]:
    """tests/test_mesh_serve.py:87's steps[frame][stream]: the kinds of
    :131 (stereo encoders), stream 7 CELT for two frames then SILK, stream
    1 losing frame 2."""
    oracle = _oracle()
    rng = np.random.default_rng(11)
    t = np.arange(F * MIXED_NF) / 48000.0
    ph = np.cumsum(2 * np.pi * (130 + 25 * np.sin(2 * np.pi * 2.5 * t)) / 48000.0)
    voice = (0.35 * np.sign(np.sin(ph)) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    music = (0.4 * np.sin(2 * np.pi * 440 * t)
             + 0.2 * np.sin(2 * np.pi * 1763 * t)).astype(np.float32)
    v2 = np.stack([voice, np.roll(voice, 13) * 0.7], -1).astype(np.float32)
    m2 = np.stack([music, np.roll(music, 7) * 0.8], -1).astype(np.float32)
    pks = {}
    for kind, mode, kbps, src in (("celt", oracle.MODE_CELT_ONLY, 96, m2),
                                  ("silk", oracle.MODE_SILK_ONLY, 24, v2),
                                  ("hybrid", oracle.MODE_HYBRID, 64, v2)):
        enc = oracle.Encoder(48000, 2)
        enc.ctl(oracle.SET_FORCE_MODE, mode)
        enc.ctl(oracle.SET_BITRATE, kbps * 1000)
        pks[kind] = _encode(enc, src, MIXED_NF)
    sw = oracle.Encoder(48000, 2)
    sw.ctl(oracle.SET_BITRATE, 64000)
    pks["switch"] = []
    for f in range(MIXED_NF):
        mode = oracle.MODE_CELT_ONLY if f < 2 else oracle.MODE_SILK_ONLY
        sw.ctl(oracle.SET_FORCE_MODE, mode)
        src = m2 if mode == oracle.MODE_CELT_ONLY else v2
        pks["switch"].append(
            sw.encode_float(np.ascontiguousarray(src[f * F : (f + 1) * F]).ravel(), F))
    return [[None if (f, b) in MIXED_LOST else pks[k][f] for b, k in enumerate(MIXED_KINDS)]
            for f in range(MIXED_NF)]


def _overflow_packets() -> dict:
    """tests/test_mixed_plan.py:206's members: kind -> packets, CELT at
    320 kbps ("dense") and at 96 kbps ("celt")."""
    voice, v2, m2 = _signals(OVERFLOW_NF, 5)
    return {"dense": _encode(_encoder("celt", 320), m2, OVERFLOW_NF),
            "celt": _encode(_encoder("celt"), m2, OVERFLOW_NF),
            "silk": _encode(_encoder("silk"), voice, OVERFLOW_NF),
            "hybrid": _encode(_encoder("hybrid"), v2, OVERFLOW_NF)}


def _overflow_steps(pks: dict, world: int, dense_ranks=(0,)) -> list[list]:
    """OVERFLOW_KINDS on each rank's 4 rows; the CELT members of the ranks
    in dense_ranks at 320 kbps."""
    kinds = [("dense" if k == "celt" and r in dense_ranks else k)
             for r in range(world) for k in OVERFLOW_KINDS]
    return [[pks[k][f] for k in kinds] for f in range(OVERFLOW_NF)]


def _ms_traffic():
    """(layout, steps[packet][session], libopus ranges[packet][session]):
    the 8-channel group of the fixture."""
    data = np.load(FIXTURE, allow_pickle=False)
    blob, lengths = data["ambi_packets"].tobytes(), data["ambi_lengths"]
    ends = np.cumsum(lengths.ravel())
    flat = [blob[e - n : e] for e, n in zip(ends, lengths.ravel())]
    k, n_p = lengths.shape
    steps = [[flat[(i % k) * n_p + p] for i in range(MS_SESSIONS)] for p in range(n_p)]
    ranges = [[int(data["ambi_ranges"][i % k, p]) for i in range(MS_SESSIONS)]
              for p in range(n_p)]
    return data["ambi_layout"].tolist(), steps, ranges


def _scalar(steps: list, cache: dict) -> list[np.ndarray]:
    """The JAX package's scalar Decoder over each stream's packets:
    refs[stream] [frames, F, 2] (one decode a distinct packet sequence)."""
    from opus_tpu import Decoder

    refs = []
    for b in range(len(steps[0])):
        seq = tuple(step[b] for step in steps)
        if seq not in cache:
            d = Decoder()
            cache[seq] = np.stack([np.asarray(d.decode_float(p, F)).reshape(F, 2) for p in seq])
        refs.append(cache[seq])
    return refs


def _serve_rings(dec, steps: list) -> np.ndarray:
    rings = []
    for packets in steps:
        dec.serve([packets])
        rings.append(dec._serve_ring.numpy().copy())
    return np.stack(rings)


def _opus(batch: int):
    from opus_tpu_torch.batch.opus_pipeline import BatchedOpusDecoder

    return BatchedOpusDecoder(batch, 2, transfer="plan", device="cpu")


@pytest.fixture(scope="module")
def traffic():
    """Every scenario's inputs, made once: packets (libopus), the JAX
    states the ranks seed from, and the multistream fixture."""
    from opus_tpu.dsp.plc_exec import LPC_ORDER
    from opus_tpu.dsp.synthesis import init_state
    from opus_tpu_torch.native import build

    _oracle()
    build.build()  # once here, not in every rank
    raw_st, mixed_st = init_state(RAW_B, 2), init_state(len(MIXED_KINDS), 2)
    pkts, payloads = _raw_traffic()
    ovf = _overflow_packets()
    return {
        "raw": {"packets": pkts, "payloads": payloads, "mem": np.asarray(raw_st.mem),
                "preemph": np.asarray(raw_st.preemph)},
        "mixed": {"steps": _mixed_traffic(), "mem": np.asarray(mixed_st.mem),
                  "preemph": np.asarray(mixed_st.preemph),
                  "plc_lpc": np.zeros((len(MIXED_KINDS), 2, LPC_ORDER), np.float32),
                  "plc_pitch": np.full(len(MIXED_KINDS), 15, np.int32)},
        "ms": _ms_traffic(),
        "overflow_packets": ovf,
        "overflow": {w: _overflow_steps(ovf, w) for w in WORLDS},
        "scalar_cache": {},
    }


@pytest.fixture(scope="module", params=WORLDS)
def sharded(request, traffic):
    """(world, rank 0's gathered outputs) of one spawned world of gloo ranks."""
    world = request.param
    inputs = {k: traffic[k] for k in ("raw", "mixed", "overflow")}
    inputs["ms"] = traffic["ms"][:2]
    out = run_ranks(_rank_scenarios, world, device="cpu", args=(inputs,),
                    deadline_s=240)[0]
    return world, out


# --- the mesh plumbing --------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("batch", [8, 16])
def test_shard_spec_matches_dp_placement(batch, world):
    """A rank's rows are the block JAX places on mesh device `rank` under
    NamedSharding(mesh, P("dp")) (conftest forces 8 CPU devices)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = jax.devices("cpu")[:world]
    placed = NamedSharding(Mesh(np.array(devices), ("dp",)), P("dp")).devices_indices_map(
        (batch,))
    for rank, d in enumerate(devices):
        spec = ShardSpec(batch, world, rank)
        rows = range(batch)[placed[d][0]]
        assert (spec.start, spec.stop) == (rows.start, rows.stop)
        assert spec.rows(list(range(batch))) == list(rows)


@pytest.mark.parametrize("dp, tp", [(1, 2), (2, 2), (4, 2)])
@pytest.mark.parametrize("batch", [8, 16])
def test_grid_spec_matches_dp_tp_placement(batch, dp, tp):
    """A rank's block is the one JAX places on device `rank` of
    Mesh(devices.reshape(dp, tp)) under NamedSharding(mesh, P("dp", "tp",
    None)) (__graft_entry__.py:182,193): rows, channels and the last axis
    whole, for every rank of the grid."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    channels, width = 2, 5
    devices = np.array(jax.devices("cpu")[: dp * tp]).reshape(dp, tp)
    placed = NamedSharding(Mesh(devices, ("dp", "tp")), P("dp", "tp", None)).devices_indices_map(
        (batch, channels, width))
    whole = np.arange(batch * channels * width).reshape(batch, channels, width)
    for rank, d in enumerate(devices.flat):
        grid = GridSpec(batch, channels, dp, tp, rank)
        assert grid.coords == divmod(rank, tp)
        assert np.array_equal(grid.block(whole), whole[placed[d]])
        assert np.array_equal(grid.block(torch.as_tensor(whole)).numpy(), whole[placed[d]])
        rows = range(batch)[placed[d][0]]
        assert grid.dp_spec.rows(list(range(batch))) == list(rows)


def test_grid_spec_rejects_uneven_and_foreign_blocks():
    with pytest.raises(ValueError, match="evenly over dp"):
        GridSpec(10, 2, 4, 2, 0)
    with pytest.raises(ValueError, match="evenly over tp"):
        GridSpec(8, 3, 2, 2, 0)
    with pytest.raises(ValueError, match="not in a grid"):
        GridSpec(8, 2, 2, 2, 4)
    with pytest.raises(ValueError, match="is not"):
        GridSpec(8, 2, 2, 2, 1).block(np.zeros((8, 1, 4)))


def test_ranks_share_a_card_only_when_asked():
    """NCCL with one rank a card; gloo when the caller puts several ranks
    on one card; gloo on the CPU, where ranks_per_card must be 1."""
    assert card_backend("cuda", 1) == "nccl"
    assert card_backend("cuda", 2) == card_backend("cuda", 4) == "gloo"
    assert card_backend("cpu", 1) == "gloo"
    for device, k in (("cpu", 2), ("cuda", 0)):
        with pytest.raises(ValueError, match="ranks a card"):
            card_backend(device, k)
    with pytest.raises(ValueError, match="ranks a card"):
        run_ranks(_rank_report, 2, device="cpu", ranks_per_card=2)


def test_grid_groups_gather_in_grid_order():
    """On a 2 x 2 grid of gloo ranks the tp group joins channels in t order
    and the dp group rows in d order; replicas_equal tells replicas from
    different blocks."""
    out = run_ranks(_rank_grid, 4, device="cpu", deadline_s=120)
    for rank, (channels, rows, ints, differ, same) in enumerate(out):
        d, t = divmod(rank, 2)
        np.testing.assert_array_equal(channels[0, 0], [2 * d, 2 * d + 1])
        np.testing.assert_array_equal(rows[:, 0, 0], [t, t, t + 2, t + 2])
        assert ints == [t, t + 2] and not differ and same


def test_uncounted_restores_every_launch_count():
    """The dry run's unsharded references and timing repeats run inside
    `uncounted`: the launch counts read after the block are those before
    it, for every kernel wrapper, also when the block raises."""
    from opus_tpu_torch.dryrun import kernel_wrappers, uncounted

    counters = kernel_wrappers()
    saved = {k: fn.launches for k, fn in counters.items()}
    try:
        for i, fn in enumerate(counters.values()):
            fn.launches = i
        with pytest.raises(RuntimeError), uncounted():
            for fn in counters.values():
                fn.launches += 7
            raise RuntimeError
        assert [fn.launches for fn in counters.values()] == list(range(len(counters)))
        assert set(counters) == {"postfilter", "rotation", "pitch_track", "lpc_synth",
                                 "silk_synth", "pvq_search"}
    finally:
        for k, fn in counters.items():
            fn.launches = saved[k]


@pytest.mark.parametrize("lm", [0, 3])
def test_channel_split_synthesis_matches_jax_stereo(lm):
    """The tp split of the CELT synthesis step with no ranks: two
    channels=1 steps of the port, one a channel, interleaved, within 1e-5
    of the JAX stereo make_synthesis_step on the same seeded inputs (B=8,
    long blocks, post-filter active, a random decode history)."""
    import jax.numpy as jnp

    from opus_tpu.dsp import synthesis as S
    from opus_tpu_torch.dryrun import _example_args
    from opus_tpu_torch.dsp.synthesis import DECODE_BUFFER_SIZE, OVERLAP, make_synthesis_step
    from opus_tpu_torch.state import synth_state_from_numpy

    batch = 8
    args = _example_args(batch, lm, 2)
    rng = np.random.default_rng(5)
    mem = (rng.standard_normal((batch, 2, DECODE_BUFFER_SIZE + OVERLAP)) * 100).astype(np.float32)
    pre = (rng.standard_normal((batch, 2)) * 10).astype(np.float32)
    step = make_synthesis_step(lm, False, 1, 1, device="cpu")
    halves = []
    for c in range(2):
        st = synth_state_from_numpy(mem[:, c : c + 1], pre[:, c : c + 1], "cpu")
        x, loge, *rest = args
        halves.append(step(st, torch.as_tensor(x[:, c : c + 1]),
                           torch.as_tensor(loge[:, c : c + 1]),
                           *map(torch.as_tensor, rest))[1].numpy())
    got = np.concatenate(halves, axis=-1)
    jstep = S.make_synthesis_step(lm, False, 2, 1)
    want = np.asarray(jstep(S.SynthState(jnp.asarray(mem), jnp.asarray(pre)),
                            *map(jnp.asarray, args))[1])
    assert got.shape == want.shape == (batch, 120 << lm, 2)
    assert float(np.abs(got - want).max()) < PCM_TOL


def test_shard_spec_rejects_uneven_and_foreign_rows():
    with pytest.raises(ValueError, match="evenly"):
        ShardSpec(10, 4, 0)
    with pytest.raises(ValueError, match="not in a world"):
        ShardSpec(8, 2, 2)
    with pytest.raises(ValueError, match="rows for a batch"):
        ShardSpec(8, 2, 1).rows(list(range(6)))


def test_init_ranks_serves_only_cuda_and_the_cpu():
    """NCCL serves "cuda" and gloo "cpu"; any other device raises before
    the group is touched."""
    for device in ("mps", "cuda:0", "meta"):
        with pytest.raises(ValueError, match="no backend serves"):
            init_ranks(2, 0, init_method="file:///nonexistent", device=device)
    assert not torch.distributed.is_initialized()


def test_run_ranks_gathers_in_rank_order():
    """Results come back by rank; all_gather_rows and gather_ints
    concatenate in rank order; a CPU rank runs one torch thread."""
    out = run_ranks(_rank_report, 3, device="cpu", deadline_s=120)
    want_rows = np.repeat(np.arange(3, dtype=np.float32), 2)[:, None] * np.ones(3, np.float32)
    for rank, (r, dev, threads, rows, ints) in enumerate(out):
        assert (r, dev, threads) == (rank, "cpu", 1)
        np.testing.assert_array_equal(rows, want_rows)
        assert ints == [1, 2, 2]


def test_run_ranks_raises_the_failing_rank_and_kills_the_rest():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 failed.*rank 1 gives up"):
        run_ranks(_rank_fails, 2, device="cpu", deadline_s=120)


def test_run_ranks_kills_ranks_past_the_deadline():
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_ranks(_rank_hangs, 2, device="cpu", deadline_s=5)
    assert time.monotonic() - t0 < 60


def _children() -> set[tuple[int, str]]:
    """(pid, command) of this process's children, zombies included."""
    me, out = str(os.getpid()), set()
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:  # ended while listed
            continue
        if text[text.rindex(")") + 2:].split()[1] == me:
            out.add((int(stat.parent.name), text[text.index("(") + 1:text.rindex(")")]))
    return out


@pytest.mark.parametrize("fn, raises", [(_rank_report, None), (_rank_fails, RuntimeError)],
                         ids=["ok", "fails"])
def test_run_ranks_leaves_no_process(fn, raises):
    """Every process run_ranks started has ended and been reaped when it
    returns or raises: the ranks and the resource tracker that spawning
    starts."""
    before = _children()
    if raises is None:
        run_ranks(fn, 2, device="cpu", deadline_s=120)
    else:
        with pytest.raises(raises):
            run_ranks(fn, 2, device="cpu", deadline_s=120)
    assert _children() - before == set()


# --- the sharded serving paths -----------------------------------------------


@pytest.fixture(scope="module")
def raw_refs(traffic):
    """The raw step's references: the unsharded port, the JAX step on the
    8-device CPU mesh (tests/test_mesh_serve.py:27) and libopus."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from opus_tpu import oracle
    from opus_tpu.batch.pipeline import BatchedCeltDecoder as JaxDecoder
    from opus_tpu.dsp.synthesis import SynthState, init_state
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    raw = traffic["raw"]
    port = BatchedCeltDecoder(RAW_B, 2, transfer="q14", device="cpu")
    unsharded = np.concatenate([port.decode_frames([p] * RAW_B, F) for p in raw["payloads"]], 1)

    mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("dp",))

    def shard_rows(a):
        return jax.device_put(jnp.asarray(a),
                              NamedSharding(mesh, P(*("dp",) + (None,) * (np.ndim(a) - 1))))

    front = JaxDecoder(RAW_B, 2, transfer="q14")
    st = init_state(RAW_B, 2)
    st = SynthState(shard_rows(st.mem), shard_rows(st.preemph))
    outs = []
    for p in raw["payloads"]:
        lm, short_mask, args = front._raw_args(F, [p] * RAW_B)
        step = front._pipe_step_fn(lm, bool(short_mask[0]))
        with mesh:
            st, pcm = step(st, *[shard_rows(a) for a in args])
        outs.append(np.asarray(pcm))

    dref = oracle.Decoder(48000, 2)
    libopus = np.concatenate([np.asarray(dref.decode_float(p, F)).reshape(F, 2)
                              for p in raw["packets"]])
    return unsharded, np.concatenate(outs, 1), libopus


def test_sharded_raw_step_matches_jax_mesh(sharded, raw_refs):
    """tests/test_mesh_serve.py:27 through the ranks: the gathered PCM
    within 1e-5 of the unsharded port and of the JAX step on the 8-device
    CPU mesh, and within 2e-3 of libopus."""
    world, out = sharded
    unsharded, jax_mesh, libopus = raw_refs
    got = out["raw"]
    assert got.shape == (RAW_B, RAW_NF * F, 2)
    np.testing.assert_allclose(got, unsharded, rtol=0, atol=PCM_TOL)
    np.testing.assert_allclose(got, jax_mesh, rtol=0, atol=PCM_TOL)
    assert float(np.abs(got - libopus[None]).max()) < SCALAR_TOL


def test_sharded_mixed_plan_serve(sharded, traffic):
    """tests/test_mesh_serve.py:87 through the ranks: every step within
    1e-5 of the unsharded port, final ranges equal, no fallback, and the
    JAX scalar Decoder's gates (:187-198)."""
    world, out = sharded
    steps = traffic["mixed"]["steps"]
    got = out["mixed"]
    whole = _opus(len(MIXED_KINDS))
    np.testing.assert_allclose(got["rings"], _serve_rings(whole, steps), rtol=0, atol=PCM_TOL)
    assert got["ranges"] == whole.final_ranges()
    assert got["fallbacks"] == [0] * world

    refs = _scalar(steps, traffic["scalar_cache"])
    for f in range(MIXED_NF):
        for b in range(len(MIXED_KINDS)):
            err = float(np.abs(got["rings"][f, b] - refs[b][f]).max())
            tail = float(np.abs(got["rings"][f, b, 240:] - refs[b][f][240:]).max())
            if b == 7 and f in (2, 3):  # at and after the switch
                assert tail < SCALAR_TOL and err < 0.5, (f, b, err, tail)
            else:
                assert err < SCALAR_TOL, (f, b, err)


def test_sharded_multistream_regroup(sharded, traffic):
    """Whole sessions a rank, un-mapped locally, gathered: within 1e-5 of
    the unsharded BatchedMultistreamDecoder, and every session's final
    range equal to libopus's after every packet."""
    from opus_tpu_torch.batch.multistream_pipeline import BatchedMultistreamDecoder

    world, out = sharded
    (ch, streams, coupled, *mapping), steps, ranges = traffic["ms"]
    got = out["ms"]
    whole = BatchedMultistreamDecoder(MS_SESSIONS, ch, streams, coupled, mapping, mode="celt",
                                      device="cpu")
    whole.core.transfer = "plan"
    want = np.stack([whole.serve([packets], F) for packets in steps])
    assert got["frames"].shape == (len(steps), MS_SESSIONS, F, ch)
    np.testing.assert_allclose(got["frames"], want, rtol=0, atol=PCM_TOL)
    assert got["ranges"] == ranges
    assert got["fallbacks"] == [0] * world


def test_sharded_plan_overflow_stays_on_its_rank(sharded, traffic):
    """The genuine overflow on one rank: rank 0's 320 kbps members
    overflow its plan arena every step and fall back, within 3e-3 of the
    scalar decoder and 1e-5 of the unsharded run, which falls back too;
    the other ranks' 96 kbps rows stay on the plan path (0 fallbacks),
    within 1e-5 of an unsharded run of 96 kbps traffic alone."""
    world, out = sharded
    steps = traffic["overflow"][world]
    got = out["overflow"]
    assert got["fallbacks"][0] >= 1 and got["fallbacks"][1:] == [0] * (world - 1)

    mixed = _opus(4 * world)
    want = _serve_rings(mixed, steps)
    assert mixed.plan_fallbacks == OVERFLOW_NF  # the dense rows overflow the whole pool too
    np.testing.assert_allclose(got["rings"][:, :4], want[:, :4], rtol=0, atol=PCM_TOL)
    assert got["ranges"] == mixed.final_ranges()

    clean_steps = _overflow_steps(traffic["overflow_packets"], world, dense_ranks=())
    clean = _opus(4 * world)
    want = _serve_rings(clean, clean_steps)
    assert clean.plan_fallbacks == 0
    np.testing.assert_allclose(got["rings"][:, 4:], want[:, 4:], rtol=0, atol=PCM_TOL)

    refs = _scalar(steps, traffic["scalar_cache"])
    for b in range(4 * world):
        err = float(np.abs(got["rings"][:, b] - refs[b]).max())
        assert err < (OVERFLOW_TOL if b < 4 else CLEAN_TOL), (b, err)


@pytest.mark.parametrize("decoder", ["opus", "celt"])
def test_plan_overflow_gate(decoder, traffic):
    """tests/test_mixed_plan.py:206 on one decoder: 320 kbps CELT members
    overflow the plan every step, plane A restores every stream's state
    before the packed re-decode, and each frame is within 3e-3 of the
    scalar decoder."""
    from opus_tpu import parse_packet
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder

    pks = traffic["overflow_packets"]
    if decoder == "opus":
        steps = [[pks["dense" if k == "celt" else k][f] for k in OVERFLOW_KINDS]
                 for f in range(OVERFLOW_NF)]
        dec = _opus(len(OVERFLOW_KINDS))
        got = _serve_rings(dec, steps)
    else:
        steps = [[pks["dense"][f]] * 2 for f in range(OVERFLOW_NF)]
        dec = BatchedCeltDecoder(2, 2, transfer="plan", device="cpu")
        got = []
        for packets in steps:
            dec.serve([[p[parse_packet(p).payload_offset :] for p in packets]], F)
            got.append(dec._serve_ring.numpy().copy())
        got = np.stack(got)
    assert dec.plan_fallbacks >= 1
    refs = _scalar(steps, traffic["scalar_cache"])
    for b in range(len(steps[0])):
        err = float(np.abs(got[:, b] - refs[b]).max())
        assert err < OVERFLOW_TOL, (b, err)


@pytest.mark.parametrize("world", WORLDS)
def test_torch_dryrun_multichip(world, traffic):
    """tests/test_mesh_serve.py:201 and tests/test_dsp.py:90: the port's
    dry run lays `world` gloo ranks out as the reference's mesh (dp=1 x
    tp=2 at 2, dp=2 x tp=2 at 4) with the reference's shapes (a CELT batch
    of 8 dp, a rank's block [8, 120, 1], regrouped frames (2 dp, 120, 8)),
    passes its own gates, and every stream of its mixed phase has its
    tail (from sample 240 on) within 2e-3 of the JAX scalar Decoder."""
    from opus_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(world, device="cpu")
    dp = world // 2
    assert (out["world"], out["dp"], out["tp"], out["backend"]) == (world, dp, 2, "gloo")
    syn = out["synthetic"]
    assert syn["celt_batch"] == 8 * dp and syn["pcm_shape"] == (8 * dp, 120, 2)
    assert syn["local_pcm_shape"] == (8, 120, 1)
    assert syn["regrouped_shape"] == (2 * dp, 120, 8)
    assert syn["silk_rows"] == 2 * dp
    assert len(out["ranks"]) == world
    mixed = out["mixed"]
    assert mixed["streams"] == 4 * dp
    assert mixed["plan_fallbacks"] == [0] * dp
    refs = _scalar(mixed["steps"], traffic["scalar_cache"])
    for b, ref in enumerate(refs):
        for f, ring in enumerate(mixed["rings"]):
            tail = float(np.abs(ring[b, 240:] - ref[f][240:]).max())
            assert tail < SCALAR_TOL, (b, f, tail)


# --- on the card ----------------------------------------------------------------


def _rank_plan_card(rank: int, world: int, dev, batches: list) -> dict | None:
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.batch.sharded import gather_fallbacks, gather_final_ranges, gather_ring

    spec = ShardSpec(len(batches[0]), world, rank)
    dec = BatchedCeltDecoder(spec.local, 2, transfer="plan", device=dev)
    dec.serve([spec.rows(pk) for pk in batches], F)
    out = {"ring": gather_ring(dec).cpu().numpy(), "ranges": gather_final_ranges(dec),
           "fallbacks": gather_fallbacks(dec)}
    return out if rank == 0 else None


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_sharded_plan_on_card():
    """world = every card, NCCL: the plan path at B=64 (the port's native
    encoder at 96 kbps) within 1e-5 of the unsharded decoder on cuda:0,
    equal final ranges, no fallback."""
    from opus_tpu_torch.batch.pipeline import BatchedCeltDecoder
    from opus_tpu_torch.native.frontend import NativeCeltEncoderBatch

    B, nf = 64, 6
    world = torch.cuda.device_count()
    while B % world:
        world -= 1
    rng = np.random.default_rng(2)
    enc = NativeCeltEncoderBatch(B, 2)
    f0 = 220.0 * 2.0 ** ((np.arange(B) % 24) / 12.0)
    batches = []
    for f in range(nf):
        t = (f * F + np.arange(F)) / 48000.0
        sig = 0.4 * np.sin(2 * np.pi * f0[:, None] * t) + 0.05 * rng.standard_normal((B, F))
        pcm = np.stack([sig, 0.8 * np.roll(sig, 7, axis=1)], -1).astype(np.float32)
        batches.append([bytes(p) for p in enc.encode_batch(pcm, 240)])
    whole = BatchedCeltDecoder(B, 2, transfer="plan", device="cuda")
    whole.serve(batches, F)
    out = run_ranks(_rank_plan_card, world, device="cuda", args=(batches,),
                    deadline_s=300)[0]
    np.testing.assert_allclose(out["ring"], whole._serve_ring.cpu().numpy(), rtol=0,
                               atol=PCM_TOL)
    assert out["ranges"] == whole.final_ranges()
    assert out["fallbacks"] == [0] * world and whole.plan_fallbacks == 0


@pytest.mark.cuda
def test_grid_dryrun_on_one_card():
    """The dry run's dp=1 x tp=2 grid as two gloo ranks sharing cuda:0:
    every gate of its phases, the reference's shapes, the post-filter and
    rotation kernels launched on both ranks, a warm step timed on each."""
    from opus_tpu_torch.dryrun import dryrun_multichip

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks share cuda:0")

    out = dryrun_multichip(2, device="cuda", ranks_per_card=2)
    assert (out["dp"], out["tp"], out["backend"]) == (1, 2, "gloo")
    assert out["synthetic"]["regrouped_shape"] == (2, 120, 8)
    for rank in out["ranks"]:
        assert rank["device"] == "cuda:0"
        assert rank["launches"]["postfilter"] > 0 and rank["launches"]["rotation"] > 0
        assert rank["celt_step_ms"] > 0
