"""The CELT plan decode over host threads, on the CPU.

NativeBatchFrontEnd splits a plan decode into `shards` contiguous blocks
of streams, each in its own copy of the native library on its own
thread, and merges their arenas.  Whatever S is, the slot, the iy spans,
the final ranges and the streams' states must be those of one call over
every stream, and a failed step must leave every state as it was.  The
tests set S through the module's own seams (plan_shards, the usable core
count, the OpenMP test), as no host setting reaches it.
"""

import ctypes
import os
import sys
import threading

import numpy as np
import pytest

from opus_tpu_torch import trace
from opus_tpu_torch.native import frontend as fe

pytestmark = pytest.mark.skipif(not fe.available(), reason="native engine not built")

FRAME = 960


def _front_end(monkeypatch, B: int, S: int) -> fe.NativeBatchFrontEnd:
    """A front end of B stereo streams whose plan decode runs on S shards."""
    with monkeypatch.context() as m:
        m.setattr(fe, "plan_shards", lambda batch: S)
        front = fe.NativeBatchFrontEnd(B, 2)
    assert front.shards == S
    return front


def _states(front) -> bytes:
    """Every stream's state as the engine gives it (celt_fe_state_get)."""
    n = front.lib.celt_fe_state_bytes()
    buf = ctypes.create_string_buffer(n * front.batch)
    for i, h in enumerate(front.handles):
        front.lib.celt_fe_state_get(h, ctypes.addressof(buf) + i * n)
    return buf.raw


@pytest.fixture(scope="module")
def steps():
    """(packets, stream channels) of 24 steps of 160 streams from the port's
    encoder: tones and noise with clicks at 96 kbit/s, every third stream
    coded mono, a loss run on some streams and single losses on others."""
    B, NF = 160, 24
    rng = np.random.default_rng(20)
    t = np.arange(FRAME * NF) / 48000.0
    f0 = 110.0 * (1.0 + 0.05 * np.arange(B))[:, None]
    sig = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((B, t.size))
    for i in range(B):
        sig[i, 500 + 37 * i :: 2903] += 0.9
    stereo = np.stack([sig, 0.7 * np.roll(sig, 5, axis=1)], -1).astype(np.float32)
    mono = sig[..., None].astype(np.float32)
    enc2, enc1 = fe.NativeCeltEncoderBatch(B, 2), fe.NativeCeltEncoderBatch(B, 1)
    sch = np.where(np.arange(B) % 3 == 0, 1, 2).astype(np.int32)
    out = []
    for f in range(NF):
        frames = slice(f * FRAME, (f + 1) * FRAME)
        p2, p1 = enc2.encode_batch(stereo[:, frames], 240), enc1.encode_batch(mono[:, frames], 120)
        packets = [bytes(p1[i] if sch[i] == 1 else p2[i]) for i in range(B)]
        for i in range(B):
            if (i % 11 == 4 and 5 <= f < 9) or (i * 7 + f) % 29 == 0:
                packets[i] = None
        out.append(packets)
    return out, sch


def _equal_slots(got: dict, want: dict) -> None:
    for key in ("header", "ble", "meta", "gains", "bands", "iy_spans"):
        assert np.array_equal(got[key], want[key]), key
    assert got["used_words"] == want["used_words"]
    used = want["used_words"]
    assert np.array_equal(got["buf"][:used], want["buf"][:used])
    assert (got["xdbg"] is None) == (want["xdbg"] is None)
    if want["xdbg"] is not None:
        assert np.array_equal(got["xdbg"], want["xdbg"])


@pytest.mark.parametrize("B", [64, 160])
@pytest.mark.parametrize("S", [2, 3, 7])
def test_sharded_plan_slot_is_the_one_calls(monkeypatch, steps, S, B):
    """S shards (uneven blocks but for 160 / 2) against one call on the same
    packets, with losses and mono and stereo streams: every slot array,
    the arena prefix, the used words, the iy spans, the engine's own
    spectra on some steps, the final ranges and the states, byte for
    byte, over 24 steps."""
    packets, sch = steps
    one, sharded = _front_end(monkeypatch, B, 1), _front_end(monkeypatch, B, S)
    want_slots, got_slots = one.alloc_plan_slots(2), sharded.alloc_plan_slots(2)
    for t, pk in enumerate(packets):
        xdbg = t % 5 == 0
        want = one.decode_batch_plan_into(pk[:B], FRAME, want_slots[t % 2], sch[:B], xdbg)
        got = sharded.decode_batch_plan_into(pk[:B], FRAME, got_slots[t % 2], sch[:B], xdbg)
        _equal_slots(got, want)
        assert sharded.final_ranges() == one.final_ranges()
    assert _states(sharded) == _states(one)


def test_a_copy_decodes_the_states_another_copy_created(steps):
    """FrontEnd states hold no pointer: states created by one library copy
    and decoded by two others, a block each, end as the primary's own."""
    packets, sch = steps
    B, half = 64, 32
    primary, c1, c2 = fe._load(), fe._load_copy(1), fe._load_copy(2)
    own = (ctypes.c_void_p * B)(*[primary.celt_fe_create(2, 1) for _ in range(B)])
    other = (ctypes.c_void_p * B)(*[c1.celt_fe_create(2, 1) for _ in range(B)])
    try:
        for pk in packets[:8]:
            want, got = fe.alloc_plan_slots(B, 1)[0], fe.alloc_plan_slots(B, 1)[0]
            lens = np.array([0 if p is None else len(p) for p in pk[:B]], np.int32)
            for lib, handles, slot, blocks in ((primary, own, want, [(0, B)]),
                                               (c2, other, got, [(0, half)]),
                                               (primary, other, got, [(half, B)])):
                for a, b in blocks:
                    used = ctypes.c_int64(0)
                    arena = slot["arena"][a * fe.PLAN_ARENA_WORDS:]
                    rc = lib.celt_fe_decode_batch_plan(
                        ctypes.cast(ctypes.addressof(handles) + 8 * a,
                                    ctypes.POINTER(ctypes.c_void_p)),
                        b"".join(p or b"" for p in pk[a:b]), fe._ptr(lens[a:], ctypes.c_int32),
                        b - a, FRAME, fe._ptr(sch[a:], ctypes.c_int32),
                        *[fe._ptr(slot[k][a:], ctypes.c_float if k in ("ble", "gains")
                                  else ctypes.c_int32)
                          for k in ("header", "ble", "meta", "gains", "bands")],
                        fe._ptr(arena, ctypes.c_int32), arena.shape[0], ctypes.byref(used),
                        None, 0)
                    assert rc == b - a
            for k in ("ble", "meta", "gains", "bands"):
                assert np.array_equal(got[k], want[k]), k
        assert ([primary.celt_fe_rng(h) for h in own]
                == [c1.celt_fe_rng(h) for h in other])
    finally:
        for h in own:
            primary.celt_fe_destroy(h)
        for h in other:
            c1.celt_fe_destroy(h)


def _arena_words(front, pk, sch, B) -> np.ndarray:
    """Each stream's arena words on this step, from a probe front end
    that starts from `front`'s states (a one-call decode)."""
    probe = fe.NativeBatchFrontEnd(B, 2)
    probe._states[:] = front._states
    slot = probe.decode_batch_plan_into(pk, FRAME, probe.alloc_plan_slots(1)[0], sch)
    ends = np.append(slot["header"][1:, 0], slot["used_words"] - slot["fixed_words"])
    return ends - slot["header"][:, 0]


@pytest.mark.parametrize("where", ["merge", "one_shard"])
def test_an_overflow_restores_every_stream(monkeypatch, steps, where):
    """A slot one word short of the step's arena: both front ends raise
    OverflowError, every stream's state is as it was, and the next step
    is byte-equal again.  "merge": no shard overflows alone, the merged
    total does; "one_shard": the second shard's streams fill more than
    the others' together and it alone overflows, while the other shards
    advance their streams and must be rolled back."""
    packets, sch = steps
    B, S = 64, 3
    one, sharded = _front_end(monkeypatch, B, 1), _front_end(monkeypatch, B, S)
    for pk in packets[:6]:
        one.decode_batch_plan_into(pk[:B], FRAME, one.alloc_plan_slots(1)[0], sch[:B])
        sharded.decode_batch_plan_into(pk[:B], FRAME, sharded.alloc_plan_slots(1)[0], sch[:B])
    pk = list(packets[6][:B])
    blocks = sharded._blocks
    if where == "one_shard":
        a, b = blocks[1]
        pk = [p if a <= i < b else (p[:2] if p and i % 2 else None) for i, p in enumerate(pk)]
    words = _arena_words(one, pk, sch[:B], B)
    shard_words = [int(words[a:b].sum()) for a, b in blocks]
    cap = int(words.sum()) - 1 if where == "merge" else shard_words[1] - 1
    assert max(shard_words) <= cap if where == "merge" else (
        sorted(shard_words)[-2] <= cap < shard_words[1])
    before = _states(one)
    assert _states(sharded) == before
    for front in (one, sharded):
        slot = front.alloc_plan_slots(1)[0]
        slot["arena"] = slot["arena"][:cap]
        with pytest.raises(OverflowError):
            front.decode_batch_plan_into(pk, FRAME, slot, sch[:B])
        assert _states(front) == before
    want = one.decode_batch_plan_into(pk, FRAME, one.alloc_plan_slots(1)[0], sch[:B])
    got = sharded.decode_batch_plan_into(pk, FRAME, sharded.alloc_plan_slots(1)[0], sch[:B])
    _equal_slots(got, want)
    assert sharded.final_ranges() == one.final_ranges()


def test_shard_count_follows_batch_cores_and_openmp(monkeypatch):
    """S = min(usable cores - 1, B // 32), at least 1; 1 below 64 streams,
    with one usable core, and wherever the library runs its own loop under
    OpenMP."""
    monkeypatch.setattr(fe, "openmp_built", lambda: False)
    for cores in (1, 2, 3, 8, 64):
        monkeypatch.setattr(fe, "_usable_cores", lambda: cores)
        for B in (1, 16, 31, 32, 63, 64, 95, 160, 1024, 8192):
            S = fe.plan_shards(B)
            assert S == max(1, min(cores - 1, B // fe.SHARD_STREAMS))
            assert 1 <= S <= max(1, cores - 1)
            if B < 2 * fe.SHARD_STREAMS or cores == 1:
                assert S == 1
    monkeypatch.setattr(fe, "openmp_built", lambda: True)
    assert fe.plan_shards(1024) == 1
    monkeypatch.undo()
    assert 1 <= fe.plan_shards(1024) <= max(1, len(os.sched_getaffinity(0)) - 1)


def _shard_threads() -> int:
    return sum(t.name.startswith("plane-a-shard-") for t in threading.enumerate())


def test_counter_counts_shards_and_threads_start_once(monkeypatch, steps):
    """plane_a_shards grows by S a call, and the S - 1 threads start with
    the first front end that needs them, not again for a call or for
    another front end."""
    packets, sch = steps
    B, S = 160, 160 // fe.SHARD_STREAMS
    monkeypatch.setattr(fe, "openmp_built", lambda: False)
    monkeypatch.setattr(fe, "_usable_cores", lambda: 8)
    start = _shard_threads()
    front = fe.NativeBatchFrontEnd(B, 2)
    assert front.shards == S
    threads = _shard_threads()
    assert threads == max(start, S - 1)
    slot = front.alloc_plan_slots(1)[0]
    for n, pk in enumerate(packets[:3], 1):
        before = trace.counters()["plane_a_shards"]
        front.decode_batch_plan_into(pk, FRAME, slot, sch)
        assert trace.counters()["plane_a_shards"] == before + S
        assert _shard_threads() == threads
    small = fe.NativeBatchFrontEnd(63, 2)
    assert small.shards == 1
    before = trace.counters()["plane_a_shards"]
    small.decode_batch_plan_into(packets[0][:63], FRAME, small.alloc_plan_slots(1)[0], sch[:63])
    assert trace.counters()["plane_a_shards"] == before + 1
    fe.NativeBatchFrontEnd(B, 2).decode_batch_plan_into(packets[0], FRAME, slot, sch)
    assert _shard_threads() == threads


def test_shards_under_a_short_switch_interval(monkeypatch, steps):
    """The hand-off to the shard threads and back, with the interpreter
    switching threads every microsecond: two sharded front ends driven
    in turn stay byte-equal to one call over 24 steps."""
    packets, sch = steps
    B = 160
    one = _front_end(monkeypatch, B, 1)
    fronts = [_front_end(monkeypatch, B, 7), _front_end(monkeypatch, B, 5)]
    want_slot = one.alloc_plan_slots(1)[0]
    got_slots = [f.alloc_plan_slots(1)[0] for f in fronts]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for pk in packets:
            want = one.decode_batch_plan_into(pk, FRAME, want_slot, sch)
            for front, slot in zip(fronts, got_slots):
                _equal_slots(front.decode_batch_plan_into(pk, FRAME, slot, sch), want)
    finally:
        sys.setswitchinterval(interval)
    assert fronts[0].final_ranges() == fronts[1].final_ranges() == one.final_ranges()
