"""The check catches a broken timed path: a run on the host at a tiny
size, with a fault planted under the harness once the window begins,
must come out not correct.  The faults a serving cell can have: a step
that returns its state unchanged; half of the batch left out; an answer
altered where it is produced (a PCM sample, a final range).  One card,
so no exchange between chips to leave out."""

import pytest

from .helpers import run_tiny, tiny_copy

# Each fault patches the program's serve() for the tiny cells' decoders,
# from the window's first step on (the harness is capturing then).
SETUP = """
import opusbench.run as R
_serve = R.Context.serve
"""
FAULTS = {
    # the step is skipped: state and PCM as they were (taking a step's
    # time, so that the window serves as many steps as a sound run)
    "state_unchanged": SETUP + """
import time
def serve(self, steps):
    if not self.capturing:
        return _serve(self, steps)
    time.sleep(0.02 * len(steps))
    self.t += len(steps)
R.Context.serve = serve
""",
    # only the first half of the streams decoded; the rest keep their PCM
    "half_batch": SETUP + """
def serve(self, steps):
    if not self.capturing:
        return _serve(self, steps)
    ring = self.adapter.ring(self.dec)
    keep = ring[self.streams // 2:].clone()
    _serve(self, steps)
    self.adapter.ring(self.dec)[self.streams // 2:] = keep
R.Context.serve = serve
""",
    # one PCM sample of every stream altered at the window's first call
    "pcm_altered": SETUP + """
calls = [0]
def serve(self, steps):
    _serve(self, steps)
    if self.capturing:
        calls[0] += 1
        if calls[0] == 1:
            self.adapter.ring(self.dec)[:, 100, 0] += 0.01
R.Context.serve = serve
""",
    # one stream's final range altered where plane A reports it
    "range_altered": """
import opusbench.check as C
_take = C.Captures.take_ranges
def take_ranges(self, dec, step):
    _take(self, dec, step)
    self.ranges[-1] = self.ranges[-1].copy()
    self.ranges[-1][1] ^= 1
C.Captures.take_ranges = take_ranges
""",
}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["tiny_music.offline", "tiny_voice.live"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(copy, cell, fault):
    rc, result, err = run_tiny(copy, cell, seed=2**33 + 9, extra=FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]
    failed = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    want = {"range_altered": ["range_mismatches"]}.get(fault)
    assert failed and (want is None or failed == want)


def test_sound_run_is_correct(copy):
    rc, result, err = run_tiny(copy, "tiny_voice.live", seed=2**33 + 9)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
