"""The control comes out not correct: the program's own lower-precision
path in place of its decoder (the configuration's `controls`: `p8` ships
the spectra with 8-bit mantissas where the plan transfer ships float16
gains).  On the host at a tiny size; on the card at each cell's size."""

import json
import subprocess
import sys

import pytest

from .helpers import REPO, run_tiny, tiny_copy


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", ["tiny_music.offline", "tiny_voice.live"])
def test_control_is_not_correct_on_the_host(copy, cell):
    rc, result, err = run_tiny(copy, cell, seed=31, seconds=3.0, control="p8")
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["pcm_max_abs"]["value"] > result["checks"]["pcm_max_abs"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["celt_music.offline", "webrtc_voice.live", "celt_music.live"])
def test_control_is_not_correct_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "-m", "opusbench.run", "--workload", cell, "--seed",
                        "424242", "--seconds", "2", "--trace", "0", "--control", "p8"],
                       cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]
