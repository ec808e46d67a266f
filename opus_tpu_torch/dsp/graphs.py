"""One executable per serving step on the card: each step variant is
captured once as a CUDA graph and replayed (the port's counterpart of the
reference's `jax.jit(step, donate_argnums=...)`, opus_tpu/dsp/synthesis.py
`_maybe_checkify`; its checkify sanitizer is not ported).

A serving step of dsp/synthesis.py issues 150-2,400 launches from Python;
replayed from a graph it is one launch.  `CapturedStep` wraps the step of
one variant key of a decoder:

* the first call runs the step eagerly on a side stream (this step's real
  work, and the warm-up: cuBLAS, the kernel library's build and its
  cudaFuncSetAttribute calls, the constant tables), then captures it with
  `torch.cuda.graph`, inside which the capture stream is the current
  stream that `_build.launch` passes to the hand-written kernels;
* every later call replays the graph.  The step updates state, ring and
  the conceal's LPC and pitch in place, so they are the graph's static
  tensors, as donation makes them in the reference; the digest goes to
  the decoder's static `digest` tensor.  A call whose tensors are not
  the captured ones (another address, shape or stride) raises: the graph
  would read and write the old ones.

All graphs of one decoder share one memory pool (`SharedPool`): they are
replayed one at a time on one stream, and nothing they allocate outlives
a replay.  A capture or replay that fails raises; there is no eager path
on the card.  The kernel wrappers count their launches in Python, which a
replay does not run: the counts a capture adds are taken back and added
again on every replay, so a counter counts the launches the card ran.

While the tracer is on (opus_tpu_torch/trace.py) when a variant is
captured, the capture also records the step's device phase marks as
timing events; a replay's phase times are read once its last event has
completed, checked before the variant's next replay or at serve()'s final
wait (`read_phases`), never by a sync.
"""

from __future__ import annotations

import time

import torch

from .. import trace
from .band_walk import band_walk
from .plc_scan import lpc_synth, pitch_track
from .postfilter import postfilter
from .rotation import rot_pass
from .synthesis import SynthState

#: The kernel wrappers a serving step launches, each with a `launches` count.
COUNTED = (postfilter, rot_pass, pitch_track, lpc_synth, band_walk)


class SharedPool:
    """What the captured steps of one decoder share: a graph memory pool
    and the static digest [2] every step writes."""

    def __init__(self, device):
        self.handle = torch.cuda.graph_pool_handle()
        self.digest = torch.zeros(2, device=device)


def _layout(args: tuple, kw: dict) -> tuple:
    """What a captured step is bound to: each tensor argument's address,
    shape, stride and dtype (a SynthState's fields one by one), and every
    other argument's value."""
    def one(a):
        if isinstance(a, SynthState):
            return tuple(one(t) for t in (a.mem, a.preemph, a.silk_hist))
        if torch.is_tensor(a):
            return (a.data_ptr(), tuple(a.shape), a.stride(), a.dtype)
        return a

    return tuple(one(a) for a in args) + tuple((k, one(v)) for k, v in sorted(kw.items()))


class CapturedStep:
    """A serving step served from its CUDA graph: call it as the step,
    step(state, ring, buf, *plc, **kw) -> (state, ring, digest).  `step`
    is the uncaptured step; `capture_ms` the host ms of the first call
    (eager run and capture); `launches` each wrapper's launches a replay;
    `phases` the (name, event) marks captured with the graph (empty when
    the tracer was off at the capture), `pending` the step id of the last
    replay whose phases are not read yet."""

    def __init__(self, step, pool: SharedPool):
        self.step = step
        self.pool = pool
        self.graph = None
        self.layout = None
        self.launches = {}
        self.capture_ms = None
        self.phases = []
        self.pending = None

    def __call__(self, state, ring, buf, *plc, **kw):
        layout = _layout((state, ring, buf, *plc), kw)
        if self.graph is None:
            self._capture(layout, (state, ring, buf, *plc), kw)
        elif layout != self.layout:
            raise ValueError("a captured serving step was called with other tensors than "
                             "the ones it was captured with")
        else:
            if self.pending is not None:
                self.read_phases()
            self.graph.replay()
            for fn, n in self.launches.items():
                fn.launches += n
            if self.phases and trace.on:
                self.pending = trace.current_step()
        return state, ring, self.pool.digest

    def _run(self, args, kw) -> None:
        self.pool.digest.copy_(self.step(*args, **kw)[2])

    def _capture(self, layout, args, kw) -> None:
        t0 = time.perf_counter()
        dev = args[2].device
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._run(args, kw)
        current.wait_stream(side)
        before = {fn: fn.launches for fn in COUNTED}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool.handle, capture_error_mode="thread_local"):
                with trace.phases() as marks:
                    self._run(args, kw)
            self.launches = {fn: fn.launches - n for fn, n in before.items()
                             if fn.launches != n}
        finally:
            for fn, n in before.items():
                fn.launches = n
        self.graph, self.layout, self.phases = graph, layout, marks
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def read_phases(self) -> None:
        """The pending replay's phase times into the tracer if its last
        event has completed, else counted in `device_phases_missed` (the
        next replay records over them)."""
        step, self.pending = self.pending, None
        if self.phases[-1][1].query():
            trace.device_phases(step, self.phases)
        else:
            trace.count("device_phases_missed")


def eager(step):
    """The uncaptured step behind `step` (step itself if it is one)."""
    return step.step if isinstance(step, CapturedStep) else step
