"""The trace arithmetic on a made-up trace: busy time is the union of the
device events inside the segment, idle time goes to the innermost host
range open at each moment."""

import types

import pytest
import torch

from opusbench import profile

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def event(name, device, start, end):
    return types.SimpleNamespace(name=lambda: name, device_type=lambda: device,
                                 start_ns=lambda: start, duration_ns=lambda: end - start,
                                 is_user_annotation=lambda: False)


def fake_profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_innermost_pieces():
    host = sorted([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (12, 20, "d")])
    assert profile._innermost(host, 0, 25) == [
        (0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"), (5, 10, "a"),
        (10, 12, "other"), (12, 20, "d"), (20, 25, "other")]


def test_summarize_busy_union_and_idle_by_host():
    ns = 10**9
    events = [
        event("opusbench.segment", CPU, 0, 10 * ns),
        event("opusbench.serve", CPU, 1 * ns, 6 * ns),
        event("opusbench.decode_batch_plan_into", CPU, 1 * ns, 3 * ns),
        event("opusbench.tick_wait", CPU, 6 * ns, 10 * ns),
        event("rot_pass_kernel", CUDA, 3 * ns, 5 * ns),
        event("gemm", CUDA, 4 * ns, 6 * ns),  # overlaps the rotation: counted once
        event("opusbench.serve", CUDA, 1 * ns, 6 * ns),  # a range's device twin: left out
        event("late", CUDA, 11 * ns, 12 * ns),  # outside the segment
    ]
    s = profile.summarize(fake_profile(events), steps=2)
    assert s["busy_s"] == pytest.approx(3.0) and s["window_s"] == pytest.approx(10.0)
    assert s["idle_by_host"] == pytest.approx({"other": 1.0, "decode_batch_plan_into": 2.0,
                                               "tick_wait": 4.0})
    assert set(s["launches"]) == {"rot_pass_kernel", "gemm"}
    b = profile.breakdown(s)
    assert b["idle_gaps"][0] == ["tick_wait", pytest.approx(4.0)]
    assert [n for n, _ in b["device_ops"]] == ["rot_pass_kernel", "gemm"]
